// K3: fused SGM path aggregation + winner-take-all.
//
// Replaces wass_tpu/stereo/sgm_pallas.py:sgm_wta_fused_pallas (_run_pair /
// _pair_kernel, _run_tri_dir_partial / _tri_dir_partial_kernel,
// _run_tri_dir_wta / _tri_dir_wta_kernel + _wta_row).  The recurrence
// along a path r is
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, min_k L(p-r, k) + P2)
//             - min_k L(p-r, k)
// and the first pixel of a path has L = C.  The Pallas kernels walk every
// line of a direction at once (a roll of the carry plus a boundary reset);
// here each line is its own warp, so no roll exists.
//
// Layout (Hernandez-Juarez et al., arXiv 1610.04121): one warp per path
// line, the D disparities across the 32 lanes, V = ceil(D / 32) (rounded
// up to a multiple of 4 above 2) consecutive disparities in each lane's
// registers.  The d-1 / d+1 neighbours cross lanes with one shuffle each;
// min over D is a 5-step shuffle reduction.
//
// Directions run one launch each, so no two warps touch one pixel at once.
// The first launch writes its L into an int16 (H, W, D) volume, the next
// ones add theirs, and the last direction adds its L in registers and runs
// the WTA of sgm.wta_disparity (first-index argmin, +-1 neighbours,
// uniqueness with an integer-floor threshold, clipped parabola subpixel;
// 0 = invalid), writing the (H, W) float32 disparity.  Every path sum is a
// small integer, so the direction order does not change any result.
//
// Bound on the H100: device-memory traffic.  Each of the first directions
// reads the uint8 cost and reads and writes the int16 volume (about 10 GB
// per direction at 2048x1536, D = 640); the walk itself is a serial chain
// of dependent steps per warp, so only a few thousand warps are in flight.
// Loads are 4-byte (cost) and 8-byte (int16 volume) when D % 4 == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 32000;        // no-predecessor / padding value of L
constexpr int kBigTotal = 1 << 19; // padding value of the WTA total
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

enum { kWrite = 0, kAccumulate = 1, kWta = 2 };

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int num_lines(int H, int W, int dy, int dx) {
  if (dy == 0) return H;
  if (dx == 0) return W;
  return W + H - 1;
}

// First pixel of line `line` of direction (dy, dx): lines enter through the
// row the walk starts from and, for diagonals, through the entry column.
__device__ __forceinline__ void line_start(int line, int H, int W, int dy, int dx, int* y, int* x) {
  const int ys = dy > 0 ? 0 : H - 1;
  const int xs = dx > 0 ? 0 : W - 1;
  if (dy == 0) {
    *y = line;
    *x = xs;
  } else if (dx == 0 || line < W) {
    *y = ys;
    *x = line;
  } else {
    *y = ys + dy * (line - W + 1);
    *x = xs;
  }
}

template <int V>
__device__ __forceinline__ void load_cost(const uint8_t* c, int d0, int D, bool vec, int (&C)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        uint32_t w = d0 + 4 * k < D ? *reinterpret_cast<const uint32_t*>(c + d0 + 4 * k) : 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) C[4 * k + q] = (w >> (8 * q)) & 0xff;
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) C[v] = d0 + v < D ? c[d0 + v] : 0;
}

template <int V>
__device__ __forceinline__ void load_acc(const int16_t* a, int d0, int D, bool vec, int (&A)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if (d0 + 4 * k < D) {
          const uint2 w = *reinterpret_cast<const uint2*>(a + d0 + 4 * k);
          A[4 * k + 0] = (int16_t)(w.x & 0xffff);
          A[4 * k + 1] = (int16_t)(w.x >> 16);
          A[4 * k + 2] = (int16_t)(w.y & 0xffff);
          A[4 * k + 3] = (int16_t)(w.y >> 16);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) A[4 * k + q] = 0;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) A[v] = d0 + v < D ? a[d0 + v] : 0;
}

template <int V>
__device__ __forceinline__ void store_acc(int16_t* a, int d0, int D, bool vec, const int (&A)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if (d0 + 4 * k < D) {
          uint2 w;
          w.x = (uint32_t)(uint16_t)A[4 * k + 0] | ((uint32_t)(uint16_t)A[4 * k + 1] << 16);
          w.y = (uint32_t)(uint16_t)A[4 * k + 2] | ((uint32_t)(uint16_t)A[4 * k + 3] << 16);
          *reinterpret_cast<uint2*>(a + d0 + 4 * k) = w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (d0 + v < D) a[d0 + v] = (int16_t)A[v];
}

template <int V, int MODE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sgm_path_kernel(const uint8_t* __restrict__ cost, int16_t* __restrict__ acc,
                float* __restrict__ disp, int H, int W, int D, int dy, int dx, int P1,
                int P2, int min_disp, int uniq) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (line >= num_lines(H, W, dy, dx)) return;  // the whole warp leaves together
  int y, x;
  line_start(line, H, W, dy, dx, &y, &x);
  const int d0 = lane * V;
  const bool vec = (D % 4) == 0;

  int L[V];
  int minL = 0;
  bool first = true;
  while (y >= 0 && y < H && x >= 0 && x < W) {
    const size_t p = (size_t)y * W + x;
    int C[V];
    load_cost<V>(cost + p * D, d0, D, vec, C);
    if (first) {
#pragma unroll
      for (int v = 0; v < V; ++v) L[v] = d0 + v < D ? C[v] : kBig;
      first = false;
    } else {
      int up_edge = __shfl_up_sync(kFull, L[V - 1], 1);
      int dn_edge = __shfl_down_sync(kFull, L[0], 1);
      if (lane == 0) up_edge = kBig;
      if (lane == 31) dn_edge = kBig;
      int Ln[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int up = v == 0 ? up_edge : L[v - 1];
        const int dn = v == V - 1 ? dn_edge : L[v + 1];
        const int best = min(min(L[v], minL + P2), min(up, dn) + P1);
        Ln[v] = d0 + v < D ? C[v] + best - minL : kBig;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) L[v] = Ln[v];
    }
    int m = kBig;
#pragma unroll
    for (int v = 0; v < V; ++v) m = min(m, L[v]);
    minL = warp_min(m);

    int16_t* a = acc + p * D;
    if constexpr (MODE == kWrite) {
      store_acc<V>(a, d0, D, vec, L);
    } else if constexpr (MODE == kAccumulate) {
      int A[V];
      load_acc<V>(a, d0, D, vec, A);
#pragma unroll
      for (int v = 0; v < V; ++v) A[v] += L[v];
      store_acc<V>(a, d0, D, vec, A);
    } else {
      int T[V];
      load_acc<V>(a, d0, D, vec, T);
      int key = 0x7fffffff;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T[v] = d0 + v < D ? T[v] + L[v] : kBigTotal;
        key = min(key, (T[v] << 11) | (d0 + v));  // first-index argmin
      }
      key = warp_min(key);
      const int dmin = key >> 11;
      const int best = key & 2047;
      int sm1 = kBigTotal, sp1 = kBigTotal, far = kBigTotal;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int d = d0 + v;
        if (d == best - 1) sm1 = T[v];
        if (d == best + 1) sp1 = T[v];
        if (d - best > 1 || best - d > 1) far = min(far, T[v]);
      }
      sm1 = warp_min(sm1);
      sp1 = warp_min(sp1);
      far = warp_min(far);
      if (lane == 0) {
        const int thresh = dmin * (100 + uniq) / 100;
        const bool interior = best > 0 && best < D - 1;
        const int sm1s = interior ? sm1 : dmin;
        const int sp1s = interior ? sp1 : dmin;
        const int denom = max(sm1s + sp1s - 2 * dmin, 1);
        float delta = (float)(sm1s - sp1s) / (2.0f * (float)denom);  // IEEE division
        delta = fminf(fmaxf(delta, -0.5f), 0.5f);
        const float dv = (float)(best + min_disp) + (interior ? delta : 0.0f);
        disp[p] = far > thresh ? dv : 0.0f;
      }
    }
    y += dy;
    x += dx;
  }
}

template <int V>
cudaError_t launch_path(int mode, const uint8_t* cost, int16_t* acc, float* disp, int H, int W,
                        int D, int dy, int dx, int P1, int P2, int min_disp, int uniq,
                        cudaStream_t s) {
  const int lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const dim3 grid((lines + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  if (mode == kWrite)
    sgm_path_kernel<V, kWrite><<<grid, block, 0, s>>>(cost, acc, disp, H, W, D, dy, dx, P1, P2, min_disp, uniq);
  else if (mode == kAccumulate)
    sgm_path_kernel<V, kAccumulate><<<grid, block, 0, s>>>(cost, acc, disp, H, W, D, dy, dx, P1, P2, min_disp, uniq);
  else
    sgm_path_kernel<V, kWta><<<grid, block, 0, s>>>(cost, acc, disp, H, W, D, dy, dx, P1, P2, min_disp, uniq);
  return cudaGetLastError();
}

cudaError_t launch_path_v(int V, int mode, const uint8_t* cost, int16_t* acc, float* disp, int H,
                          int W, int D, int dy, int dx, int P1, int P2, int min_disp, int uniq,
                          cudaStream_t s) {
#define WASS_SGM_CASE(v) \
  case v:                \
    return launch_path<v>(mode, cost, acc, disp, H, W, D, dy, dx, P1, P2, min_disp, uniq, s);
  switch (V) {
    WASS_SGM_CASE(1)
    WASS_SGM_CASE(2)
    WASS_SGM_CASE(4)
    WASS_SGM_CASE(8)
    WASS_SGM_CASE(12)
    WASS_SGM_CASE(16)
    WASS_SGM_CASE(20)
    WASS_SGM_CASE(24)
    WASS_SGM_CASE(28)
    WASS_SGM_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef WASS_SGM_CASE
}

}  // namespace

// Disparities per lane for a disparity count D (the template instances
// above); 0 when D is out of range.
extern "C" int wass_sgm_lane_width(int D) {
  if (D < 1 || D > 1024) return 0;
  const int v = (D + 31) / 32;
  return v <= 2 ? v : (v + 3) / 4 * 4;
}

// cost (H, W, D) uint8 -> disp (H, W) float32; acc is (H, W, D) int16
// scratch.  directions: 8 (all) or 5 (E, W, N, NW, NE: the forward walks).
extern "C" int wass_sgm_wta_fused(const void* cost, void* acc, void* disp, int H, int W, int D,
                                  int P1, int P2, int directions, int min_disp, int uniq,
                                  void* stream) {
  static const int dirs8[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
  static const int dirs5[5][2] = {{0, 1}, {0, -1}, {1, 0}, {1, 1}, {1, -1}};
  const int(*dirs)[2] = directions == 8 ? dirs8 : dirs5;
  if (directions != 8 && directions != 5) return (int)cudaErrorInvalidValue;
  const int V = wass_sgm_lane_width(D);
  if (V == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < directions; ++k) {
    const int mode = k == 0 ? kWrite : (k == directions - 1 ? kWta : kAccumulate);
    const cudaError_t err = launch_path_v(V, mode, (const uint8_t*)cost, (int16_t*)acc, (float*)disp,
                                          H, W, D, dirs[k][0], dirs[k][1], P1, P2, min_disp, uniq, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
