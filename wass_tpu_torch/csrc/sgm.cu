// K3, K4, K5, K6: SGM path aggregation, fused with the winner-take-all
// (K3, K4) or writing the int16 path sum (K5, K6), over a full-range
// (K3, K5) or a windowed (K4, K6) cost volume; and the H2 pieces, the
// horizontal pair in image layout and the row walks that fold it in.
//
// Replaces wass_tpu/stereo/sgm_pallas.py:
//   K3 sgm_wta_fused_pallas           (_run_pair, _run_tri_dir_partial, _run_tri_dir_wta)
//   K4 sgm_wta_fused_pallas_windowed  (_run_pair, _run_tri_dir_{partial,wta}_windowed)
//   K5 sgm_aggregate_pallas           (_run_pair, _run_tri_dir)
//   K6 sgm_aggregate_pallas_windowed  (_run_pair, _run_tri_dir_windowed)
//   H2 _run_pair_img (wass_sgm_pair_img); _run_tri_dir_{partial,wta}_h2 and
//      _run_tri_dir_{partial,wta}_windowed_h2, with the single non-H2 walks
//      the H2 compositions take (wass_sgm_walk)
// The recurrence along a path r is
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
// Directions run one launch each (the H2 pair's two in one launch, each
// writing its own volume), so no two warps write one element at once.
// The first launch writes its L into an int16 (H, W, D) volume, the next
// ones add theirs; for K3/K4 the last direction adds its L in registers and
// runs the WTA of sgm.wta_disparity (first-index argmin, +-1 neighbours,
// uniqueness with an integer-floor threshold, clipped parabola subpixel;
// 0 = invalid), writing the (H, W) float32 disparity.  Every path sum is a
// small integer, so the direction order does not change any result.
//
// Windowed volumes (K4, K6): lane j of row y is disparity
// wstart[y / 8] + j.  A vertical or diagonal walk that steps into a row
// tile with another window start first realigns its carry (new lane j
// takes old lane j + delta, 255 where that is outside the window; the
// source lane is data-dependent, so the carry goes through a per-warp
// shared-memory buffer) and recomputes min_k L from it.  A diagonal's
// first pixel needs no realignment: it starts from L = C.  K4's WTA uses
// the min_disp = 1 sentinel and writes (d - 1) + wstart[y / 8], the float
// order of wass_tpu/stereo/dense.py:_jit_sgm_fused_windowed.
//
// H2 (the JAX package's _USE_H2 compositions, off by default there and
// here).  The pair mode walks E and W in one launch of 2 H warps (row y
// forward on line y, backward on line H + y) and stores each L as uint8
// in its own volume, hf or hb (L < 64 + P2 < 256).  The fold mode is the
// first direction of a row walk: it writes hf + hb + L to the int16
// volume; the walk's next directions accumulate and its last may end in
// the WTA.  Windowed walks realign their carries only: hf and hb are
// window-local per row already.  Bytes per cost element for 8 paths: the
// pair reads 2 and writes 2, the folding walk moves 5 a direction, the
// final walk's first two directions 5 each and its WTA 3: 32 in all,
// against 36 for K3 (a write of 3, six read-modify-writes of 5, the WTA's 3).
//
// Bound on the H100: device-memory traffic.  Each of the first directions
// reads the uint8 cost and reads and writes the int16 volume (about 10 GB
// per direction at 2048x1536, D = 640); the walk itself is a serial chain
// of dependent steps per warp, so only a few thousand warps are in flight.
// Loads are 4-byte (cost) and 8-byte (int16 volume) when D % 4 == 0.  The
// loads of a step do not depend on the carry, so each warp issues them P
// steps ahead into a register ring (prefetch_depth below): the bytes in
// flight, not the chain of steps, set the rate.  Measured by chip_smoke.py
// on an H100 80GB HBM3 at 700 W, from the byte counts above: K3 and K5 at
// full range 2.4-2.5 TB/s and the H2 pieces 2.1-2.6; K4 and K6 over
// windows of 128 1.8 and 2.1 TB/s (before the ring, the step latency held
// them to about 0.95).  The coarse pass (384x512, D = 160) walks only
// 384-895 lines a launch and reaches 0.7 TB/s: there too few warps are in
// flight to cover the latency.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int wass_sgm_lane_width(int D);

namespace {

constexpr int kBig = 32000;        // no-predecessor / padding value of L
constexpr int kBigTotal = 1 << 19; // padding value of the WTA total
constexpr int kRealignFill = 255;  // carry of a lane with no source after realignment
constexpr int kTileRows = 8;       // rows per window tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

enum { kWrite = 0, kAccumulate = 1, kWta = 2, kWriteFold = 3, kPair = 4 };

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

// A lane's V disparities of one pixel, packed as loaded: 4 uint8 costs to
// a uint32 word, 4 int16 sums to a uint2.  0 past D.
template <int V>
__host__ __device__ constexpr int lane_words() {
  return (V + 3) / 4;
}

template <int V>
__device__ __forceinline__ void load_u8(const uint8_t* c, int d0, int D, bool vec, uint32_t (&w)[lane_words<V>()]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) w[k] = d0 + 4 * k < D ? *reinterpret_cast<const uint32_t*>(c + d0 + 4 * k) : 0u;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < lane_words<V>(); ++k) w[k] = 0u;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (d0 + v < D) w[v / 4] |= (uint32_t)c[d0 + v] << (8 * (v % 4));
}

template <int V>
__device__ __forceinline__ int u8_at(const uint32_t (&w)[lane_words<V>()], int v) {
  return (w[v / 4] >> (8 * (v % 4))) & 0xff;
}

template <int V>
__device__ __forceinline__ void store_u8(uint8_t* c, int d0, int D, bool vec, const int (&L)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if (d0 + 4 * k < D) {
          uint32_t w = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) w |= (uint32_t)(L[4 * k + q] & 0xff) << (8 * q);
          *reinterpret_cast<uint32_t*>(c + d0 + 4 * k) = w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (d0 + v < D) c[d0 + v] = (uint8_t)L[v];
}

template <int V>
__device__ __forceinline__ void load_i16(const int16_t* a, int d0, int D, bool vec, uint2 (&w)[lane_words<V>()]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        w[k] = d0 + 4 * k < D ? *reinterpret_cast<const uint2*>(a + d0 + 4 * k) : make_uint2(0u, 0u);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < lane_words<V>(); ++k) w[k] = make_uint2(0u, 0u);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (d0 + v < D) {
      const uint32_t h = (uint32_t)(uint16_t)a[d0 + v] << (16 * (v % 2));
      if (v % 4 < 2)
        w[v / 4].x |= h;
      else
        w[v / 4].y |= h;
    }
  }
}

template <int V>
__device__ __forceinline__ int i16_at(const uint2 (&w)[lane_words<V>()], int v) {
  const uint32_t h = v % 4 < 2 ? w[v / 4].x : w[v / 4].y;
  return (int16_t)((h >> (16 * (v % 2))) & 0xffff);
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

// The carry of a walk entering a row tile whose window starts delta
// disparities later: lane d takes lane d + delta, kRealignFill where that
// is outside [0, D).  buf is the warp's own 32 * V ints of shared memory.
template <int V>
__device__ __forceinline__ void realign(int (&L)[V], int* buf, int d0, int D, int delta) {
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (d0 + v < D) buf[d0 + v] = L[v];
  __syncwarp();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = d0 + v;
    const int src = d + delta;
    L[v] = d >= D ? kBig : (src >= 0 && src < D ? buf[src] : kRealignFill);
  }
  __syncwarp();
}

// Steps of a walk whose loads a warp keeps in flight ahead of the carry
// (a compile-time function of the lane width V and the mode).  A step of
// a windowed walk (Dw = 128, V = 4) moves 384 bytes a warp; by Little's
// law about 3 MB must be in flight to stream at ~3 TB/s against ~1 us of
// load latency, so the 1536 warps of a horizontal launch need about 6-8
// steps each.  At D = 640 (V = 20) a step moves 1920 bytes and the walks
// already stream near their rate: two steps keep that and the registers
// small, and the pair (3072 warps, cost loads only) takes one, since more
// registers would leave some of its warps to a second wave.
template <int V, int MODE>
__host__ __device__ constexpr int prefetch_depth() {
  return V <= 4 ? 8 : (V <= 8 ? 6 : (MODE == kPair ? 1 : 2));
}

// The loads of one step of a walk that do not depend on the carry.
template <int V>
struct Step {
  uint32_t cost[lane_words<V>()];
  uint2 acc[lane_words<V>()];                          // kAccumulate, kWta: the int16 sum so far
  uint32_t hf[lane_words<V>()], hb[lane_words<V>()];   // kWriteFold: the H2 pair
  int delta;  // realigning walks: window start change entering this pixel's row tile
  int wcur;   // windowed kWta: window start of this pixel's row tile
};

// Steps along a walk from (y, x) until it leaves the image.
__device__ __forceinline__ int line_length(int y, int x, int H, int W, int dy, int dx) {
  const int ny = dy > 0 ? H - y : (dy < 0 ? y + 1 : H + W);
  const int nx = dx > 0 ? W - x : (dx < 0 ? x + 1 : H + W);
  return min(ny, nx);
}

// Issue the loads of step k of a walk into s (nothing past its end).
template <int V, int MODE>
__device__ __forceinline__ void fetch_step(Step<V>& s, int k, int n, int y0, int x0, int dy, int dx,
                                           const uint8_t* cost, const int16_t* acc, const uint8_t* hf,
                                           const uint8_t* hb, const int* wstart, bool realigns, int W, int D,
                                           int d0, bool vec) {
  if (k >= n) return;
  const int y = y0 + k * dy, x = x0 + k * dx;
  const size_t p = (size_t)y * W + x;
  load_u8<V>(cost + p * D, d0, D, vec, s.cost);
  if constexpr (MODE == kAccumulate || MODE == kWta) load_i16<V>(acc + p * D, d0, D, vec, s.acc);
  if constexpr (MODE == kWriteFold) {
    load_u8<V>(hf + p * D, d0, D, vec, s.hf);
    load_u8<V>(hb + p * D, d0, D, vec, s.hb);
  }
  if (realigns && k > 0) {
    const int t = y / kTileRows;
    const int tp = (y - dy) / kTileRows;  // tile of the previous pixel's row
    s.delta = t == tp ? 0 : wstart[t] - wstart[tp];
  }
  if constexpr (MODE == kWta) s.wcur = wstart != nullptr ? wstart[y / kTileRows] : 0;
}

// wstart: per-tile window starts of a windowed volume, or null for a
// full-range one.  hf, hb: the H2 horizontal volumes, written by kPair
// (launched with dy = 0, dx = 1) and read by kWriteFold; null otherwise.
// Each warp keeps the loads of the next P steps in a register ring (slot
// j holds steps j, j + P, ...), refilled right after its step is done.
template <int V, int MODE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sgm_path_kernel(const uint8_t* __restrict__ cost, const int* __restrict__ wstart,
                uint8_t* __restrict__ hf, uint8_t* __restrict__ hb,
                int16_t* __restrict__ acc, float* __restrict__ disp, int H, int W, int D,
                int dy, int dx, int P1, int P2, int min_disp, int uniq) {
  __shared__ int realign_buf[kWarpsPerBlock][32 * V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int line = blockIdx.x * kWarpsPerBlock + warp;
  if constexpr (MODE == kPair) {  // lines [0, H) walk forward, [H, 2 H) backward
    if (line >= 2 * H) return;
    if (line >= H) {
      line -= H;
      dx = -dx;
    }
  } else if (line >= num_lines(H, W, dy, dx)) {
    return;  // the whole warp leaves together
  }
  int y0, x0;
  line_start(line, H, W, dy, dx, &y0, &x0);
  const int n = line_length(y0, x0, H, W, dy, dx);
  const int d0 = lane * V;
  const bool vec = (D % 4) == 0;
  const bool realigns = wstart != nullptr && dy != 0;  // horizontal walks keep one window

  constexpr int P = prefetch_depth<V, MODE>();
  Step<V> ring[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    fetch_step<V, MODE>(ring[j], j, n, y0, x0, dy, dx, cost, acc, hf, hb, wstart, realigns, W, D, d0, vec);

  int L[V];
  int minL = 0;
  for (int k0 = 0; k0 < n; k0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j;
      if (k >= n) break;  // uniform across the warp
      const Step<V>& s = ring[j];
      const size_t p = (size_t)(y0 + k * dy) * W + (x0 + k * dx);
      if (k == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) L[v] = d0 + v < D ? u8_at<V>(s.cost, v) : kBig;
      } else {
        if (realigns && s.delta != 0) {
          realign<V>(L, realign_buf[warp], d0, D, s.delta);
          int m = kBig;
#pragma unroll
          for (int v = 0; v < V; ++v) m = min(m, L[v]);
          minL = warp_min(m);
        }
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
          Ln[v] = d0 + v < D ? u8_at<V>(s.cost, v) + best - minL : kBig;
        }
#pragma unroll
        for (int v = 0; v < V; ++v) L[v] = Ln[v];
      }
      int m = kBig;
#pragma unroll
      for (int v = 0; v < V; ++v) m = min(m, L[v]);
      minL = warp_min(m);

      int16_t* a = MODE == kPair ? nullptr : acc + p * D;  // kPair has no int16 volume
      if constexpr (MODE == kPair) {
        store_u8<V>((dx > 0 ? hf : hb) + p * D, d0, D, vec, L);
      } else if constexpr (MODE == kWrite) {
        store_acc<V>(a, d0, D, vec, L);
      } else if constexpr (MODE == kWriteFold) {
        int F[V];
#pragma unroll
        for (int v = 0; v < V; ++v) F[v] = u8_at<V>(s.hf, v) + u8_at<V>(s.hb, v) + L[v];
        store_acc<V>(a, d0, D, vec, F);
      } else if constexpr (MODE == kAccumulate) {
        int A[V];
#pragma unroll
        for (int v = 0; v < V; ++v) A[v] = i16_at<V>(s.acc, v) + L[v];
        store_acc<V>(a, d0, D, vec, A);
      } else {
        int T[V];
        int key = 0x7fffffff;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          T[v] = d0 + v < D ? i16_at<V>(s.acc, v) + L[v] : kBigTotal;
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
          // Windowed: window-local dv with min_disp = 1, shifted to true units.
          const float out = wstart != nullptr ? (dv - 1.0f) + (float)s.wcur : dv;
          disp[p] = far > thresh ? out : 0.0f;
        }
      }
      fetch_step<V, MODE>(ring[j], k + P, n, y0, x0, dy, dx, cost, acc, hf, hb, wstart, realigns, W, D, d0, vec);
    }
  }
}

// The pointers of one launch: the cost, the window starts and the H2
// volumes (or null), the int16 sum and the float32 disparity.
struct PathArgs {
  const uint8_t* cost;
  const int* wstart;
  uint8_t* hf;
  uint8_t* hb;
  int16_t* acc;
  float* disp;
};

template <int V>
cudaError_t launch_path(int mode, const PathArgs& a, int H, int W, int D, int dy, int dx, int P1,
                        int P2, int min_disp, int uniq, cudaStream_t s) {
  const int lines = mode == kPair ? 2 * H : (dy == 0 ? H : (dx == 0 ? W : W + H - 1));
  const dim3 grid((lines + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
#define WASS_SGM_MODE(m)                                                                      \
  case m:                                                                                     \
    sgm_path_kernel<V, m><<<grid, block, 0, s>>>(a.cost, a.wstart, a.hf, a.hb, a.acc, a.disp, \
                                                 H, W, D, dy, dx, P1, P2, min_disp, uniq);   \
    break;
  switch (mode) {
    WASS_SGM_MODE(kWrite)
    WASS_SGM_MODE(kAccumulate)
    WASS_SGM_MODE(kWta)
    WASS_SGM_MODE(kWriteFold)
    WASS_SGM_MODE(kPair)
    default:
      return cudaErrorInvalidValue;
  }
#undef WASS_SGM_MODE
  return cudaGetLastError();
}

cudaError_t launch_path_v(int mode, const PathArgs& a, int H, int W, int D, int dy, int dx, int P1,
                          int P2, int min_disp, int uniq, cudaStream_t s) {
#define WASS_SGM_CASE(v) \
  case v:                \
    return launch_path<v>(mode, a, H, W, D, dy, dx, P1, P2, min_disp, uniq, s);
  switch (wass_sgm_lane_width(D)) {
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

// The path sets (dy, dx) of stereo/sgm.py:DIRECTIONS.
const int kDirs2[2][2] = {{0, 1}, {0, -1}};
const int kDirs4[4][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}};
const int kDirs5[5][2] = {{0, 1}, {0, -1}, {1, 0}, {1, 1}, {1, -1}};
const int kDirs8[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
// The walks of wass_sgm_walk (stereo/sgm.py:WALKS): the forward and the
// backward row walk, the vertical pair.
const int kWalkFwd[3][2] = {{1, 0}, {1, 1}, {1, -1}};
const int kWalkBwd[3][2] = {{-1, 0}, {-1, -1}, {-1, 1}};
const int kWalkVert[2][2] = {{1, 0}, {-1, 0}};

const int (*path_set(int directions))[2] {
  switch (directions) {
    case 2: return kDirs2;
    case 4: return kDirs4;
    case 5: return kDirs5;
    case 8: return kDirs8;
    default: return nullptr;
  }
}

bool bad_shape(int H, int W, int D, const int* wstart) {
  return wass_sgm_lane_width(D) == 0 || H < 1 || W < 1 || (wstart != nullptr && H % kTileRows != 0);
}

// n directions, one launch each.  The first one's mode is first_mode
// (kWrite, kWriteFold or kAccumulate), the next ones accumulate, and for
// wta the last one ends in the WTA.
int run_paths(const int (*dirs)[2], int n, int first_mode, const PathArgs& a, int H, int W, int D,
              int P1, int P2, bool wta, int min_disp, int uniq, void* stream) {
  if (dirs == nullptr || bad_shape(H, W, D, a.wstart)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < n; ++k) {
    const int mode = wta && k == n - 1 ? kWta : (k == 0 ? first_mode : kAccumulate);
    const cudaError_t err = launch_path_v(mode, a, H, W, D, dirs[k][0], dirs[k][1], P1, P2, min_disp, uniq, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// All directions of a path set (K3-K6): the first writes the int16 volume.
int run_path_set(const void* cost, const void* wstart, void* acc, void* disp, int H, int W, int D,
                 int P1, int P2, int directions, bool wta, int min_disp, int uniq, void* stream) {
  const PathArgs a{(const uint8_t*)cost, (const int*)wstart, nullptr, nullptr, (int16_t*)acc, (float*)disp};
  return run_paths(path_set(directions), directions, kWrite, a, H, W, D, P1, P2, wta, min_disp, uniq, stream);
}

}  // namespace

// Disparities per lane for a disparity count D (the template instances
// above); 0 when D is out of range.
extern "C" int wass_sgm_lane_width(int D) {
  if (D < 1 || D > 1024) return 0;
  const int v = (D + 31) / 32;
  return v <= 2 ? v : (v + 3) / 4 * 4;
}

// K3: cost (H, W, D) uint8 -> disp (H, W) float32; acc is (H, W, D) int16
// scratch.  directions: 8 (all) or 5 (E, W, N, NW, NE: the forward walks).
extern "C" int wass_sgm_wta_fused(const void* cost, void* acc, void* disp, int H, int W, int D,
                                  int P1, int P2, int directions, int min_disp, int uniq,
                                  void* stream) {
  if (directions != 8 && directions != 5) return (int)cudaErrorInvalidValue;
  return run_path_set(cost, nullptr, acc, disp, H, W, D, P1, P2, directions, true, min_disp, uniq, stream);
}

// K4: windowed cost (H, W, Dw) uint8 + wstart (H / 8,) int32 -> disp
// (H, W) float32 in true disparity units; acc is (H, W, Dw) int16 scratch.
extern "C" int wass_sgm_wta_fused_windowed(const void* cost, const void* wstart, void* acc, void* disp,
                                           int H, int W, int D, int P1, int P2, int directions,
                                           int uniq, void* stream) {
  if (directions != 8 && directions != 5) return (int)cudaErrorInvalidValue;
  return run_path_set(cost, wstart, acc, disp, H, W, D, P1, P2, directions, true, 1, uniq, stream);
}

// K5: cost (H, W, D) uint8 -> acc (H, W, D) int16, the sum over the path
// set directions (2, 4, 5 or 8).
extern "C" int wass_sgm_aggregate(const void* cost, void* acc, int H, int W, int D, int P1, int P2,
                                  int directions, void* stream) {
  return run_path_set(cost, nullptr, acc, nullptr, H, W, D, P1, P2, directions, false, 0, 0, stream);
}

// K6: windowed cost (H, W, Dw) uint8 + wstart (H / 8,) int32 -> acc
// (H, W, Dw) int16, the sum over the path set directions (2, 5 or 8).
extern "C" int wass_sgm_aggregate_windowed(const void* cost, const void* wstart, void* acc, int H,
                                           int W, int D, int P1, int P2, int directions,
                                           void* stream) {
  if (directions == 4) return (int)cudaErrorInvalidValue;
  return run_path_set(cost, wstart, acc, nullptr, H, W, D, P1, P2, directions, false, 0, 0, stream);
}

// H2, _run_pair_img: cost (H, W, D) uint8 -> hf, hb (H, W, D) uint8, the
// left-to-right and right-to-left path costs, in one launch.
extern "C" int wass_sgm_pair_img(const void* cost, void* hf, void* hb, int H, int W, int D, int P1,
                                 int P2, void* stream) {
  if (bad_shape(H, W, D, nullptr)) return (int)cudaErrorInvalidValue;
  const PathArgs a{(const uint8_t*)cost, nullptr, (uint8_t*)hf, (uint8_t*)hb, nullptr, nullptr};
  return (int)launch_path_v(kPair, a, H, W, D, 0, 1, P1, P2, 0, 0, (cudaStream_t)stream);
}

// One walk over cost (H, W, D) uint8 (walk 0: the forward row walk, 1: the
// backward one, 2: the vertical pair), with window starts (H / 8,) int32
// or null.  With hf and hb (H, W, D) uint8, its first direction writes
// hf + hb + L to acc (the H2 fold); without, every direction adds into acc
// (an int16 partial sum, updated in place).  With wta its last direction
// ends in the WTA and writes disp (H, W) float32 (windowed: min_disp = 1
// and true units, as K4).
extern "C" int wass_sgm_walk(const void* cost, const void* wstart, const void* hf, const void* hb,
                             void* acc, void* disp, int H, int W, int D, int P1, int P2, int walk,
                             int wta, int min_disp, int uniq, void* stream) {
  const int(*dirs)[2] = walk == 0 ? kWalkFwd : walk == 1 ? kWalkBwd : walk == 2 ? kWalkVert : nullptr;
  if ((hf == nullptr) != (hb == nullptr)) return (int)cudaErrorInvalidValue;
  const PathArgs a{(const uint8_t*)cost, (const int*)wstart, (uint8_t*)hf, (uint8_t*)hb, (int16_t*)acc,
                   (float*)disp};
  return run_paths(dirs, walk == 2 ? 2 : 3, hf != nullptr ? kWriteFold : kAccumulate, a, H, W, D, P1, P2,
                   wta != 0, wstart != nullptr ? 1 : min_disp, uniq, stream);
}
