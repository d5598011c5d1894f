// The census transform with its Gaussian pre-blur, one launch an image:
// (H, W) float32 -> (H, W, nw) int32 words.
//
// Replaces no Pallas kernel.  It replaces the XLA fusion of
// wass_tpu/stereo/cost.py:census_transform and its pre-blur
// (wass_tpu/match/features.py:_gauss_blur), which the JAX package leaves
// to XLA as plain jnp; the plain PyTorch version (stereo/cost.py:
// census_transform) runs it as ~290 kernels, so the port gains a kernel
// here where the JAX package had none.  What it computes, bit for bit:
//
//   blur (sigma > 0, radius R = max(1, int(3 sigma + 0.5)), taps k[0..2R]
//   from stereo/cost.py:_gauss_kernel1d on the card): the vertical pass
//     v[y, x] = sum_t k[t] * img[clamp(y - R + t), x]
//   then the horizontal pass b[y, x] = sum_t k[t] * v[y, clamp(x - R + t)],
//   each product rounded to float32 and each sum taken in _pairwise_sum's
//   tree ((t0 + t1) + (t2 + t3)) + ..., the odd leftover appended last;
//   census (window wy x wx, both odd): bit i of word w (i + 32 w the
//   neighbour's rank in row-major order, the centre skipped) is set where
//   the neighbour of b, 0 outside the image, is below the centre.
//
// Every product and sum is written with __fmul_rn and __fadd_rn, so nvcc
// contracts no multiply-add, as PyTorch's separate mul and add kernels do
// not.  The binary-counter form of the pairwise tree (pairwise_rt) is the
// same tree for every tap count: a block of 2^j terms closes as soon as it
// fills, and the open blocks are added from the last one back.
//
// Bound on the H100: bytes, on paper.  The image is read once (4 bytes a
// pixel) and the words written once (4 nw bytes): 37.7 MB at 2048x1536
// with the 7x9 window (nw = 2), 11.3 us at 3.35 TB/s.  What binds is the
// integer pipe: each of a pixel's 62 bits takes a comparison and an OR
// (or, the same speed on the card, a float difference and a funnel shift
// of its sign), and the card's rate for them makes the census alone ~25 us
// at 2048x1536 (the kernel without the blur, measured on an H100 SXM at
// 700 W); the blur adds ~3 us at sigma 0.8.
//
// Design.  One block per 32 x 64 tile of output pixels.  The block reads
// its tile and halo of the image once through the read-only cache, rows
// coalesced (consecutive threads on consecutive columns, edge-replicated
// indices), and runs the vertical pass in registers, 8 rows a thread,
// into shared memory (v); the horizontal pass reads v and writes the
// blurred tile with the census halo, 0 outside the image (b), 4 columns a
// thread and one 16-byte store; b's row pitch is 4 mod 8 floats and v's
// odd, so neither pass has bank conflicts.  Each thread then holds 4
// consecutive pixels of a row: per window row it loads the row segment
// they share with 16-byte loads, compares in registers, builds the 4
// pixels' words there and writes them out contiguous, 16-byte stores
// where W is a multiple of 4.  Radii up to kMaxRadius and the stereo
// path's 7x9 window are compiled unrolled; a wider radius sums through
// the binary counter, and any other window (up to 8 words) loops over
// its offsets, flushing each word as it completes.  Taller tiles, 8
// pixels a thread, 128-thread blocks, more blocks an SM, deeper staging
// loads and other ways to build the bits measured no faster, or slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kPix = 4;         // census pixels a thread holds, consecutive in a row
constexpr int kStripV = 8;      // rows of the vertical pass a thread computes
constexpr int kMaxRadius = 8;   // radii compiled unrolled (sigma < 2.84)
constexpr int kMaxWords = 8;    // 256 census bits, as K1/K2 take
constexpr int kMaxSmem = 227 * 1024;

// The tile's shared-memory geometry for radius r and window wy x wx.
struct Shape {
  int r, ry, rx, nw;
  int vh;       // rows of v and b: the tile and the census halo
  int bw;       // columns of b computed: thread g's census reads [4 g, 4 g + 4 nseg), nseg 16-byte loads
  int pitch_b;  // 4 mod 8 floats
  int vw;       // columns of v: b's and the blur halo
  int pitch_v;  // odd
};

__host__ __device__ constexpr Shape make_shape(int r, int wy, int wx) {
  const int nseg = (wx + kPix - 1 + 3) / 4;  // a row segment: wx + kPix - 1 floats
  const int bw = kTileW - kPix + 4 * nseg;
  const int vw = bw + 2 * r;
  return Shape{r, wy / 2, wx / 2, (wy * wx - 1 + 31) / 32, kTileH + 2 * (wy / 2), bw,
               bw % 8 == 4 ? bw : bw + 4, vw, vw | 1};
}

__host__ __device__ constexpr size_t smem_bytes(const Shape& s) {
  return (size_t)s.vh * s.pitch_b * sizeof(float) + (s.r > 0 ? (size_t)s.vh * s.pitch_v * sizeof(float) : 0);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// _pairwise_sum of t[0..N-1] (overwritten), unrolled.
template <int N>
__device__ __forceinline__ float pairwise(float* t) {
  if constexpr (N == 1) {
    return t[0];
  } else {
    constexpr int M = N / 2;
#pragma unroll
    for (int i = 0; i < M; ++i) t[i] = __fadd_rn(t[2 * i], t[2 * i + 1]);
    if constexpr (N % 2 == 1) t[M] = t[N - 1];
    return pairwise<M + N % 2>(t);
  }
}

// The same tree over n terms term(0..n-1) as a binary counter: adding
// term t closes one block for each trailing one bit of t.
template <class Term>
__device__ float pairwise_rt(int n, Term term) {
  float stack[32];
  int sp = 0;
  for (int t = 0; t < n; ++t) {
    float v = term(t);
    for (int c = t; c & 1; c >>= 1) v = __fadd_rn(stack[--sp], v);
    stack[sp++] = v;
  }
  while (sp > 1) {
    const float top = stack[--sp];
    stack[sp - 1] = __fadd_rn(stack[sp - 1], top);
  }
  return stack[0];
}

// v[r][j] = the vertical pass at image row by + r, column clamp(bx - R + j).
template <int R>
__device__ void vertical_pass(const float* __restrict__ img, const float* __restrict__ taps, float* v,
                              const Shape& s, int by, int bx, int H, int W) {
  if constexpr (R > 0) {
    constexpr int NT = 2 * R + 1;
    float k[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) k[t] = __ldg(taps + t);
    const int nstrips = (s.vh + kStripV - 1) / kStripV;
    for (int i = threadIdx.x; i < s.vw * nstrips; i += kThreads) {
      const int st = i / s.vw, j = i - st * s.vw, r0 = st * kStripV;
      const float* col = img + clampi(bx - R + j, 0, W - 1);
      float x[kStripV + 2 * R];
#pragma unroll
      for (int m = 0; m < kStripV + 2 * R; ++m) x[m] = __ldg(col + (size_t)clampi(by + r0 - R + m, 0, H - 1) * W);
#pragma unroll
      for (int q = 0; q < kStripV; ++q) {
        float t[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u) t[u] = __fmul_rn(k[u], x[q + u]);
        const float sum = pairwise<NT>(t);
        if (r0 + q < s.vh) v[(r0 + q) * s.pitch_v + j] = sum;
      }
    }
  } else {
    const int R_ = s.r;
    for (int i = threadIdx.x; i < s.vw * s.vh; i += kThreads) {
      const int r = i / s.vw, j = i - r * s.vw;
      const float* col = img + clampi(bx - R_ + j, 0, W - 1);
      v[r * s.pitch_v + j] = pairwise_rt(2 * R_ + 1, [&](int t) {
        return __fmul_rn(__ldg(taps + t), __ldg(col + (size_t)clampi(by + r - R_ + t, 0, H - 1) * W));
      });
    }
  }
}

// b[r][j] = the horizontal pass of v at image (by + r, bx + j), or 0
// outside the image.
template <int R>
__device__ void horizontal_pass(const float* __restrict__ taps, const float* v, float* b, const Shape& s, int by,
                                int bx, int H, int W) {
  constexpr int NT = R > 0 ? 2 * R + 1 : 1;
  float k[NT];
  if constexpr (R > 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) k[t] = __ldg(taps + t);
  }
  for (int i = threadIdx.x; i < s.vh * (s.bw / 4); i += kThreads) {
    const int st = i / s.vh, r = i - st * s.vh, j0 = 4 * st;
    const float* row = v + r * s.pitch_v + j0;
    float o[4];
    if constexpr (R > 0) {
      float x[4 + 2 * R];
#pragma unroll
      for (int m = 0; m < 4 + 2 * R; ++m) x[m] = row[m];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float t[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u) t[u] = __fmul_rn(k[u], x[q + u]);
        o[q] = pairwise<NT>(t);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = pairwise_rt(2 * s.r + 1, [&](int t) { return __fmul_rn(__ldg(taps + t), row[q + t]); });
    }
    const int y = by + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int x = bx + j0 + q;
      if (y < 0 || y >= H || x < 0 || x >= W) o[q] = 0.0f;
    }
    *reinterpret_cast<float4*>(b + r * s.pitch_b + j0) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// b = the image itself (no blur), 0 outside it.
__device__ void load_unblurred(const float* __restrict__ img, float* b, const Shape& s, int by, int bx, int H,
                               int W) {
  for (int i = threadIdx.x; i < s.vh * s.bw; i += kThreads) {
    const int r = i / s.bw, j = i - r * s.bw, y = by + r, x = bx + j;
    b[r * s.pitch_b + j] = (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(img + (size_t)y * W + x) : 0.0f;
  }
}

// The census of a compile-time window: per window row, the 4 pixels' row
// segment in registers, their words in registers, one contiguous write.
template <int WY, int WX>
__device__ void census_unrolled(const float* b, uint32_t* __restrict__ out, const Shape& s, int y0, int x0, int H,
                                int W, bool vec) {
  constexpr int RY = WY / 2, RX = WX / 2, NW = (WY * WX - 1 + 31) / 32;
  constexpr int NSEG = (WX + kPix - 1 + 3) / 4;
  constexpr int kGroups = kTileW / kPix;            // pixel groups in a tile row
  constexpr int kRowsPerPass = kThreads / kGroups;  // tile rows the block covers at once
  const int g = threadIdx.x % kGroups;
#pragma unroll 1
  for (int r = threadIdx.x / kGroups; r < kTileH; r += kRowsPerPass) {
    const float* base = b + r * s.pitch_b + kPix * g;
    float c[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) c[k] = base[RY * s.pitch_b + RX + k];
    uint32_t wd[kPix * NW];
#pragma unroll
    for (int i = 0; i < kPix * NW; ++i) wd[i] = 0u;
#pragma unroll
    for (int dy = 0; dy < WY; ++dy) {
      float seg[4 * NSEG];
#pragma unroll
      for (int q = 0; q < NSEG; ++q) {
        const float4 f = reinterpret_cast<const float4*>(base + dy * s.pitch_b)[q];
        seg[4 * q] = f.x, seg[4 * q + 1] = f.y, seg[4 * q + 2] = f.z, seg[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int dx = 0; dx < WX; ++dx) {
        if (dy == RY && dx == RX) continue;
        const int bit = dy * WX + dx - (dy * WX + dx > RY * WX + RX ? 1 : 0);
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (seg[dx + k] < c[k]) wd[k * NW + bit / 32] |= 1u << (bit % 32);
      }
    }
    const int y = y0 + r, x = x0 + kPix * g;
    if (y >= H) continue;
    uint32_t* o = out + ((size_t)y * W + x) * NW;
    if (vec && x + kPix <= W) {  // kPix NW words, 16-byte aligned
#pragma unroll
      for (int q = 0; q < kPix * NW / 4; ++q)
        reinterpret_cast<uint4*>(o)[q] = make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (x + k < W)
#pragma unroll
          for (int w = 0; w < NW; ++w) o[k * NW + w] = wd[k * NW + w];
    }
  }
}

// The census of any window: offsets in row-major order, each word written
// as soon as its 32 bits (or the last bits) are set.
__device__ void census_loop(const float* b, uint32_t* __restrict__ out, const Shape& s, int wy, int wx, int y0,
                            int x0, int H, int W) {
  constexpr int kGroups = kTileW / kPix;
  constexpr int kRowsPerPass = kThreads / kGroups;
  const int g = threadIdx.x % kGroups;
  for (int r = threadIdx.x / kGroups; r < kTileH; r += kRowsPerPass) {
    const float* base = b + r * s.pitch_b + kPix * g;
    const int y = y0 + r, x = x0 + kPix * g;
    uint32_t* o = out + ((size_t)y * W + x) * s.nw;
    float c[kPix];
    uint32_t cur[kPix] = {};
#pragma unroll
    for (int k = 0; k < kPix; ++k) c[k] = base[s.ry * s.pitch_b + s.rx + k];
    int bit = 0, w = 0;
    for (int dy = 0; dy < wy; ++dy) {
      for (int dx = 0; dx < wx; ++dx) {
        if (dy == s.ry && dx == s.rx) continue;
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (base[dy * s.pitch_b + dx + k] < c[k]) cur[k] |= 1u << bit;
        const bool last = dy == wy - 1 && dx == wx - 1;
        if (++bit == 32 || last) {
          if (y < H) {
#pragma unroll
            for (int k = 0; k < kPix; ++k)
              if (x + k < W) o[k * s.nw + w] = cur[k];
          }
#pragma unroll
          for (int k = 0; k < kPix; ++k) cur[k] = 0u;
          bit = 0, ++w;
        }
      }
    }
  }
}

// R >= 0: that radius, unrolled (0: no blur); R < 0: the radius r.
// WY = WX = 0: the window wy x wx, looped.
template <int R, int WY, int WX>
__global__ void __launch_bounds__(kThreads)
census_transform_kernel(const float* __restrict__ img, const float* __restrict__ taps, uint32_t* __restrict__ out,
                        int H, int W, int r, int wy, int wx, bool vec) {
  const Shape s = make_shape(R >= 0 ? R : r, WY ? WY : wy, WX ? WX : wx);
  extern __shared__ __align__(16) float smem[];
  float* b = smem;                     // [vh][pitch_b]
  float* v = smem + s.vh * s.pitch_b;  // [vh][pitch_v], with a blur
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int by = y0 - s.ry, bx = x0 - s.rx;  // the image position of b[0][0]
  if constexpr (R == 0) {
    load_unblurred(img, b, s, by, bx, H, W);
  } else {
    vertical_pass<R>(img, taps, v, s, by, bx, H, W);
    __syncthreads();
    horizontal_pass<R>(taps, v, b, s, by, bx, H, W);
  }
  __syncthreads();
  if constexpr (WY > 0)
    census_unrolled<WY, WX>(b, out, s, y0, x0, H, W, vec);
  else
    census_loop(b, out, s, wy, wx, y0, x0, H, W);
}

template <int R, int WY, int WX>
int launch(const float* img, const float* taps, uint32_t* out, int H, int W, int r, int wy, int wx, cudaStream_t st) {
  const size_t smem = smem_bytes(make_shape(r, wy, wx));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = census_transform_kernel<R, WY, WX>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((uintptr_t)out & 15) == 0 && W % kPix == 0;
  kernel<<<dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH), kThreads, smem, st>>>(
      img, taps, out, H, W, r, wy, wx, vec);
  return (int)cudaGetLastError();
}

template <int WY, int WX>
int by_radius(const float* img, const float* taps, uint32_t* out, int H, int W, int r, int wy, int wx,
              cudaStream_t st) {
  switch (r) {
    case 0: return launch<0, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 1: return launch<1, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 2: return launch<2, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 3: return launch<3, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 4: return launch<4, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 5: return launch<5, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 6: return launch<6, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 7: return launch<7, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    case 8: return launch<8, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
    default: return launch<-1, WY, WX>(img, taps, out, H, W, r, wy, wx, st);
  }
}

static_assert(kMaxRadius == 8, "by_radius unrolls radii 0..kMaxRadius");

}  // namespace

// img (H, W) float32, taps (2 radius + 1) float32 on the card (null for
// radius 0: no blur) -> out (H, W, nw) int32, nw = ceil((wy wx - 1) / 32).
extern "C" int wass_census_transform(const void* img, const void* taps, void* out, int H, int W, int radius, int wy,
                                     int wx, void* stream) {
  if (H < 1 || W < 1 || radius < 0 || (radius > 0 && taps == nullptr)) return (int)cudaErrorInvalidValue;
  if (wy < 1 || wx < 1 || wy % 2 == 0 || wx % 2 == 0) return (int)cudaErrorInvalidValue;
  const int nw = (wy * wx - 1 + 31) / 32;
  if (nw < 1 || nw > kMaxWords) return (int)cudaErrorInvalidValue;
  const float* im = (const float*)img;
  const float* tp = (const float*)taps;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (wy == 7 && wx == 9) return by_radius<7, 9>(im, tp, o, H, W, radius, wy, wx, st);
  return by_radius<0, 0>(im, tp, o, H, W, radius, wy, wx, st);
}
