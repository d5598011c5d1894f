// The optical-flow solver's two steps: the warp and linearisation of an
// outer iteration, and one Jacobi sweep.
//
// Both replace the body of a compiled JAX loop, not a Pallas kernel:
// wass_tpu/stereo/flow.py:variational_refine runs outer_body (:248-259)
// under one lax.scan and the Jacobi sweep (:261-270) under a nested one
// (:272, :275).  With the defaults a flow frame takes 8 linearisations and
// 200 sweeps (8 x 25) at full resolution.
//
//   wass_flow_linearize, for each pixel p = (x, y):
//     px = x + u, py = y + v
//     I1w, Ix, Iy = bilinear samples of I1, g1x, g1y at (px, py): clamped
//       taps, 0 outside [0, W-1] x [0, H-1] (wass_tpu/ops/sampling.py:23-51)
//     It = I1w - I0
//     inb = 1 <= px <= W-2 and 1 <= py <= H-2
//     wdata = inb / sqrt(It * It + 1e-3)
//   (the caller keeps u, v as the sweeps' warp point u0, v0, and sweeps
//   into other buffers)
//   wass_flow_jacobi, for each pixel:
//     ubar, vbar = the 8-neighbour average (1/12 on the corners, 1/6 on the
//       edges, 0 in the centre), zero-padded like the JAX "SAME" conv
//     r = It + Ix (ubar - u0) + Iy (vbar - v0)
//     den = lam + wdata (Ix Ix + Iy Iy)
//     u' = ubar - wdata Ix r / den,  v' = vbar - wdata Iy r / den
//
// Bit-equal to the plain versions (stereo/flow_kernels.py), which run the
// same expressions op by op in PyTorch, in the order written here: the
// average sums its taps row by row, left to right.  Every product, sum,
// quotient and square root is written with __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and __fsqrt_rn, so nvcc contracts no multiply-add
// (the file keeps nvcc's default -fmad).  The weights are the doubles 1/12
// and 1/6 rounded to float, as PyTorch rounds a Python scalar.
//
// Bound on the H100: bytes.  A sweep reads u, v, u0, v0, It, Ix, Iy and
// wdata and writes u' and v': 40 bytes a pixel, 37.6 us at 2048x1536 and
// 3.35 TB/s.  A linearisation reads u, v, I0 and the three sampled fields
// (counted once) and writes four fields: 40 bytes a pixel, 37.6 us.  The
// design is the simple one: one thread a pixel in blocks of 32 x 8, the
// neighbours and the bilinear taps read through L1 and L2, so a pixel's
// row neighbours share a block's cache lines.  Temporal blocking (several
// sweeps a launch over a tile in shared memory) and a precomputed den
// (den does not depend on u or v, so it would keep the bits) are later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kCorner = (float)(1.0 / 12.0);
constexpr float kEdge = (float)(1.0 / 6.0);
constexpr float kEps2 = (float)1e-3;

__device__ __forceinline__ float tap(const float* __restrict__ img, int W, int y, int x) {
  return __ldg(img + (size_t)y * W + x);
}

// The plain version's bilinear_sample at fractional offsets (fx, fy) from
// the clamped taps (x0, y0), (x1, y1): rows first, then the two rows.
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int W, int x0, int x1, int y0, int y1,
                                          float fx, float fy, float gx, float gy) {
  const float top = __fadd_rn(__fmul_rn(tap(img, W, y0, x0), gx), __fmul_rn(tap(img, W, y0, x1), fx));
  const float bot = __fadd_rn(__fmul_rn(tap(img, W, y1, x0), gx), __fmul_rn(tap(img, W, y1, x1), fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
    linearize_kernel(const float* __restrict__ I0, const float* __restrict__ I1, const float* __restrict__ g1x,
                     const float* __restrict__ g1y, const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ It, float* __restrict__ Ix, float* __restrict__ Iy,
                     float* __restrict__ wdata, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const float px = __fadd_rn((float)x, u[i]);
  const float py = __fadd_rn((float)y, v[i]);
  float i1w = 0.0f, ix = 0.0f, iy = 0.0f;
  // The samples' validity; a NaN coordinate fails it, as in torch.where.
  if (px >= 0.0f && px <= (float)(W - 1) && py >= 0.0f && py <= (float)(H - 1)) {
    const float fx0 = floorf(px), fy0 = floorf(py);
    const float fx = __fsub_rn(px, fx0), fy = __fsub_rn(py, fy0);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const int x0 = (int)fx0, y0 = (int)fy0;  // in [0, W-1] x [0, H-1] here
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    i1w = bilinear(I1, W, x0, x1, y0, y1, fx, fy, gx, gy);
    ix = bilinear(g1x, W, x0, x1, y0, y1, fx, fy, gx, gy);
    iy = bilinear(g1y, W, x0, x1, y0, y1, fx, fy, gx, gy);
  }
  const float it = __fsub_rn(i1w, I0[i]);
  const float inb = (px >= 1.0f && px <= (float)(W - 2) && py >= 1.0f && py <= (float)(H - 2)) ? 1.0f : 0.0f;
  It[i] = it;
  Ix[i] = ix;
  Iy[i] = iy;
  wdata[i] = __fdiv_rn(inb, __fsqrt_rn(__fadd_rn(__fmul_rn(it, it), kEps2)));
}

// The 8-neighbour average of a at (y, x), the taps summed row by row; a
// tap outside the image is 0 (and still added, as the plain version adds
// its zero padding).
__device__ __forceinline__ float average(const float* __restrict__ a, int H, int W, int y, int x) {
  const bool up = y > 0, down = y + 1 < H, left = x > 0, right = x + 1 < W;
  const size_t i = (size_t)y * W + x;
  const float nw = up && left ? __ldg(a + i - W - 1) : 0.0f;
  const float n = up ? __ldg(a + i - W) : 0.0f;
  const float ne = up && right ? __ldg(a + i - W + 1) : 0.0f;
  const float w = left ? __ldg(a + i - 1) : 0.0f;
  const float e = right ? __ldg(a + i + 1) : 0.0f;
  const float sw = down && left ? __ldg(a + i + W - 1) : 0.0f;
  const float s = down ? __ldg(a + i + W) : 0.0f;
  const float se = down && right ? __ldg(a + i + W + 1) : 0.0f;
  float acc = __fmul_rn(nw, kCorner);
  acc = __fadd_rn(acc, __fmul_rn(n, kEdge));
  acc = __fadd_rn(acc, __fmul_rn(ne, kCorner));
  acc = __fadd_rn(acc, __fmul_rn(w, kEdge));
  acc = __fadd_rn(acc, __fmul_rn(e, kEdge));
  acc = __fadd_rn(acc, __fmul_rn(sw, kCorner));
  acc = __fadd_rn(acc, __fmul_rn(s, kEdge));
  return __fadd_rn(acc, __fmul_rn(se, kCorner));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
    jacobi_kernel(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ u0,
                  const float* __restrict__ v0, const float* __restrict__ It, const float* __restrict__ Ix,
                  const float* __restrict__ Iy, const float* __restrict__ wdata, float* __restrict__ un,
                  float* __restrict__ vn, int H, int W, float lam) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const float ubar = average(u, H, W, y, x);
  const float vbar = average(v, H, W, y, x);
  const float ix = Ix[i], iy = Iy[i], wd = wdata[i];
  const float r = __fadd_rn(__fadd_rn(It[i], __fmul_rn(ix, __fsub_rn(ubar, u0[i]))),
                            __fmul_rn(iy, __fsub_rn(vbar, v0[i])));
  const float den = __fadd_rn(lam, __fmul_rn(wd, __fadd_rn(__fmul_rn(ix, ix), __fmul_rn(iy, iy))));
  un[i] = __fsub_rn(ubar, __fdiv_rn(__fmul_rn(__fmul_rn(wd, ix), r), den));
  vn[i] = __fsub_rn(vbar, __fdiv_rn(__fmul_rn(__fmul_rn(wd, iy), r), den));
}

dim3 grid_of(int H, int W) { return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY); }

}  // namespace

extern "C" int wass_flow_linearize(const float* I0, const float* I1, const float* g1x, const float* g1y,
                                   const float* u, const float* v, float* It, float* Ix, float* Iy, float* wdata,
                                   int H, int W, cudaStream_t stream) {
  if ((long long)H * W == 0) return 0;
  linearize_kernel<<<grid_of(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(I0, I1, g1x, g1y, u, v, It, Ix, Iy, wdata,
                                                                         H, W);
  return (int)cudaGetLastError();
}

extern "C" int wass_flow_jacobi(const float* u, const float* v, const float* u0, const float* v0, const float* It,
                                const float* Ix, const float* Iy, const float* wdata, float* un, float* vn, int H,
                                int W, float lam, cudaStream_t stream) {
  if ((long long)H * W == 0) return 0;
  jacobi_kernel<<<grid_of(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(u, v, u0, v0, It, Ix, Iy, wdata, un, vn, H, W,
                                                                      lam);
  return (int)cudaGetLastError();
}
