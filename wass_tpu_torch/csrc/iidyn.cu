// Infection-immunization dynamics (iidyn): the match rounds' Nash
// equilibrium search over a (C, C) payoff matrix.
//
// Replaces the loop that wass_tpu/match/iidyn.py:iidyn compiles into one
// lax.while_loop on the TPU (it is not a Pallas kernel).  Eager PyTorch
// would pay ~15 launches and a host read per iteration, for up to 20000
// iterations a round, so the whole loop is one kernel launch.  The caller
// (match/iidyn.py) passes the simplex projection x of x0 and Ax = A @ x;
// the kernel runs the loop, then writes the final x, the update count and
// sqrt of the final state's Nash error.
//
// Design: one block of 1024 threads runs the loop.  x, Ax and the live
// flags stay in shared memory (9 C bytes: C up to ~25.7k in the 227 KB a
// block may use); above that the same kernel keeps x and Ax in global
// scratch (template parameter kShared false).  An iteration is two passes
// over the C candidates, each ending in one block reduction:
//   A. normalize x (the previous update's simplex division), and reduce
//      xAx = x . Ax with the argmax of Ax over live and the argmin of Ax
//      over live & x > 0 as (value, index) pairs, ties to the lowest index
//      (jnp.argmax/argmin; an empty argmin gives index 0 as over +inf);
//   B. read the row A[idx, :] and update x and Ax; reduce the Nash error
//      of the state before the update (it needs xAx, known after A) and
//      the sum of the new x for the next simplex division.
// Every thread then computes the same scalars (idx, delta, mu) from the
// reduced values, so the loop's branches are uniform.  The update is
// written with __fmul_rn/__fadd_rn/__fdiv_rn so that nvcc contracts no
// multiply-add: x and Ax get the plain version's rounding; only the sums'
// order differs (a tree here, PyTorch's order there).
//
// The loop's semantics (iidyn.py:83-108): an iteration computes the error
// of the state before its update and the loop test reads that error, so
// the loop applies one update past the first state with err < toll^2; the
// count is of updates; the final error is recomputed on the final state.
//
// Bound on the H100: each iteration must read one row of A, 4 C bytes
// (48 KB at C = 12000: 14 ns at 3.35 TB/s).  What limits the kernel is the
// dependency chain: every iteration waits for two block reductions and a
// row load before the next can start (a few microseconds), so it reads a
// small share of that bound.  A thread-block cluster with distributed
// shared memory could spread the passes over several SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct ArgBest {
  float v;
  int i;
};

// (v, i) better than (w, j) for a max: larger value, or equal value and
// lower index.  NaN never wins (no NaN occurs for finite payoffs).
__device__ __forceinline__ bool max_better(float v, int i, float w, int j) { return v > w || (v == w && i < j); }
__device__ __forceinline__ bool min_better(float v, int i, float w, int j) { return v < w || (v == w && i < j); }

struct SelectPart {
  float xax;
  ArgBest mx, mn;
};

struct UpdatePart {
  float sum, err;
};

__device__ __forceinline__ SelectPart warp_select(SelectPart p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float xax = __shfl_xor_sync(0xffffffffu, p.xax, o);
    const float mxv = __shfl_xor_sync(0xffffffffu, p.mx.v, o);
    const int mxi = __shfl_xor_sync(0xffffffffu, p.mx.i, o);
    const float mnv = __shfl_xor_sync(0xffffffffu, p.mn.v, o);
    const int mni = __shfl_xor_sync(0xffffffffu, p.mn.i, o);
    p.xax += xax;
    if (max_better(mxv, mxi, p.mx.v, p.mx.i)) p.mx = {mxv, mxi};
    if (min_better(mnv, mni, p.mn.v, p.mn.i)) p.mn = {mnv, mni};
  }
  return p;
}

__device__ __forceinline__ UpdatePart warp_update(UpdatePart p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.sum += __shfl_xor_sync(0xffffffffu, p.sum, o);
    p.err += __shfl_xor_sync(0xffffffffu, p.err, o);
  }
  return p;
}

// Block reductions: each warp reduces, warp 0 reduces the warp results;
// every thread returns the block's result.  `scratch` holds kWarps entries
// and `out` one; two barriers.
__device__ SelectPart block_select(SelectPart p, SelectPart* scratch, SelectPart* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p = warp_select(p);
  if (lane == 0) scratch[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_select(scratch[lane]);  // kWarps == 32
    if (lane == 0) *out = p;
  }
  __syncthreads();
  return *out;
}

__device__ UpdatePart block_update(UpdatePart p, UpdatePart* scratch, UpdatePart* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p = warp_update(p);
  if (lane == 0) scratch[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_update(scratch[lane]);
    if (lane == 0) *out = p;
  }
  __syncthreads();
  return *out;
}

// Pass A: x[i] /= denom (the simplex division of the last update; denom 1
// for the first state), then the partial xAx, argmax and argmin.
__device__ SelectPart pass_select(float* x, const float* ax, const uint8_t* live, int C, float denom) {
  SelectPart p{0.0f, {-INFINITY, 0x7fffffff}, {INFINITY, 0x7fffffff}};
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const float xi = __fdiv_rn(x[i], denom);
    x[i] = xi;
    const float a = ax[i];
    p.xax = __fadd_rn(p.xax, __fmul_rn(xi, a));
    const bool lv = live[i] != 0;
    const float vmax = lv ? a : -INFINITY;
    const float vmin = (lv && xi > 0.0f) ? a : INFINITY;
    if (max_better(vmax, i, p.mx.v, p.mx.i)) p.mx = {vmax, i};
    if (min_better(vmin, i, p.mn.v, p.mn.i)) p.mn = {vmin, i};
  }
  return p;
}

// The Nash error of the state (x, Ax) with xAx known: one thread's part.
__device__ __forceinline__ float err_term(float xi, float a, float xax, bool lv) {
  const float d = __fsub_rn(xax, a);
  const float t = d < xi ? d : xi;
  return lv ? __fmul_rn(t, t) : 0.0f;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    iidyn_kernel(const float* __restrict__ A, float* x_io, float* ax_io, const uint8_t* live_g, int* it_out,
                 float* err_out, int C, float toll2, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SelectPart sel_scratch[kWarps];
  __shared__ UpdatePart upd_scratch[kWarps];
  __shared__ SelectPart sel_out;
  __shared__ UpdatePart upd_out;

  float* x;
  float* ax;
  const uint8_t* live;
  if constexpr (kShared) {
    x = reinterpret_cast<float*>(smem);
    ax = x + C;
    uint8_t* lv = reinterpret_cast<uint8_t*>(ax + C);
    for (int i = threadIdx.x; i < C; i += kThreads) {
      x[i] = x_io[i];
      ax[i] = ax_io[i];
      lv[i] = live_g[i];
    }
    live = lv;
    __syncthreads();
  } else {
    x = x_io;  // global scratch, updated in place
    ax = ax_io;
    live = live_g;
  }

  float denom = 1.0f;
  float err_prev = INFINITY;
  int it = 0;
  while (it < max_iters && err_prev >= toll2) {
    const SelectPart s = block_select(pass_select(x, ax, live, C, denom), sel_scratch, &sel_out);
    // Both winners are indices below C: every index takes part with its
    // masked value (-inf or +inf off the set), and ties go to the lowest.
    const float xax = s.xax;
    const float maxv = __fsub_rn(s.mx.v, xax);
    const float minv = __fsub_rn(xax, s.mn.v);
    const bool use_max = maxv >= minv;
    const int idx = use_max ? s.mx.i : s.mn.i;
    const float delta = use_max ? maxv : -minv;
    const float den = __fsub_rn(__fsub_rn(A[(size_t)idx * C + idx], ax[idx]), delta);
    const float q = __fdiv_rn(-delta, den);
    const float clipped = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);
    const float mu_pos = den < 0.0f ? clipped : 1.0f;
    const float xidx = x[idx];
    const float mu0 = __fdiv_rn(xidx, __fsub_rn(xidx, 1.0f));
    const bool raised = den < 0.0f && q > mu0;
    const float mu_neg = raised ? (q > 0.0f ? 0.0f : q) : mu0;
    const bool remove = delta < 0.0f && !raised;
    const float mu = delta >= 0.0f ? mu_pos : mu_neg;
    const float one_minus_mu = __fsub_rn(1.0f, mu);
    const float* row = A + (size_t)idx * C;
    __syncthreads();  // everyone has read x[idx] and ax[idx] before pass B writes them

    UpdatePart u{0.0f, 0.0f};
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const float xi = x[i];
      const float a = ax[i];
      const bool lv = live[i] != 0;
      u.err = __fadd_rn(u.err, err_term(xi, a, xax, lv));
      float xn = __fmul_rn(xi, one_minus_mu);
      if (i == idx) xn = remove ? 0.0f : __fadd_rn(xn, mu);
      xn = lv ? (xn > 0.0f ? xn : 0.0f) : 0.0f;
      x[i] = xn;
      u.sum = __fadd_rn(u.sum, xn);
      ax[i] = __fadd_rn(a, __fmul_rn(mu, __fsub_rn(row[i], a)));
    }
    const UpdatePart r = block_update(u, upd_scratch, &upd_out);
    denom = r.sum > 1e-30f ? r.sum : 1e-30f;
    err_prev = r.err;
    ++it;
  }

  // The final state: normalize, then its Nash error.
  const float xax = block_select(pass_select(x, ax, live, C, denom), sel_scratch, &sel_out).xax;
  UpdatePart u{0.0f, 0.0f};
  for (int i = threadIdx.x; i < C; i += kThreads) {
    u.err = __fadd_rn(u.err, err_term(x[i], ax[i], xax, live[i] != 0));
    if constexpr (kShared) x_io[i] = x[i];
  }
  const UpdatePart r = block_update(u, upd_scratch, &upd_out);
  if (threadIdx.x == 0) {
    *it_out = it;
    *err_out = sqrtf(r.err);
  }
}

}  // namespace

// A: (C, C) float32 row-major; x: (C,) float32, the simplex projection of
// x0, overwritten with the final x; ax: (C,) float32, A @ x, overwritten
// (the global-memory variant keeps its state there); live: (C,) uint8;
// it_out: int32; err_out: float32.  One block; no host synchronization.
extern "C" int wass_iidyn(const void* A, void* x, void* ax, const void* live, void* it_out, void* err_out, int C,
                          float toll2, int max_iters, void* stream) {
  if (C < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)C * 9;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // The static shared memory (reduction scratch) takes < 1 KB of the block's share.
  if (smem + 1024 <= (size_t)optin) {
    err = cudaFuncSetAttribute(iidyn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    iidyn_kernel<true><<<1, kThreads, smem, s>>>((const float*)A, (float*)x, (float*)ax, (const uint8_t*)live,
                                                 (int*)it_out, (float*)err_out, C, toll2, max_iters);
  } else {
    iidyn_kernel<false><<<1, kThreads, 0, s>>>((const float*)A, (float*)x, (float*)ax, (const uint8_t*)live,
                                               (int*)it_out, (float*)err_out, C, toll2, max_iters);
  }
  return (int)cudaGetLastError();
}
