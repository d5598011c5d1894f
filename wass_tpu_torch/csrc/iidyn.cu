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
// Bound on the H100: each update must read one row of A, 4 C bytes (48 KB
// at C = 12000: 14 ns at 3.35 TB/s), or only its live columns, 4 n_live
// bytes.  What limits the loop is its dependency chain: an update cannot
// start before the previous one has reduced its scalars over all
// candidates, so the design shortens the chain of one update.
//
// Design: one thread-block cluster of G = 16 CTAs (a non-portable size:
// the portable limit is 8) of T = 256 threads each.
//   - Of the L live columns in index order, CTA g holds those of rank
//     [g L / G, (g + 1) L / G): in the prologue every CTA counts L, then
//     compacts its share into shared memory with a block prefix scan
//     (ballot + popc), 16 bytes a column: the column, x (unnormalized
//     after the first update), Ax and the diagonal A[j, j].  Thread t takes
//     the list's elements t, t + T, ...  Candidates that are not live add
//     exactly +0 to every sum and are never read again, so no pass walks
//     them.  (Equal column ranges, one a CTA, would leave most CTAs with
//     nothing to do: the matcher's live candidates come first.)
//   - An update is one pass and one cluster reduction.  The pass reads
//     the row A[idx, :] at the thread's live columns (all loads of a chunk
//     issued before any is used), updates x and Ax, and folds the next
//     state's selection into the same pass: the reduction carries the sum
//     S of the new unnormalized x~, sum x~ . Ax_new (divided by S after,
//     giving the next xAx), the Nash error of the state before the update
//     (its xAx is known from the previous reduction), and the argmax of
//     Ax_new over live and its argmin over live & x~ > 0 (the x > 0 set
//     does not depend on the normalization).  Each argmax/argmin entry
//     carries (Ax, column, x~, A[j, j]), so the scalars of the next update
//     (den, mu0) need no dependent load.
//   - The reduction: xor shuffles within each warp, the W = T / 32 warp
//     sums folded by warp 0 the same way, then lane g of warp 0 stores the
//     CTA's partial into CTA g's shared slot [parity][rank] (distributed
//     shared memory), one barrier.cluster arrive/wait, and every warp of
//     every CTA folds the G partials with shuffles too: all threads hold
//     the same bits, so the loop's branches are uniform.  (Adding the G
//     partials one after another in rank order is G - 1 dependent adds;
//     the butterfly is log2 G shuffle steps.)  The
//     slots alternate with the update's parity, so one cluster barrier an
//     update is enough (a CTA writes slot p again only after every CTA has
//     passed the next barrier, i.e. read slot p).
// An update's time on the H100 is this chain of folds and barriers, not
// its bytes.  Keeping recent rows of A in shared memory, or gathering
// both candidates' rows before the scalars choose, did not shorten it.
// The update is written with __fmul_rn/__fadd_rn/__fdiv_rn so that nvcc
// contracts no multiply-add; match/iidyn.py:iidyn_plain runs the same
// operations and adds its sums in this order (_block_sum), so the two give
// the same bits.
//
// The loop's semantics (iidyn.py:83-108): an iteration computes the error
// of the state before its update and the loop test reads that error, so
// the loop applies one update past the first state with err < toll^2; the
// count is of updates; the final error is recomputed on the final state
// (one more reduction).  argmax/argmin ties go to the lowest column; an
// empty set's winner is column 0, as jnp.argmax/argmin's, and is never
// chosen while any candidate is live (its gap is -inf).
//
// The cluster's shape is fixed at compile time (kGroups x kThreads, the
// shape measured fastest on the H100; match/iidyn.py's GROUPS and THREADS
// mirror it).  IIDYN_GROUPS and IIDYN_THREADS override it for a build
// that emulates the cluster on a host.
//
// Capacity: a CTA's shared memory holds ceil(C / G) columns at 16 bytes:
// 16 CTAs hold ~229k candidates (a (C, C) float32 payoff on an 80 GB card
// stops at ~141k).  Above it the launcher's cudaFuncSetAttribute fails.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#ifndef IIDYN_GROUPS
#define IIDYN_GROUPS 16
#endif
#ifndef IIDYN_THREADS
#define IIDYN_THREADS 256
#endif
constexpr int kGroups = IIDYN_GROUPS;    // CTAs a cluster (a power of two, at most 16)
constexpr int kThreads = IIDYN_THREADS;  // threads a CTA (a power of two, 32-1024)
static_assert(kGroups >= 1 && kGroups <= 16 && (kGroups & (kGroups - 1)) == 0, "IIDYN_GROUPS");
static_assert(kThreads >= 32 && kThreads <= 1024 && (kThreads & (kThreads - 1)) == 0, "IIDYN_THREADS");
constexpr int kChunk = 4;         // row loads a thread keeps in flight
constexpr int kNoCluster = -2;    // wass_iidyn: no cluster of this shape fits the card

// An argmax/argmin entry: Ax value, column, unnormalized x, diagonal.
struct Best {
  float v;
  int i;
  float x;
  float d;
};

// One partial of the cluster reduction (48 bytes: three 16-byte stores).
struct __align__(16) Part {
  float s, xax, err, pad;
  Best mx, mn;
};

// Shared memory of a CTA: the slots [2][kGroups], the warp partials
// [32] and the scan counts [32] ahead of the live columns' four arrays.
constexpr size_t kHeaderBytes = sizeof(Part) * (2 * kGroups + 32) + 32 * sizeof(int);
constexpr size_t kBytesPerColumn = 16;

// (v, i) better than (w, j) for a max: larger value, or equal value and
// lower index.  NaN never wins (no NaN occurs for finite payoffs).
__device__ __forceinline__ bool max_better(float v, int i, float w, int j) { return v > w || (v == w && i < j); }
__device__ __forceinline__ bool min_better(float v, int i, float w, int j) { return v < w || (v == w && i < j); }

__device__ __forceinline__ Part identity() {
  Part p;
  p.s = p.xax = p.err = p.pad = 0.0f;
  p.mx = {-INFINITY, 0x7fffffff, 0.0f, 0.0f};
  p.mn = {INFINITY, 0x7fffffff, 0.0f, 0.0f};
  return p;
}

// p = p (+) q: the sums add, the better entry wins.
__device__ __forceinline__ void fold(Part& p, const Part& q) {
  p.s = __fadd_rn(p.s, q.s);
  p.xax = __fadd_rn(p.xax, q.xax);
  p.err = __fadd_rn(p.err, q.err);
  if (max_better(q.mx.v, q.mx.i, p.mx.v, p.mx.i)) p.mx = q.mx;
  if (min_better(q.mn.v, q.mn.i, p.mn.v, p.mn.i)) p.mn = q.mn;
}

__device__ __forceinline__ Best shfl_best(const Best& b, int o) {
  return {__shfl_xor_sync(0xffffffffu, b.v, o), __shfl_xor_sync(0xffffffffu, b.i, o),
          __shfl_xor_sync(0xffffffffu, b.x, o), __shfl_xor_sync(0xffffffffu, b.d, o)};
}

// The xor butterfly over groups of `width` lanes (a power of two): lane l
// adds lane l ^ width / 2, then l ^ width / 4, ...  When every group of
// lanes starts with the same values, every lane ends with the same bits
// (each step combines the same two operands on both lanes of a pair).
__device__ __forceinline__ Part warp_fold(Part p, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    Part q;
    q.s = __shfl_xor_sync(0xffffffffu, p.s, o);
    q.xax = __shfl_xor_sync(0xffffffffu, p.xax, o);
    q.err = __shfl_xor_sync(0xffffffffu, p.err, o);
    q.mx = shfl_best(p.mx, o);
    q.mn = shfl_best(p.mn, o);
    fold(p, q);
  }
  return p;
}

// Every thread's partial -> the cluster's, in every thread of every CTA:
// the warp's 32 lanes, then its W warp sums (lane l of warp 0 reads warp
// l mod W), then the G CTA partials (lane l of every warp reads CTA
// l mod G's), each folded in halves by the butterfly.
__device__ Part cluster_reduce(Part p, Part* slots, Part* wpart, int parity, cg::cluster_group& cluster) {
  constexpr int W = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rank = (int)cluster.block_rank();
  p = warp_fold(p, 32);
  if (lane == 0) wpart[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_fold(wpart[lane & (W - 1)], W);
    if (lane < kGroups) *cluster.map_shared_rank(&slots[parity * kGroups + rank], lane) = p;
  }
  cluster.sync();
  Part r = warp_fold(slots[parity * kGroups + (lane & (kGroups - 1))], kGroups);
  if (!(r.mx.v > -INFINITY)) r.mx.i = 0;  // an empty set's winner: column 0
  if (!(r.mn.v < INFINITY)) r.mn.i = 0;
  return r;
}

// The Nash error's term min(xAx - Ax_i, x_i)^2 of a live candidate.
__device__ __forceinline__ float err_term(float xi, float a, float xax) {
  const float d = __fsub_rn(xax, a);
  const float t = d < xi ? d : xi;
  return __fmul_rn(t, t);
}

__global__ void __launch_bounds__(kThreads)
    iidyn_kernel(const float* __restrict__ A, float* __restrict__ x_io, const float* __restrict__ ax_in,
                 const uint8_t* __restrict__ live, int* it_out, float* err_out, int C, float toll2,
                 int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  Part* slots = reinterpret_cast<Part*>(smem);
  Part* wpart = slots + 2 * kGroups;
  int* wcount = reinterpret_cast<int*>(wpart + 32);
  int* s_col = wcount + 32;

  cg::cluster_group cluster = cg::this_cluster();
  constexpr int T = kThreads, W = kThreads / 32, G = kGroups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rank = (int)cluster.block_rank();
  const int cap = (C + G - 1) / G;  // live columns a CTA holds at most
  float* s_x = reinterpret_cast<float*>(s_col + cap);
  float* s_ax = s_x + cap;
  float* s_d = s_ax + cap;

  // Prologue: L, the count of live columns (every CTA counts them all) ...
  int cnt = 0;
  for (int i = tid; i < C; i += T) cnt += live[i] != 0;
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) wcount[warp] = cnt;
  __syncthreads();
  int L = 0;
  for (int w = 0; w < W; ++w) L += wcount[w];
  __syncthreads();  // wcount is rewritten below
  // ... then this CTA's share, the live columns of ranks [r0, r1), compacted
  // in index order with a block prefix scan (ballot + popc).
  const int r0 = (int)((long long)rank * L / G), r1 = (int)((long long)(rank + 1) * L / G);
  const int n = r1 - r0;
  for (int base = 0, seen = 0; base < C && seen < r1; base += T) {
    const int i = base + tid;
    const bool lv = i < C && live[i] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, lv);
    if (lane == 0) wcount[warp] = __popc(b);
    __syncthreads();
    int off = seen, total = 0;
    for (int w = 0; w < W; ++w) {
      const int c = wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    const int rk = off + __popc(b & ((1u << lane) - 1u));
    if (lv && rk >= r0 && rk < r1) {
      const int j = rk - r0;
      s_col[j] = i;
      s_x[j] = x_io[i];
      s_ax[j] = ax_in[i];
      s_d[j] = A[(size_t)i * C + i];
    }
    seen += total;
    __syncthreads();  // wcount is rewritten by the next chunk
  }
  cluster.sync();  // every CTA runs (and has compacted) before any slot is written

  // The first state's selection (x as given: its sum is 1, denominator 1).
  Part p = identity();
  for (int j = tid; j < n; j += T) {
    const float xi = s_x[j], a = s_ax[j];
    p.xax = __fadd_rn(p.xax, __fmul_rn(xi, a));
    const Best e = {a, s_col[j], xi, s_d[j]};
    if (max_better(e.v, e.i, p.mx.v, p.mx.i)) p.mx = e;
    if (xi > 0.0f && min_better(e.v, e.i, p.mn.v, p.mn.i)) p.mn = e;
  }
  Part r = cluster_reduce(p, slots, wpart, 0, cluster);
  int parity = 1;
  float denom = 1.0f;
  float err_prev = INFINITY;
  int it = 0;
  while (it < max_iters && err_prev >= toll2) {
    const float xax = __fdiv_rn(r.xax, denom);
    const float maxv = __fsub_rn(r.mx.v, xax);
    const float minv = __fsub_rn(xax, r.mn.v);
    const bool use_max = maxv >= minv;
    const Best w = use_max ? r.mx : r.mn;
    const int idx = w.i;
    const float delta = use_max ? maxv : -minv;
    const float den = __fsub_rn(__fsub_rn(w.d, w.v), delta);
    const float q = __fdiv_rn(-delta, den);
    const float clipped = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);
    const float mu_pos = den < 0.0f ? clipped : 1.0f;
    const float xidx = __fdiv_rn(w.x, denom);
    const float mu0 = __fdiv_rn(xidx, __fsub_rn(xidx, 1.0f));
    const bool raised = den < 0.0f && q > mu0;
    const float mu_neg = raised ? (q > 0.0f ? 0.0f : q) : mu0;
    const bool remove = delta < 0.0f && !raised;
    const float mu = delta >= 0.0f ? mu_pos : mu_neg;
    const float one_minus_mu = __fsub_rn(1.0f, mu);
    const float* row = A + (size_t)idx * C;

    p = identity();
    for (int base = tid; base < n; base += kChunk * T) {
      float rv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = base + u * T;
        rv[u] = j < n ? __ldg(row + s_col[j]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = base + u * T;
        if (j < n) {
          const int col = s_col[j];
          const float xi = __fdiv_rn(s_x[j], denom);
          const float a = s_ax[j];
          p.err = __fadd_rn(p.err, err_term(xi, a, xax));
          float xn = __fmul_rn(xi, one_minus_mu);
          if (col == idx) xn = remove ? 0.0f : __fadd_rn(xn, mu);
          xn = xn > 0.0f ? xn : 0.0f;
          const float an = __fadd_rn(a, __fmul_rn(mu, __fsub_rn(rv[u], a)));
          s_x[j] = xn;
          s_ax[j] = an;
          p.s = __fadd_rn(p.s, xn);
          p.xax = __fadd_rn(p.xax, __fmul_rn(xn, an));
          const Best e = {an, col, xn, s_d[j]};
          if (max_better(e.v, e.i, p.mx.v, p.mx.i)) p.mx = e;
          if (xn > 0.0f && min_better(e.v, e.i, p.mn.v, p.mn.i)) p.mn = e;
        }
      }
    }
    r = cluster_reduce(p, slots, wpart, parity, cluster);
    parity ^= 1;
    denom = r.s > 1e-30f ? r.s : 1e-30f;
    err_prev = r.err;
    ++it;
  }

  // The final state: normalize, write x, then its Nash error.
  const float xax = __fdiv_rn(r.xax, denom);
  p = identity();
  for (int j = tid; j < n; j += T) {
    const float xi = __fdiv_rn(s_x[j], denom);
    p.err = __fadd_rn(p.err, err_term(xi, s_ax[j], xax));
    x_io[s_col[j]] = xi;
  }
  r = cluster_reduce(p, slots, wpart, parity, cluster);
  if (cluster.block_rank() == 0 && tid == 0) {
    *it_out = it;
    *err_out = sqrtf(r.err);
  }
}

}  // namespace

// A: (C, C) float32 row-major; x: (C,) float32, the simplex projection of
// x0 (0 off the live set), overwritten with the final x; ax: (C,) float32,
// A @ x; live: (C,) uint8; it_out: int32; err_out: float32.  One cluster
// of kGroups CTAs of kThreads threads; no host synchronization.  Returns a
// cudaError_t, or kNoCluster when cudaOccupancyMaxActiveClusters finds no
// place for the cluster.
extern "C" int wass_iidyn(const void* A, void* x, const void* ax, const void* live, void* it_out, void* err_out,
                          int C, float toll2, int max_iters, void* stream) {
  if (C < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = kHeaderBytes + (size_t)((C + kGroups - 1) / kGroups) * kBytesPerColumn;
  cudaError_t err = cudaFuncSetAttribute(iidyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && kGroups > 8)
    err = cudaFuncSetAttribute(iidyn_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kGroups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGroups, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, iidyn_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, iidyn_kernel, (const float*)A, (float*)x, (const float*)ax, (const uint8_t*)live,
                           (int*)it_out, (float*)err_out, C, toll2, max_iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
