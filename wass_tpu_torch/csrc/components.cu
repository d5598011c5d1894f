// K7: connected-component labels by segmented min-label propagation.
//
// Replaces wass_tpu/ops/components_pallas.py:label_components_pallas
// (_prop_pair / _prop_kernel).  One round is a vertical pass then a
// horizontal pass; each pass computes, along every column (row), the
// segmented running minimum of the labels forward and backward and keeps
// min(fwd, bwd).  connect[i] says element i joins its predecessor in the
// forward walk; the backward walk joins i to i+1 through connect[i+1].
//
// Bound on the H100: latency of the serial walk.  Each thread walks one
// column (coalesced across the warp) or one row (strided, served from L1),
// two passes a round, 2 * max_iters rounds, so the (H, W) int32 labels
// cross device memory 4 times a round and the walks are short chains of
// dependent min operations.  The loads do not depend on the carry, so the
// unrolled loops keep several in flight.  Union-find would cut the rounds;
// that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;

// Walk n elements from `base` with stride `step`: labels in/out (in place),
// connect-to-previous flags, scratch for the forward minima.
__device__ __forceinline__ void propagate_line(int* __restrict__ lab, const uint8_t* __restrict__ conn,
                                               int* __restrict__ fwd, size_t base, size_t step, int n) {
  int f = kInf;
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const size_t i = base + (size_t)k * step;
    const int l = lab[i];
    f = conn[i] ? min(l, f) : l;
    fwd[i] = f;
  }
  int b = kInf;
  bool c_next = false;  // does element k join element k + 1 (backward walk)?
#pragma unroll 8
  for (int k = n - 1; k >= 0; --k) {
    const size_t i = base + (size_t)k * step;
    const int l = lab[i];
    b = c_next ? min(l, b) : l;
    c_next = conn[i] != 0;
    lab[i] = min(fwd[i], b);
  }
}

__global__ void propagate_columns(int* lab, const uint8_t* conn_v, int* fwd, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < W) propagate_line(lab, conn_v, fwd, (size_t)x, (size_t)W, H);
}

__global__ void propagate_rows(int* lab, const uint8_t* conn_h, int* fwd, int H, int W) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y < H) propagate_line(lab, conn_h, fwd, (size_t)y * W, 1, W);
}

}  // namespace

// labels: (H, W) int32, updated in place (initial labels in, final out);
// conn_v[y, x]: (y, x) joins (y-1, x); conn_h[y, x]: (y, x) joins (y, x-1);
// scratch: (H, W) int32.
extern "C" int wass_label_propagate(void* labels, const void* conn_v, const void* conn_h,
                                    void* scratch, int H, int W, int rounds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* lab = (int*)labels;
  int* fwd = (int*)scratch;
  for (int r = 0; r < rounds; ++r) {
    propagate_columns<<<(W + 127) / 128, 128, 0, s>>>(lab, (const uint8_t*)conn_v, fwd, H, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 32 threads a block spreads the few row walks over many SMs.
    propagate_rows<<<(H + 31) / 32, 32, 0, s>>>(lab, (const uint8_t*)conn_h, fwd, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
