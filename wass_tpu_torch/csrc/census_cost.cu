// K1: full-range census cost volume.
//
// Replaces wass_tpu/stereo/sgm_pallas.py:census_cost_volume_pallas
// (_cost_kernel): cost[y, x, j] = sum_w popcount(cb[y, x, w] ^ cm[y, x - d, w])
// with d = min_disp + j, and max_cost where x - d < 0.
//
// Bound on the H100: the (H, W, D) uint8 output write (2.0 GB at
// 2048x1536, D = 640); the census words are read once per x-tile.
// Design: one block per (row, 64-column tile).  The tile's base words and
// the match words it can reach ([x0 - dmax, x0 + 64)) are staged in shared
// memory, so the popcounts read no device memory.  Threads walk the tile's
// (x, d) outputs with d fastest, four disparities per thread packed into one
// 32-bit store when D % 4 == 0, so a warp writes 512 contiguous bytes.
// Any H and W: the ragged last tile is masked, rows need no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 64;

__device__ __forceinline__ uint32_t hamming(const uint32_t* b, const uint32_t* m, int nw) {
  uint32_t c = 0;
  for (int w = 0; w < nw; ++w) c += __popc(b[w] ^ m[w]);
  return c & 0xffu;  // the reference sums into uint8
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const uint32_t* __restrict__ cb, const uint32_t* __restrict__ cm,
                   uint8_t* __restrict__ out, int W, int nw, int D, int min_disp,
                   uint32_t max_cost) {
  extern __shared__ uint32_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileX;
  const int dmax = min_disp + D - 1;
  const int mlo = x0 - dmax;  // first staged match column (may be negative)
  const int nm = kTileX + dmax;
  uint32_t* sb = smem;                // [kTileX][nw]
  uint32_t* sm = smem + kTileX * nw;  // [nm][nw]
  const size_t row = (size_t)y * W;

  for (int i = threadIdx.x; i < kTileX * nw; i += blockDim.x) {
    const int x = x0 + i / nw;
    sb[i] = x < W ? cb[row * nw + (size_t)x0 * nw + i] : 0u;
  }
  for (int i = threadIdx.x; i < nm * nw; i += blockDim.x) {
    const int xl = i / nw;
    const int x = mlo + xl;
    sm[i] = (x >= 0 && x < W) ? cm[(row + x) * nw + (i - xl * nw)] : 0u;
  }
  __syncthreads();

  const int ncols = min(kTileX, W - x0);
  const int total = ncols * D;
  uint8_t* o = out + (row + x0) * (size_t)D;
  if (kVec4) {
    for (int i = threadIdx.x * 4; i < total; i += blockDim.x * 4) {
      const int xl = i / D;
      const int j0 = i - xl * D;
      uint32_t packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int xm = x0 + xl - (min_disp + j0 + q);
        const uint32_t c = xm < 0 ? max_cost : hamming(sb + xl * nw, sm + (xm - mlo) * nw, nw);
        packed |= c << (8 * q);
      }
      *reinterpret_cast<uint32_t*>(o + i) = packed;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int xl = i / D;
      const int xm = x0 + xl - (min_disp + i - xl * D);
      o[i] = (uint8_t)(xm < 0 ? max_cost : hamming(sb + xl * nw, sm + (xm - mlo) * nw, nw));
    }
  }
}

}  // namespace

extern "C" int wass_census_cost(const void* cb, const void* cm, void* out, int H, int W, int nw,
                                int D, int min_disp, void* stream) {
  const uint32_t max_cost = (uint32_t)(32 * nw < 255 ? 32 * nw : 255);
  const size_t smem = (size_t)(2 * kTileX + min_disp + D - 1) * nw * sizeof(uint32_t);
  const dim3 grid((W + kTileX - 1) / kTileX, H);
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0) {
    cudaFuncSetAttribute(census_cost_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    census_cost_kernel<true><<<grid, kThreads, smem, s>>>(
        (const uint32_t*)cb, (const uint32_t*)cm, (uint8_t*)out, W, nw, D, min_disp, max_cost);
  } else {
    cudaFuncSetAttribute(census_cost_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    census_cost_kernel<false><<<grid, kThreads, smem, s>>>(
        (const uint32_t*)cb, (const uint32_t*)cm, (uint8_t*)out, W, nw, D, min_disp, max_cost);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* wass_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
