// K1: full-range census cost volume; K2: the same over per-tile windows.
//
// K1 replaces wass_tpu/stereo/sgm_pallas.py:census_cost_volume_pallas
// (_cost_kernel): cost[y, x, j] = sum_w popcount(cb[y, x, w] ^ cm[y, x - d, w])
// with d = min_disp + j, and max_cost where x - d < 0.
// K2 replaces census_cost_volume_pallas_windowed (_cost_kernel_windowed):
// the same with d = wstart[y / 8] + j for j < Dw, the window of the row's
// 8-row tile (stereo/c2f.py).  One kernel computes both: its first
// disparity is min_disp, or the row's window start.
//
// Bound on the H100: the popcounts.  __popc issues at 16 results a clock
// per SM on sm_90, a quarter of the XOR/IADD rate, so nw popcounts an
// output (nw = 2 for the 7x9 window) outweigh the (H, W, D) uint8 output
// write: at 2048x1536, D = 640, 4.0e9 popcounts take ~0.96 ms at 1.98 GHz
// against ~0.6 ms for the 2.0 GB written.
//
// Design.  One block per (row, tile of up to 256 columns).  The tile's
// census words are staged in shared memory one plane after another
// (sm[w][column]), as the Pallas kernel keeps them, so lanes reading
// consecutive columns hit distinct banks.  Output (x, d) depends on the
// match column c = x - d only, so each lane owns one diagonal: it keeps
// column c's nw words in registers and walks a strip of K = 16 base
// columns (their words in registers too, the same for the whole warp),
// producing cost[x, x - c - first disparity].  Lanes take consecutive
// diagonals, so at each step the warp writes 32 consecutive bytes of one
// column's disparities: one shared-memory wavefront per 32 outputs, and
// ~nw reads per 32 K.  A chunk of 32 diagonals that lies inside the volume
// (most do) stores unconditionally; the warp takes one path, so edge
// chunks do not run both.  The (columns x D) output tile is contiguous in
// the volume; it is built in shared memory and written out by one bulk
// copy (TMA), which runs on while the SM computes other blocks' tiles, so
// the 2 GB write overlaps the popcounts instead of following them (plain
// byte stores where W * D is not a multiple of 16).  One block per task
// keeps the blocks of an SM out of step; persistent blocks that prefetch
// their next row ran in step and were slower on the H100.  Tiles are as
// wide as 64 KB of shared memory allows (256 columns for small D), so a
// block's staging is amortised over more outputs.  No division in the
// inner loop: nw and K are template constants.  Any H, W, D >= 1,
// min_disp >= 0, nw in [1, 8].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;  // rows per window tile (K2)
constexpr int kMaxTileX = 256;
constexpr int kMinTileX = 16;              // a multiple of every strip length; 16 D bytes a multiple of 16
constexpr int kPreferredSmem = 64 * 1024;  // narrower tiles above this, so that 4 blocks share an SM
constexpr int kMaxSmem = 227 * 1024;

// Base columns a lane holds in registers: K nw words, at most 32 registers.
__host__ __device__ constexpr int strip_len(int nw) { return nw <= 2 ? 16 : nw <= 4 ? 8 : 4; }

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// The output tile, then the staged words: base [nw][tile_x], match [nw][tile_x + D - 1].
size_t smem_bytes(int nw, int tile_x, int D) {
  return (size_t)align16(tile_x * D) + (size_t)nw * (2 * tile_x + D - 1) * sizeof(uint32_t);
}

// Bulk copy of a 16-byte aligned shared-memory tile to device memory, on
// the copy engine (TMA), which runs on while the SM computes other blocks.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// wstart null: K1 (first disparity min_disp); else K2 (wstart[y / 8]).
// kBulk: the output is written by bulk copies (16-byte aligned tiles).
template <int NW, bool kBulk>
__global__ void __launch_bounds__(kThreads, 4)
census_cost_kernel(const uint32_t* __restrict__ cb, const uint32_t* __restrict__ cm,
                   const int* __restrict__ wstart, uint8_t* __restrict__ out, int W, int D, int tile_x,
                   int min_disp, uint32_t max_cost) {
  constexpr int K = strip_len(NW);
  extern __shared__ __align__(16) uint8_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile_x;
  const int ncols = min(tile_x, W - x0);
  const int dlo = wstart != nullptr ? wstart[y / kTileRows] : min_disp;
  const int nm = tile_x + D - 1;       // match columns the tile reaches
  const int mlo = x0 - dlo - (D - 1);  // the first of them (may be negative)
  uint8_t* so = smem;                                                        // [ncols][D] output tile
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + align16(tile_x * D));  // [NW][tile_x]
  uint32_t* sm = sb + NW * tile_x;                                           // [NW][nm]
  const size_t row = (size_t)y * W;

  for (int i = threadIdx.x; i < tile_x * NW; i += kThreads) {
    const int xl = i / NW, w = i - xl * NW, x = x0 + xl;
    sb[w * tile_x + xl] = x < W ? cb[(row + x) * NW + w] : 0u;
  }
  for (int i = threadIdx.x; i < nm * NW; i += kThreads) {
    const int xl = i / NW, w = i - xl * NW, x = mlo + xl;
    sm[w * nm + xl] = (x >= 0 && x < W) ? cm[(row + x) * NW + w] : 0u;
  }
  __syncthreads();

  // Strip s (columns s K .. s K + K - 1) goes to `share` warps, which take
  // its chunks of 32 diagonals in turn; a tile has 1-64 strips.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int share = max(1, kWarps / (tile_x / K));
  const int nchunks = (D + K - 1 + 31) / 32;  // a strip crosses D + K - 1 diagonals

  // Lane `lane` of chunk ch takes j0 = 32 ch + lane - (K - 1), the
  // disparity index at the strip's first column; its step k writes
  // (xl + k, j0 + k) where 0 <= j0 + k < D, and the match column
  // c = x0 + xl - dlo - j0 is the same at every step; it sits at
  // xl + D - 1 - j0 in the staged columns.
  for (int xl = warp / share * K; xl < ncols; xl += kWarps / share * K) {
    uint32_t b[K][NW];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int w = 0; w < NW; ++w) b[k][w] = sb[w * tile_x + xl + k];  // a broadcast
    const int kcols = ncols - xl;  // < K on the last strip of a ragged tile
    for (int ch = warp % share; ch < nchunks; ch += share) {
      const int j0 = 32 * ch + lane - (K - 1);
      const int c = x0 + xl - dlo - j0;
      uint32_t m[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = sm[w * nm + xl + D - 1 - min(j0, D - 1)];
      uint8_t* o = so + xl * D + j0;  // step k writes o[k * (D + 1)]
      // One path for the whole warp, so no chunk runs both: most chunks
      // lie inside the volume and store unconditionally.
      if (__all_sync(0xffffffffu, c >= 0 && j0 >= 0 && j0 + K <= D && K <= kcols)) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint32_t v = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) v += __popc(b[k][w] ^ m[w]);
          o[k * (D + 1)] = (uint8_t)v;  // the reference sums into uint8
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint32_t v = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) v += __popc(b[k][w] ^ m[w]);
          if ((unsigned)(j0 + k) < (unsigned)D && k < kcols) o[k * (D + 1)] = (uint8_t)(c >= 0 ? v : max_cost);
        }
      }
    }
  }

  // The tile's ncols * D bytes are contiguous in the volume.
  uint8_t* g = out + (row + x0) * D;
  if (kBulk) {
    fence_async_shared();  // the tile's bytes, visible to the bulk copy
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(g, so, ncols * D);
      bulk_wait_read();  // shared memory outlives the copy's reads, not its writes
    }
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < ncols * D; i += kThreads) g[i] = so[i];
  }
}

template <int NW, bool kBulk>
int launch_kernel(const void* cb, const void* cm, const int* wstart, void* out, int H, int W, int D,
                  int min_disp, cudaStream_t s) {
  int tile_x = kMaxTileX;
  while (tile_x > kMinTileX && smem_bytes(NW, tile_x, D) > kPreferredSmem) tile_x /= 2;
  const size_t smem = smem_bytes(NW, tile_x, D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = census_cost_kernel<NW, kBulk>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const uint32_t max_cost = (uint32_t)(32 * NW < 255 ? 32 * NW : 255);
  kernel<<<dim3((W + tile_x - 1) / tile_x, H), kThreads, smem, s>>>(
      (const uint32_t*)cb, (const uint32_t*)cm, wstart, (uint8_t*)out, W, D, tile_x, min_disp, max_cost);
  return (int)cudaGetLastError();
}

// A tile's first byte (row * W + x0) * D and its length are multiples of 16
// when W * D is, since the tile width is a multiple of 16.
template <int NW>
int launch(const void* cb, const void* cm, const int* wstart, void* out, int H, int W, int D,
           int min_disp, cudaStream_t s) {
  if (((uintptr_t)out & 15) == 0 && (size_t)W * D % 16 == 0)
    return launch_kernel<NW, true>(cb, cm, wstart, out, H, W, D, min_disp, s);
  return launch_kernel<NW, false>(cb, cm, wstart, out, H, W, D, min_disp, s);
}

int dispatch(const void* cb, const void* cm, const int* wstart, void* out, int H, int W, int nw, int D,
             int min_disp, void* stream) {
  if (H < 1 || W < 1 || D < 1 || min_disp < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nw) {
    case 1: return launch<1>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 2: return launch<2>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 3: return launch<3>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 4: return launch<4>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 5: return launch<5>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 6: return launch<6>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 7: return launch<7>(cb, cm, wstart, out, H, W, D, min_disp, s);
    case 8: return launch<8>(cb, cm, wstart, out, H, W, D, min_disp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wass_census_cost(const void* cb, const void* cm, void* out, int H, int W, int nw,
                                int D, int min_disp, void* stream) {
  return dispatch(cb, cm, nullptr, out, H, W, nw, D, min_disp, stream);
}

// K2: wstart (H / 8,) int32 window starts (>= 0) -> out (H, W, Dw) uint8.
extern "C" int wass_census_cost_windowed(const void* cb, const void* cm, const void* wstart, void* out,
                                         int H, int W, int nw, int Dw, void* stream) {
  if (H % kTileRows != 0) return (int)cudaErrorInvalidValue;
  return dispatch(cb, cm, (const int*)wstart, out, H, W, nw, Dw, 0, stream);
}

extern "C" const char* wass_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
