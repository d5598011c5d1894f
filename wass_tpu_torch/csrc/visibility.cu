// The visibility ray march: occlusion of every grid cell of a frame slab.
//
// Replaces the compiled lax.while_loop of
// wass_tpu/post/geometry.py:_visibility_device_batch (:94, the loop at
// :168) and of _occlusion_device (:33, the loop at :68), which carry every
// ray of the slab through up to max_steps steps and stop when no ray is
// active.  Here one thread marches one ray and stops when its ray does:
// an inactive ray never changes its flag, so the per-ray exit gives the
// flags of the slab-wide `any(active)` stop.
//
// Ray r of frame b starts at its cell (x, y, Z[b, y, x]) (cell units) and
// steps by d[r] (normalised in PyTorch before the launch so that the
// larger horizontal component is one cell).  A step, in the JAX body's
// order:
//   px += dx; py += dy; pz += dz          (float32, accumulated step by step)
//   rx = rint(px); ry = rint(py)          (half to even, as jnp.round)
//   inactive unless 0 <= rx < W, 0 <= ry < H and pz <= maxz[b]
//   occluded (and inactive) if Z[b, ry, rx] >= pz
// The bounds are tested on the rounded floats: for a finite px that is
// the JAX test on the int32 index; a NaN px comes with a NaN pz (the
// directions are NaN together), which the JAX test stops too.  A NaN maxz
// (a frame with a hole: jnp.max propagates NaN) stops every ray of the
// frame at its first step, and a ray from a NaN cell stops at once.
//
// Bound on the H100: bytes.  Each ray must read its Z (4 bytes) and d (12
// bytes) and write its flag (1 byte): 17 bytes a ray, 0.113 ms for the
// 22.3M rays of a 341-frame slab at N = 256 (3.35 TB/s).  The gathers
// along the ray hit the frame's Z (256 KB at N = 256), which stays in L2.
// The design is the simple one: one thread per ray, early exit; threads
// of a warp whose rays stop at different steps idle until the longest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void march_kernel(const float* __restrict__ Z, const float* __restrict__ d,
                             const float* __restrict__ maxz, uint8_t* __restrict__ occ, int H, int W,
                             long long n, int max_steps) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const long long hw = (long long)H * W;
  const long long b = r / hw;
  const int cell = (int)(r - b * hw);
  const float* zb = Z + b * hw;
  const float mz = maxz[b];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float px = (float)(cell % W), py = (float)(cell / W), pz = zb[cell];
  uint8_t hit = 0;
  for (int i = 0; i < max_steps; ++i) {
    px += dx;
    py += dy;
    pz += dz;
    const float rx = rintf(px), ry = rintf(py);
    if (!(rx >= 0.0f && rx < (float)W && ry >= 0.0f && ry < (float)H && pz <= mz)) break;
    if (zb[(int)ry * W + (int)rx] >= pz) {
      hit = 1;
      break;
    }
  }
  occ[r] = hit;
}

}  // namespace

// Z (B, H, W) float32, d (B*H*W, 3) float32, maxz (B,) float32 -> occ
// (B, H, W) uint8.  Returns cudaGetLastError().
extern "C" int wass_visibility_march(const float* Z, const float* d, const float* maxz, uint8_t* occ, int B,
                                     int H, int W, int max_steps, cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    march_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(Z, d, maxz, occ, H, W, n, max_steps);
  }
  return (int)cudaGetLastError();
}
