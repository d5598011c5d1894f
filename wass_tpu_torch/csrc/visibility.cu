// The visibility of a frame slab toward a camera: each grid cell's
// incidence angle and whether its ray toward the camera meets the surface.
//
// Two entries:
//   wass_visibility_batch replaces the whole compiled program
//     wass_tpu/post/geometry.py:_visibility_device_batch (:94-170): each
//     frame's max z, the unit rays toward the camera, np.gradient's slopes,
//     the normals, the incidence angle, the ray steps and the ray march
//     (the lax.while_loop at :168), and occ = hit | incidence >= 88.
//   wass_visibility_march replaces the march alone of
//     _occlusion_device (:33, the loop at :68), whose rays come from the
//     caller (post/geometry.py:compute_occlusion_mask).
//
// The march, one ray (cell units; the JAX body's order):
//   px += dx; py += dy; pz += dz          (float32, accumulated step by step)
//   rx = rint(px); ry = rint(py)          (half to even, as jnp.round)
//   stop unless 0 <= rx < W, 0 <= ry < H and pz <= maxz[b]
//   stop, occluded, if Z[b, ry, rx] >= pz
// An inactive ray never changes its flag, so a ray that stops on its own
// gives the flag of the slab-wide `any(active)` stop.  The bounds are
// tested on the rounded floats: for a finite px that is the JAX test on the
// int32 index; a NaN px comes with a NaN pz, which the JAX test stops too.
// A NaN maxz (a frame with a hole: the max propagates NaN) stops every ray
// of the frame at its first step, and a ray from a NaN cell stops at once.
//
// Bit-equal to the plain version (post/visibility_kernels.py:
// visibility_batch_plain, op-by-op PyTorch on the card).  Every product,
// sum, quotient and square root is written with __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and __fsqrt_rn, so nvcc contracts no multiply-add
// (the file keeps nvcc's default -fmad, as PyTorch's own acosf was built).
// Every max, min and clamp returns NaN where torch.maximum and
// Tensor.clamp do (fmaxf and fminf would return the number).  The
// incidence is acosf (the CUDA math library's, no fast math, as
// torch.arccos) times (float)(180 / pi), the float32 factor PyTorch makes
// of the Python scalar.  The constants 1e-3 and 1e-12 are doubles rounded
// to float, as PyTorch rounds a clamp's scalar bound.
//
// Bound on the H100: bytes.  The batch must read Z (4 bytes a cell) and
// write occ (1) and inc (4): 9 bytes a cell, plus XX and YY once a slab,
// 0.060 ms for the 22.3M cells of a 341-frame slab at N = 256 (3.35 TB/s).
// The march's own work depends on the data: the steps the rays take, each
// a gather from L2 whose address needs the previous step's position but
// not its result.  On grazing slabs the steps, not the bytes, set the
// pace.  The design:
//   - One fused kernel: the rays, normals and steps live in registers and
//     shared memory, never in device memory.  A first small launch takes
//     each frame's max z (one block a frame), since every ray of a frame
//     needs it before it marches.
//   - A persistent grid (the occupancy query's blocks an SM x the SMs)
//     whose warps claim tiles of 8 x 32 cells in frame order from one
//     counter, so the frames in flight (256 KB each at N = 256, 1 MB at
//     N = 512) stay in the 50 MB L2, where the march's gathers land.
//   - A warp stages its tile of Z with a one-cell halo in its own shared
//     memory (16-byte loads where W % 4 == 0), reads XX and YY once, and
//     computes each cell's incidence (written at once, coalesced), step
//     direction and grazing flag, one column a lane.
//   - Lanes that refill: the tile's 256 rays are the warp's queue.  When a
//     lane's ray stops, the lane writes the ray's flag; once kRefillMin
//     lanes are idle (__ballot_sync finds them), they take the next rays
//     of the queue, in the order of their rank in the ballot.  Refilling
//     in groups keeps the gathers of a warp near each other: a group's
//     rays are neighbours that start together.  When the queue runs out,
//     the warp stages its next tile while its other lanes keep their rays
//     (a ray's state is in registers).  A warp runs until the slab's tiles
//     are gone, not until its longest ray ends, and no barrier holds one
//     warp for another.  A ray's result does not depend on the lane that
//     marched it.
//   - A ray takes kUnroll steps between refills, their gathers issued
//     together before the first is tested (the positions are added one
//     step at a time, as in the JAX loop; a gather past the stop is
//     unused), so a lane keeps kUnroll gathers in flight.  On the H100 a
//     refill after every stop and one step between refills marched 2-3x
//     slower than one thread a ray; groups of 8 and 8 steps beat it on
//     long marches (PERF.md §6).
//   - occ is written by the lane that ends the ray, one byte: a warp's
//     rays end near each other in the tile, and L2 merges the bytes into
//     sectors before they reach memory (staging them would hold a tile's
//     shared memory until its longest ray ends).
// The march-only entry runs the same refilling loop over all the slab's
// rays, 256 claimed at a time from a counter in device memory; its bound
// is Z 4 + d 12 + the flag 1 = 17 bytes a ray.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// A warp's tile: kTileH rows of kTileW = 32 cells, one column a lane.
constexpr int kTileH = 8, kTileW = 32;
constexpr int kCells = kTileH * kTileW;
// A staged row: the left halo at 3, the tile at [4, 4 + kTileW) (16-byte
// aligned for the vector stores), the right halo at 4 + kTileW.
constexpr int kRow = kTileW + 8;
constexpr int kUnroll = 8;       // steps a ray takes between two refills, their gathers in flight together
constexpr int kRefillMin = 8;    // idle lanes that make a warp refill (or none live)
constexpr int kSlabChunk = 256;  // rays a warp claims at a time in the march-only entry
constexpr float kDeg = (float)(180.0 / 3.141592653589793);

// torch.maximum, Tensor.clamp(min=lo) and Tensor.clamp(lo, hi): NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float clamp_min_nan(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }

struct Ray {
  const float* zb;  // the ray's frame
  float px, py, pz, dx, dy, dz, mz;
  long long id;   // where its result goes
  int i;          // steps taken
  bool graze;     // incidence >= 88: occluded whatever the march finds
};

// Up to kUnroll steps of a live ray: 0 while it goes on, 1 when it stops
// without meeting the surface (out of the grid, above maxz, or max_steps
// taken), 2 when it meets it.  The positions accumulate one step at a
// time as in the JAX loop; the gathers of all kUnroll steps are issued
// before the first is tested (a gather past the ray's stop is not used).
__device__ __forceinline__ int steps(Ray& r, int H, int W, int max_steps) {
  float x = r.px, y = r.py, h = r.pz;
  float zs[kUnroll], hs[kUnroll];
  unsigned inside = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    x += r.dx;
    y += r.dy;
    h += r.dz;
    const float rx = rintf(x), ry = rintf(y);
    hs[u] = h;
    zs[u] = 0.0f;
    if (rx >= 0.0f && rx < (float)W && ry >= 0.0f && ry < (float)H && h <= r.mz) {
      inside |= 1u << u;
      zs[u] = r.zb[(int)ry * W + (int)rx];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r.i >= max_steps) return 1;
    ++r.i;
    if (!((inside >> u) & 1u)) return 1;
    if (zs[u] >= hs[u]) return 2;
  }
  r.px = x;
  r.py = y;
  r.pz = h;
  return 0;
}

// One warp marches a queue of rays.  chunk(next, stop) hands the warp its
// next run of ray numbers [next, stop) (warp-wide; false when the queue
// is drained); each idle lane takes the next unclaimed ray of the run (its
// rank among the idle lanes), begin(k, ray) sets ray k up, end(ray, hit)
// takes its result.  Every warp-wide call runs in warp-uniform control flow.
template <class Chunk, class Begin, class End>
__device__ __forceinline__ void march_queue(int H, int W, int max_steps, Chunk chunk, Begin begin, End end) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int next = 0, stop = 0;  // the warp's run, the same in every lane
  bool drained = false, live = false;
  Ray ray;
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, !live);
    if (!drained && (__popc(idle) >= kRefillMin || idle == kFull)) {
      if (next >= stop) drained = !chunk(next, stop);
      if (!drained) {
        const int mine = next + __popc(idle & below);
        if (!live && mine < stop) {
          begin(mine, ray);
          live = true;
        }
        next = min(next + __popc(idle), stop);
      }
    }
    // With idle lanes and rays left, some lane took one: none live means
    // the queue is drained.
    if (__ballot_sync(kFull, live) == 0u) break;
    if (live) {
      const int s = steps(ray, H, W, max_steps);
      if (s != 0) {
        end(ray, s == 2);
        live = false;
      }
    }
  }
}

// Each frame's max z, NaN if the frame holds one (torch.amax); one block a frame.
__global__ void __launch_bounds__(kThreads) frame_max_kernel(const float* __restrict__ Z, float* __restrict__ maxz,
                                                             int hw, int vec) {
  const float* zb = Z + (long long)blockIdx.x * hw;
  float m = -INFINITY;
  if (vec) {
    const float4* z4 = reinterpret_cast<const float4*>(zb);
    for (int i = threadIdx.x; i < hw / 4; i += kThreads) {
      const float4 v = z4[i];
      m = max_nan(max_nan(max_nan(max_nan(m, v.x), v.y), v.z), v.w);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads) m = max_nan(m, zb[i]);
  }
  for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, o));
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, part[w]);
    maxz[blockIdx.x] = m;
  }
}

struct __align__(16) WarpTile {
  float z[(kTileH + 2) * kRow];  // Z with a one-cell halo
  float dx[kCells], dy[kCells], dz[kCells];  // the rays' steps
  uint8_t graze[kCells];  // incidence >= 88
};

__global__ void __launch_bounds__(kThreads) visibility_kernel(
    const float* __restrict__ Z, const float* __restrict__ cam, const float* __restrict__ XX,
    const float* __restrict__ YY, const float* __restrict__ maxz, uint8_t* __restrict__ occ,
    float* __restrict__ inc, unsigned* __restrict__ tile_counter, int B, int H, int W, int max_steps, int vec) {
  __shared__ WarpTile tiles[kThreads / 32];
  WarpTile& s = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long hw = (long long)H * W;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int per_frame = tiles_x * ((H + kTileH - 1) / kTileH);
  const unsigned n_tiles = (unsigned)B * per_frame;
  const float cam0 = cam[0], cam1 = cam[1], cam2 = cam[2];
  // The slopes' spacings, XX[0, 1] - XX[0, 0] and YY[1, 0] - YY[0, 0]: 0 on
  // the cube's own (count, X, Y) layout, whose slopes are then inf or NaN.
  const float ddx = __fsub_rn(XX[1], XX[0]), ddy = __fsub_rn(YY[W], YY[0]);
  const float clamp_z = (float)1e-3, clamp_d = (float)1e-12;
  // The warp's current tile.
  int y0 = 0, x0 = 0, tw = 0;
  const float* zb = Z;
  float mz = 0.0f;
  long long base = 0;  // the tile's frame offset

  // Claim the next tile in frame order, stage it, and compute each of its
  // cells' incidence (written now), step direction and grazing flag.
  auto chunk = [&](int& next, int& stop) -> bool {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(tile_counter, 1u);
    t = __shfl_sync(kFull, t, 0);
    if (t >= n_tiles) return false;
    const int b = (int)(t / per_frame), rem = (int)(t - (unsigned)b * per_frame);
    y0 = (rem / tiles_x) * kTileH;
    x0 = (rem % tiles_x) * kTileW;
    const int th = min(kTileH, H - y0);
    tw = min(kTileW, W - x0);
    base = b * hw;
    zb = Z + base;
    mz = maxz[b];
    __syncwarp();  // every lane is done with the previous tile's shared memory
    // Z and its halo; cells off the grid read 0 (never used).
    for (int i = lane; i < (kTileH + 2) * (kTileW / 4); i += 32) {
      const int row = i / (kTileW / 4), x = x0 + 4 * (i % (kTileW / 4)), y = y0 - 1 + row;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (y >= 0 && y < H) {
        const float* zr = zb + (long long)y * W;
        if (vec && x < W) {
          v = *reinterpret_cast<const float4*>(zr + x);
        } else {
          if (x < W) v.x = zr[x];
          if (x + 1 < W) v.y = zr[x + 1];
          if (x + 2 < W) v.z = zr[x + 2];
          if (x + 3 < W) v.w = zr[x + 3];
        }
      }
      *reinterpret_cast<float4*>(&s.z[row * kRow + 4 + (x - x0)]) = v;
    }
    if (lane < 2 * (kTileH + 2)) {
      const int row = lane >> 1, y = y0 - 1 + row, x = (lane & 1) ? x0 + kTileW : x0 - 1;
      s.z[row * kRow + ((lane & 1) ? 4 + kTileW : 3)] = (y >= 0 && y < H && x >= 0 && x < W)
                                                           ? zb[(long long)y * W + x] : 0.0f;
    }
    __syncwarp();
    // Lane l takes column l of every row.  The plain version's order:
    // post/visibility_kernels.py:visibility_batch_plain.
    if (lane < tw) {
      for (int r = 0; r < th; ++r) {
        const int y = y0 + r, x = x0 + lane, c = r * kTileW + lane;
        const float* zc = &s.z[(r + 1) * kRow + 4 + lane];
        const float z = zc[0];
        // _grad: central differences, one-sided at the borders.
        const float gx = x == W - 1 ? __fsub_rn(z, zc[-1])
                         : x == 0   ? __fsub_rn(zc[1], z)
                                    : __fmul_rn(__fsub_rn(zc[1], zc[-1]), 0.5f);
        const float gy = y == H - 1 ? __fsub_rn(z, zc[-kRow])
                         : y == 0   ? __fsub_rn(zc[kRow], z)
                                    : __fmul_rn(__fsub_rn(zc[kRow], zc[-kRow]), 0.5f);
        const float sx = __fdiv_rn(gx, ddx), sy = __fdiv_rn(gy, ddy);
        // normals = -[sx, sy, -1] / |[sx, sy, -1]|
        const float nn = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)), 1.0f));
        const float n0 = __fdiv_rn(-sx, nn), n1 = __fdiv_rn(-sy, nn), n2 = __fdiv_rn(1.0f, nn);
        // view_rays: [cam - XX, cam - YY, max(cam_z - Z, 1e-3)] / its norm
        const long long g = (long long)y * W + x;
        const float r0 = __fsub_rn(cam0, XX[g]), r1 = __fsub_rn(cam1, YY[g]);
        const float r2 = clamp_min_nan(__fsub_rn(cam2, z), clamp_z);
        const float rn = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)), __fmul_rn(r2, r2)));
        const float u0 = __fdiv_rn(r0, rn), u1 = __fdiv_rn(r1, rn), u2 = __fdiv_rn(r2, rn);
        const float cosv = clamp_nan(__fadd_rn(__fadd_rn(__fmul_rn(n0, u0), __fmul_rn(n1, u1)), __fmul_rn(n2, u2)),
                                     -1.0f, 1.0f);
        const float a = __fmul_rn(acosf(cosv), kDeg);
        inc[base + g] = a;
        // ray_steps: the larger horizontal component steps one cell.
        const float den = clamp_min_nan(max_nan(fabsf(u0), fabsf(u1)), clamp_d);
        s.dx[c] = __fdiv_rn(u0, den);
        s.dy[c] = __fdiv_rn(u1, den);
        s.dz[c] = __fdiv_rn(u2, den);
        s.graze[c] = a >= 88.0f;
      }
    }
    __syncwarp();
    next = 0;
    stop = th * tw;
    return true;
  };
  march_queue(
      H, W, max_steps, chunk,
      [&](int k, Ray& ray) {
        const int r = k / tw, col = k - r * tw, c = r * kTileW + col;
        ray.zb = zb;
        ray.mz = mz;
        ray.px = (float)(x0 + col);
        ray.py = (float)(y0 + r);
        ray.pz = s.z[(r + 1) * kRow + 4 + col];
        ray.dx = s.dx[c];
        ray.dy = s.dy[c];
        ray.dz = s.dz[c];
        ray.id = base + (long long)(y0 + r) * W + x0 + col;
        ray.i = 0;
        ray.graze = s.graze[c];
      },
      [&](const Ray& ray, bool hit) { occ[ray.id] = hit || ray.graze; });
}

__global__ void __launch_bounds__(kThreads) march_kernel(const float* __restrict__ Z, const float* __restrict__ d,
                                                         const float* __restrict__ maxz, uint8_t* __restrict__ occ,
                                                         unsigned long long* __restrict__ counter, int H, int W,
                                                         long long n, int max_steps) {
  const long long hw = (long long)H * W;
  long long first = 0;  // the warp's claimed run starts at ray `first`
  march_queue(
      H, W, max_steps,
      [&](int& next, int& stop) -> bool {
        unsigned long long b = 0;
        if ((threadIdx.x & 31) == 0) b = atomicAdd(counter, (unsigned long long)kSlabChunk);
        first = (long long)__shfl_sync(kFull, b, 0);
        if (first >= n) return false;
        next = 0;
        stop = (int)min((long long)kSlabChunk, n - first);
        return true;
      },
      [&](int k, Ray& ray) {
        const long long q = first + k, b = q / hw;
        const int cell = (int)(q - b * hw);
        ray.zb = Z + b * hw;
        ray.mz = maxz[b];
        ray.px = (float)(cell % W);
        ray.py = (float)(cell / W);
        ray.pz = ray.zb[cell];
        ray.dx = d[3 * q];
        ray.dy = d[3 * q + 1];
        ray.dz = d[3 * q + 2];
        ray.id = q;
        ray.i = 0;
        ray.graze = false;
      },
      [&](const Ray& ray, bool hit) { occ[ray.id] = hit; });
}

// Blocks of a persistent grid: as many as fit on the card at once, at most `work`.
template <class Kernel>
int persistent_blocks(Kernel kernel, long long work, int* err) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *err = (int)e;
  const long long blocks = (long long)(per_sm > 1 ? per_sm : 1) * (sms > 1 ? sms : 1);
  return (int)(blocks < work ? blocks : (work > 1 ? work : 1));
}

}  // namespace

// Z (B, H, W) float32 in cell units, cam (3,), XX and YY (H, W) float32 ->
// occ (B, H, W) uint8 and inc (B, H, W) float32 degrees.  maxz (B,) float32
// and counter (one uint32) are scratch.  H, W >= 2.  Returns a cudaError_t.
extern "C" int wass_visibility_batch(const float* Z, const float* cam, const float* XX, const float* YY,
                                     uint8_t* occ, float* inc, float* maxz, unsigned* counter, int B, int H, int W,
                                     int max_steps, cudaStream_t stream) {
  if ((long long)B * H * W == 0) return 0;
  const int vec = (W % 4 == 0) && ((uintptr_t)Z % 16 == 0);
  int err = (int)cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
  if (err) return err;
  frame_max_kernel<<<B, kThreads, 0, stream>>>(Z, maxz, H * W, vec);
  const long long tiles = (long long)B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  const int blocks = persistent_blocks(visibility_kernel, (tiles + kThreads / 32 - 1) / (kThreads / 32), &err);
  if (err) return err;
  visibility_kernel<<<blocks, kThreads, 0, stream>>>(Z, cam, XX, YY, maxz, occ, inc, counter, B, H, W, max_steps,
                                                     vec);
  return (int)cudaGetLastError();
}

// Z (B, H, W) float32, d (B*H*W, 3) float32, maxz (B,) float32 -> occ
// (B, H, W) uint8; counter (one uint64) is scratch.  Returns a cudaError_t.
extern "C" int wass_visibility_march(const float* Z, const float* d, const float* maxz, uint8_t* occ,
                                     unsigned long long* counter, int B, int H, int W, int max_steps,
                                     cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  int err = (int)cudaMemsetAsync(counter, 0, sizeof(unsigned long long), stream);
  if (err) return err;
  const int blocks = persistent_blocks(march_kernel, (n + kSlabChunk * (kThreads / 32) - 1) /
                                                         (kSlabChunk * (kThreads / 32)), &err);
  if (err) return err;
  march_kernel<<<blocks, kThreads, 0, stream>>>(Z, d, maxz, occ, counter, H, W, n, max_steps);
  return (int)cudaGetLastError();
}
