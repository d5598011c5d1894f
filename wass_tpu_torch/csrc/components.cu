// K7: connected-component labels by segmented min-label propagation.
//
// Replaces wass_tpu/ops/components_pallas.py:label_components_pallas
// (_prop_pair / _prop_kernel).  One round is a vertical pass then a
// horizontal pass; each pass computes, along every column (row), the
// segmented running minimum of the labels forward and backward and keeps
// min(fwd, bwd).  connect[i] says element i joins its predecessor in the
// forward walk; the backward walk joins i to i+1 through connect[i+1].
//
// min(fwd[i], bwd[i]) is the minimum over the whole segment that holds i,
// which is also the backward segmented running minimum of fwd.  So a pass
// is two segmented scans, the second over the first's output, and each is
// a chunked parallel scan with the associative operator
//   (v1, c1) + (v2, c2) = (c2 ? min(v1, v2) : v2, c1 && c2)
// (integer min: any grouping gives the bits of the serial walk):
//   1. every thread reduces a short chunk of one line serially;
//   2. the block scans the chunk totals in shared memory (Hillis-Steele);
//   3. every thread walks its chunk again from its carry-in and writes fwd
//      in place, reducing the chunk for the backward scan on the way;
//   4. the block scans those totals from the other end;
//   5. every thread walks its chunk backward and writes the segment minima.
// A block owns whole lines, and a thread reads and writes only its own
// chunk, so the pass updates the labels in place with no scratch.
//   Column pass: a block is 8 adjacent columns x 128 chunks; a warp reads
//     8 columns (one 32-byte sector) of 4 rows at a time.
//   Row pass: a block is one row x 256 chunks; a thread moves 4 labels
//     with one 16-byte load or store and 4 connect bytes with one 4-byte
//     load when the width is a multiple of 4.
// At 2048x1536 that is 256 and 1536 blocks of 1024 and 256 threads, with
// chunks of 12 and 8 elements.
//
// Exact early exit: the round function depends on the labels alone (the
// connectivity is fixed), so once a round changes nothing no later round
// does.  Each pass of round r sets changed[r] when it writes a label other
// than the one it read; every launch of round r >= 1 returns at once when
// changed[r - 1] is 0.  All 2 * rounds launches stay queued and the host
// reads no flag.
//
// Bound on the H100: bytes.  A pass must read 4 bytes of label and 1 of
// connectivity and write 4 bytes of label per pixel: 28 MB a pass at
// 2048x1536, 48 passes for 24 rounds, 0.40 ms at 3.35 TB/s.  Phases 3 and
// 5 read the chunk again (L1 hits).  The labels and both connectivity
// masks (19 MB at 2048x1536) fit in the 50 MB L2, so after the first pass
// the passes run mostly from L2; the design is right without that, only
// slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kColLines = 8;     // columns per block in the column pass
constexpr int kColChunks = 128;  // chunks per column
constexpr int kRowChunks = 256;  // chunks per row

// Four consecutive elements of a line from i0 (a multiple of 4): labels
// and connect flags, 0 past the end n.  VEC: one 16-byte and one 4-byte
// load (unit element stride, aligned, n % 4 == 0).
template <bool VEC>
__device__ __forceinline__ void load_quad(const int* lab, const uint8_t* conn, size_t base, size_t es, int i0,
                                          int n, int (&l)[4], int (&c)[4]) {
  if constexpr (VEC) {
    const int4 v = *reinterpret_cast<const int4*>(lab + base + i0);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(conn + base + i0);
    l[0] = v.x, l[1] = v.y, l[2] = v.z, l[3] = v.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] = (w >> (8 * q)) & 0xff;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = i0 + q < n;
      l[q] = in ? lab[base + (size_t)(i0 + q) * es] : kInf;
      c[q] = in ? conn[base + (size_t)(i0 + q) * es] : 0;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_quad(int* lab, size_t base, size_t es, int i0, int e, const int (&l)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<int4*>(lab + base + i0) = make_int4(l[0], l[1], l[2], l[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i0 + q < e) lab[base + (size_t)(i0 + q) * es] = l[q];
  }
}

// The carry into this thread's chunk: the segmented-min scan of the chunk
// totals (v, c) of its line, exclusive, from chunk 0 up (or from the last
// chunk down when reverse).  Chunks are threadIdx.y, lines threadIdx.x.
// sv and sc hold 2 * G * Y ints each.  Every thread of the block calls it.
template <int G, int Y>
__device__ int block_carry(int v, int c, bool reverse, int* sv, int* sc) {
  const int g = threadIdx.x, k = threadIdx.y;
  constexpr int kN = G * Y;
  int cur = 0;
  sv[k * G + g] = v;
  sc[k * G + g] = c;
#pragma unroll
  for (int d = 1; d < Y; d <<= 1) {
    __syncthreads();
    const int src = reverse ? k + d : k - d;
    int nv = sv[cur * kN + k * G + g], nc = sc[cur * kN + k * G + g];
    if (src >= 0 && src < Y) {
      const int pv = sv[cur * kN + src * G + g], pc = sc[cur * kN + src * G + g];
      nv = nc ? min(pv, nv) : nv;
      nc = pc & nc;
    }
    sv[(cur ^ 1) * kN + k * G + g] = nv;
    sc[(cur ^ 1) * kN + k * G + g] = nc;
    cur ^= 1;
  }
  __syncthreads();
  const int src = reverse ? k + 1 : k - 1;
  const int carry = src >= 0 && src < Y ? sv[cur * kN + src * G + g] : kInf;
  __syncthreads();  // the buffers are reused by the next scan
  return carry;
}

// One pass of round `round` over nlines lines of n elements: element i of
// line L is at L * ls + i * es.  Chunks hold c elements (a multiple of 4).
template <int G, int Y, bool VEC>
__global__ void __launch_bounds__(G * Y)
propagate_pass(int* __restrict__ lab, const uint8_t* __restrict__ conn, int* __restrict__ changed, int round,
               int n, int nlines, int es, int ls, int c) {
  if (round > 0 && changed[round - 1] == 0) return;  // the whole block leaves together
  __shared__ int sv[2 * G * Y], sc[2 * G * Y];
  const int line = blockIdx.x * G + threadIdx.x;
  const size_t base = (size_t)(line < nlines ? line : 0) * ls;
  const int s = threadIdx.y * c;
  const int e = line < nlines ? min(s + c, n) : 0;  // the chunk is [s, e), empty past the line
  const size_t step = es;

  // 1. The chunk's forward total: (running min at its end, all joined).
  int v = kInf, all = 1;
  for (int i0 = s; i0 < e; i0 += 4) {
    int l[4], cn[4];
    load_quad<VEC>(lab, conn, base, step, i0, n, l, cn);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < e) {
        v = cn[q] ? min(l[q], v) : l[q];
        all &= cn[q] != 0;
      }
    }
  }
  // 2-3. Forward scan from the carry, written in place; on the way, the
  // chunk's backward total over fwd: the minimum up to the first element
  // that does not join its successor, and whether there is none.
  int f = block_carry<G, Y>(v, all, false, sv, sc);
  int bv = kInf, bopen = 1;
  bool moved = false;
  for (int i0 = s; i0 < e; i0 += 4) {
    int l[4], cn[4];
    load_quad<VEC>(lab, conn, base, step, i0, n, l, cn);
    const int next = i0 + 4 < n ? conn[base + (size_t)(i0 + 4) * step] : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < e) {
        f = cn[q] ? min(l[q], f) : l[q];
        moved |= f != l[q];
        l[q] = f;
        if (bopen) bv = min(bv, f);
        if (!(q < 3 ? cn[q + 1] : next)) bopen = 0;
      }
    }
    store_quad<VEC>(lab, base, step, i0, e, l);
  }
  // 4-5. Backward scan over fwd from the carry of the chunks after this one.
  int b = block_carry<G, Y>(bv, bopen, true, sv, sc);
  if (e > s) {
    for (int i0 = s + (e - s - 1) / 4 * 4; i0 >= s; i0 -= 4) {
      int l[4], cn[4];
      load_quad<VEC>(lab, conn, base, step, i0, n, l, cn);
      const int next = i0 + 4 < n ? conn[base + (size_t)(i0 + 4) * step] : 0;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        if (i0 + q < e) {
          b = (q < 3 ? cn[q + 1] : next) ? min(l[q], b) : l[q];
          moved |= b != l[q];
          l[q] = b;
        }
      }
      store_quad<VEC>(lab, base, step, i0, e, l);
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0 && threadIdx.y == 0) changed[round] = 1;
}

// Elements per chunk: the line split over `chunks` threads, rounded up to
// a multiple of 4.
int chunk_len(int n, int chunks) { return ((n + chunks - 1) / chunks + 3) / 4 * 4; }

}  // namespace

// labels: (H, W) int32, updated in place (initial labels in, final out);
// conn_v[y, x]: (y, x) joins (y-1, x); conn_h[y, x]: (y, x) joins (y, x-1);
// changed: (rounds,) int32, zero on entry; changed[r] is 1 after the call
// when round r changed a label (round r ran only if changed[r - 1] was 1).
extern "C" int wass_label_propagate(void* labels, const void* conn_v, const void* conn_h, void* changed, int H,
                                    int W, int rounds, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* lab = (int*)labels;
  int* flags = (int*)changed;
  const bool vec = W % 4 == 0 && (uintptr_t)labels % 16 == 0 && (uintptr_t)conn_h % 4 == 0;
  const int col_c = chunk_len(H, kColChunks), row_c = chunk_len(W, kRowChunks);
  const dim3 col_grid((W + kColLines - 1) / kColLines), col_block(kColLines, kColChunks);
  const dim3 row_grid(H), row_block(1, kRowChunks);
  for (int r = 0; r < rounds; ++r) {
    propagate_pass<kColLines, kColChunks, false>
        <<<col_grid, col_block, 0, s>>>(lab, (const uint8_t*)conn_v, flags, r, H, W, W, 1, col_c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (vec)
      propagate_pass<1, kRowChunks, true>
          <<<row_grid, row_block, 0, s>>>(lab, (const uint8_t*)conn_h, flags, r, W, H, 1, W, row_c);
    else
      propagate_pass<1, kRowChunks, false>
          <<<row_grid, row_block, 0, s>>>(lab, (const uint8_t*)conn_h, flags, r, W, H, 1, W, row_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
