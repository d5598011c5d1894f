// Baseline JPEG encoding of up to eight uint8 images, (H, W) grey or
// (H, W, 3) RGB, in one call of four launches: the entropy-coded segment of
// each image, byte for byte as libjpeg-turbo writes it under OpenCV's
// settings (io/jpeg.py has the arithmetic and the plain version; the host
// adds the header and EOI).
//
// Replaces no Pallas kernel.  It replaces the host libjpeg call of
// io/image.py:encode_jpeg (cv2.imencode) for the stereo loop's debug
// renders, which the JAX package writes through imageio
// (wass_tpu/utils/render.py:21): there a writer fetched ~98 MB of uint8
// images a 5 MP frame and spent ~0.4 s in libjpeg on them.
//
// Bound on the H100: bytes.  Each image is read once and its stream
// written once: a 5 MP frame's six renders are 98.3 MB in and 1.6-10 MB of
// streams out, 30-32 us at 3.35 TB/s.  The DCTs' integer operations (16
// one-dimensional passes of 58 a block, ~845 k blocks) take ~12 us at the
// card's integer rate; the colour conversion, the quantisation and the two
// Huffman walks (lengths, then codes) add to them.  The work that does not
// parallelise in a sequential coder, each block's bit position and each
// 0xFF's stuffing, is two exclusive scans.  Measured on an H100 SXM at
// 700 W: 0.51-0.59 ms for those six renders, 0.33 ms of it the transform.
//
// Design.  (1) jpeg_transform: one thread a block, the work items of an
// image taken component by component (all Y blocks, then Cb, then Cr) so
// that a warp reads neighbouring pixels and runs one path; each thread
// converts (colour) and downsamples (chroma) its samples from the image,
// replicating the edges, runs the DCT and the quantisation in registers,
// and writes the zig-zag coefficients (int16, 128 bytes a block, in scan
// order), the quantised DC and the length of its AC codes.  A dummy block
// (an MCU's Y block past the image's blocks) computes the block whose DC
// it copies.  (Measured for a 5 MP frame's six renders on an H100 SXM at
// 700 W: recomputing the blocks in jpeg_emit in place of storing them,
// 0.91 ms against 0.59; loading each block's row segments with 16- and
// 8-byte loads in place of a byte a load, 0.64 against 0.59, the
// transform 0.39 against 0.33, so its byte loads do not bind it.)
// (2) jpeg_offsets: an exclusive scan, with decoupled look-back across
// tiles, of each block's bits (its AC length, and its
// DC difference's code from the DC of the block before it of the same
// component); it zeroes the stream words its tile covers and writes the
// image's bit count.  (3) jpeg_emit: each block writes its codes at its
// bit offset into 32-bit words, MSB first; a word shared with a
// neighbouring block takes atomicOr, the others a plain store; the last
// block pads to a byte with 1-bits.  (4) jpeg_stuff: 16 stream bytes a
// thread, the count of 0xFF bytes scanned with look-back, and the bytes
// scattered with a 0x00 after every 0xFF; it writes each image's byte
// count.  The scans run on persistent CTAs that claim tiles in order from
// a counter, so a tile's look-back waits only on tiles already claimed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxImages = 8;
constexpr int kThreads = 128;       // transform and emit: one thread a block
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;       // blocks a thread of jpeg_offsets
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kStuffThreads = 256;  // 16 stream bytes a thread of jpeg_stuff
constexpr int kStuffTileBytes = kStuffThreads * 16;
constexpr int kMaxBlockBits = 1660;  // DC 11 + 11 bits, 63 AC of 16 + 10
constexpr int kCbCrOffset = (128 << 16) + (1 << 15) - 1;
// Huffman entries (length << 16 | code) of the table buffer after the
// images' quantisation tables: DC luma, DC chroma (16 each), AC luma, AC
// chroma (256 each).
constexpr int kDcTab = 0;
constexpr int kAcTab = 32;
constexpr int kHuffWords = 32 + 512;

struct Img {
  const uint8_t* pix;
  long long word_base;  // the image's stream words, 16-byte aligned
  long long out_base;   // the image's stuffed bytes
  int H, W, ncomp, qt;  // qt: the image's 128 quantisation entries in the table buffer
  int mcu_cols, mcu_rows, nslots, idx;
  int slot_base, cta_base, scan_base, stuff_base;  // first block, CTA, scan tile and stuff tile
};

struct Plan {
  Img img[kMaxImages];
  int nimg, ctas, scan_tiles;
};

// The image whose range [first(i), first(i + 1)) holds x (first ascending).
template <typename F>
__device__ __forceinline__ int pick(const Plan& p, int x, F first) {
  int sel = 0;
#pragma unroll
  for (int i = 1; i < kMaxImages; ++i)
    if (i < p.nimg && x >= first(p.img[i])) sel = i;
  return sel;
}

__device__ __forceinline__ Img image_at(const Plan& p, int sel) {
  Img im = p.img[0];
#pragma unroll
  for (int i = 1; i < kMaxImages; ++i)
    if (sel == i) im = p.img[i];
  return im;
}

__device__ __forceinline__ int ycc(int r, int g, int b, int comp) {
  if (comp == 0) return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
  if (comp == 1) return (-11059 * r - 21709 * g + 32768 * b + kCbCrOffset) >> 16;
  return (32768 * r - 27439 * g - 5329 * b + kCbCrOffset) >> 16;
}

// A work item: the block (bx, by) of component comp, its slot in scan
// order, and whether it is a dummy block (then (bx, by) is its source).
struct Work {
  int slot, comp, bx, by;
  bool dummy;
};

__device__ __forceinline__ Work decode(const Img& im, int w) {
  Work k;
  k.dummy = false;
  if (im.ncomp == 1) {
    k.comp = 0;
    k.slot = w;
    k.bx = w % im.mcu_cols;
    k.by = w / im.mcu_cols;
    return k;
  }
  const int mcus = im.mcu_cols * im.mcu_rows;
  if (w < 4 * mcus) {
    const int ybw = 2 * im.mcu_cols;
    k.comp = 0;
    k.bx = w % ybw;
    k.by = w / ybw;
    k.slot = ((k.by >> 1) * im.mcu_cols + (k.bx >> 1)) * 6 + (k.by & 1) * 2 + (k.bx & 1);
    const int nbx = (im.W + 7) >> 3, nby = (im.H + 7) >> 3;
    if (k.bx >= nbx || k.by >= nby) {
      // Zeros with the DC of the last real block before it in the MCU
      // (jccoefct.c:compress_data): Y1 <- Y0, Y2 <- Y1, Y3 <- Y2.
      const bool y1 = (k.bx | 1) < nbx, y2 = (k.by | 1) < nby;
      const int p = (k.by & 1) * 2 + (k.bx & 1);
      const int src = (p == 3 && y2) ? 2 : (p >= 2 && y1) ? 1 : 0;
      k.bx = (k.bx & ~1) + (src & 1);
      k.by = (k.by & ~1) + (src >> 1);
      k.dummy = true;
    }
  } else {
    const int c = (w - 4 * mcus) / mcus, m = w - 4 * mcus - c * mcus;
    k.comp = 1 + c;
    k.bx = m % im.mcu_cols;
    k.by = m / im.mcu_cols;
    k.slot = m * 6 + 4 + c;
  }
  return k;
}

// The level-shifted samples of a block, edges replicated as libjpeg does.
__device__ __forceinline__ void load_samples(const Img& im, const Work& k, int (&s)[64]) {
  const int H = im.H, W = im.W;
  const uint8_t* __restrict__ pix = im.pix;
  if (im.ncomp == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint8_t* row = pix + (size_t)min(k.by * 8 + r, H - 1) * W;
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r * 8 + c] = (int)__ldg(row + min(k.bx * 8 + c, W - 1)) - 128;
    }
  } else if (k.comp == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint8_t* row = pix + (size_t)min(k.by * 8 + r, H - 1) * W * 3;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint8_t* q = row + 3 * min(k.bx * 8 + c, W - 1);
        s[r * 8 + c] = ycc(__ldg(q), __ldg(q + 1), __ldg(q + 2), 0) - 128;
      }
    }
  } else {
    // h2v2: rows padded to an even count, the last output row repeated;
    // columns replicated to ceil(W / 16) 16; bias 1, 2 along a row.
    const int last = ((H + 1) >> 1) - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r0 = 2 * min(k.by * 8 + j, last), r1 = min(r0 + 1, H - 1);
      const uint8_t* row0 = pix + (size_t)r0 * W * 3;
      const uint8_t* row1 = pix + (size_t)r1 * W * 3;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c0 = 3 * min(2 * (k.bx * 8 + i), W - 1), c1 = 3 * min(2 * (k.bx * 8 + i) + 1, W - 1);
        const int sum = ycc(__ldg(row0 + c0), __ldg(row0 + c0 + 1), __ldg(row0 + c0 + 2), k.comp) +
                        ycc(__ldg(row0 + c1), __ldg(row0 + c1 + 1), __ldg(row0 + c1 + 2), k.comp) +
                        ycc(__ldg(row1 + c0), __ldg(row1 + c0 + 1), __ldg(row1 + c0 + 2), k.comp) +
                        ycc(__ldg(row1 + c1), __ldg(row1 + c1 + 1), __ldg(row1 + c1 + 2), k.comp);
        s[j * 8 + i] = ((sum + 1 + (i & 1)) >> 2) - 128;
      }
    }
  }
}

// One pass of jfdctint.c:jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2).
template <bool kRows>
__device__ __forceinline__ void fdct8(int& x0, int& x1, int& x2, int& x3, int& x4, int& x5, int& x6, int& x7) {
  constexpr int n = kRows ? 11 : 15;
  constexpr int half = 1 << (n - 1);
  int tmp0 = x0 + x7, tmp7 = x0 - x7, tmp1 = x1 + x6, tmp6 = x1 - x6;
  int tmp2 = x2 + x5, tmp5 = x2 - x5, tmp3 = x3 + x4, tmp4 = x3 - x4;
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (kRows) {
    x0 = (tmp10 + tmp11) * 4;
    x4 = (tmp10 - tmp11) * 4;
  } else {
    x0 = (tmp10 + tmp11 + 2) >> 2;
    x4 = (tmp10 - tmp11 + 2) >> 2;
  }
  int z1 = (tmp12 + tmp13) * 4433;
  x2 = (z1 + tmp13 * 6270 + half) >> n;
  x6 = (z1 - tmp12 * 15137 + half) >> n;
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;
  tmp4 *= 2446;
  tmp5 *= 16819;
  tmp6 *= 25172;
  tmp7 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  x7 = (tmp4 + z1 + z3 + half) >> n;
  x5 = (tmp5 + z2 + z4 + half) >> n;
  x3 = (tmp6 + z2 + z3 + half) >> n;
  x1 = (tmp7 + z1 + z4 + half) >> n;
}

#define JPEG_ZIGZAG(X)                                                                      \
  X(0, 0) X(1, 1) X(2, 8) X(3, 16) X(4, 9) X(5, 2) X(6, 3) X(7, 10)                         \
  X(8, 17) X(9, 24) X(10, 32) X(11, 25) X(12, 18) X(13, 11) X(14, 4) X(15, 5)               \
  X(16, 12) X(17, 19) X(18, 26) X(19, 33) X(20, 40) X(21, 48) X(22, 41) X(23, 34)           \
  X(24, 27) X(25, 20) X(26, 13) X(27, 6) X(28, 7) X(29, 14) X(30, 21) X(31, 28)             \
  X(32, 35) X(33, 42) X(34, 49) X(35, 56) X(36, 57) X(37, 50) X(38, 43) X(39, 36)           \
  X(40, 29) X(41, 22) X(42, 15) X(43, 23) X(44, 30) X(45, 37) X(46, 44) X(47, 51)           \
  X(48, 58) X(49, 59) X(50, 52) X(51, 45) X(52, 38) X(53, 31) X(54, 39) X(55, 46)           \
  X(56, 53) X(57, 60) X(58, 61) X(59, 54) X(60, 47) X(61, 55) X(62, 62) X(63, 63)

// |x| / 8 q rounded half up, sign restored, with libjpeg-turbo's
// reciprocal (e: reciprocal | correction << 16 | shift << 27).
__device__ __forceinline__ int quantize(int x, uint32_t e) {
  const uint32_t a = (uint32_t)abs(x) + ((e >> 16) & 0x7FF);
  const int v = (int)((a * (e & 0xFFFF)) >> (e >> 27));
  return x < 0 ? -v : v;
}

// The quantised zig-zag coefficients of work item k (a dummy block's AC
// zeroed); q: the image's quantisation entries (luma, chroma; natural order).
__device__ __forceinline__ void block_coefs(const Img& im, const Work& k, const uint32_t* q, int (&zz)[64]) {
  int s[64];
  load_samples(im, k, s);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    fdct8<true>(s[r * 8], s[r * 8 + 1], s[r * 8 + 2], s[r * 8 + 3], s[r * 8 + 4], s[r * 8 + 5], s[r * 8 + 6],
                s[r * 8 + 7]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    fdct8<false>(s[c], s[8 + c], s[16 + c], s[24 + c], s[32 + c], s[40 + c], s[48 + c], s[56 + c]);
  const uint32_t* t = q + (k.comp ? 64 : 0);
#define JPEG_QUANT(z, n) zz[z] = quantize(s[n], t[n]);
  JPEG_ZIGZAG(JPEG_QUANT)
#undef JPEG_QUANT
  if (k.dummy) {
#pragma unroll
    for (int i = 1; i < 64; ++i) zz[i] = 0;
  }
}

__device__ __forceinline__ int nbits(int v) { return 32 - __clz(abs(v)); }

// The slot of the block that predicts slot's DC (-1: none) and its table.
__device__ __forceinline__ int prev_slot(const Img& im, int slot, int& table) {
  if (im.ncomp == 1) {
    table = 0;
    return slot - 1;
  }
  const int pos = slot % 6;
  table = pos >= 4;
  if (pos >= 1 && pos <= 3) return slot - 1;
  if (slot < 6) return -1;
  return pos == 0 ? slot - 3 : slot - 6;
}

// Block-wide exclusive sum of v; total receives the block's sum.
template <int kT>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t& total, uint32_t* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kT / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kT / 32) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[kT / 32 - 1];
  const uint32_t out = (warp ? s_warp[warp - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

// Decoupled look-back (one thread): publishes the tile's aggregate, sums
// the predecessors' back to the first inclusive prefix, publishes the
// tile's own; returns the exclusive prefix.  A state is (flag << 32 |
// value), flag 1 an aggregate, 2 an inclusive prefix, 0 not yet written.
__device__ uint32_t lookback(unsigned long long* states, int tile, uint32_t agg) {
  volatile unsigned long long* st = states;
  if (tile == 0) {
    st[0] = (2ull << 32) | agg;
    return 0;
  }
  st[tile] = (1ull << 32) | agg;
  uint32_t prefix = 0;
  for (int i = tile - 1;; --i) {
    unsigned long long s;
    do {
      s = st[i];
    } while ((s >> 32) == 0);
    prefix += (uint32_t)s;
    if ((s >> 32) == 2) break;
  }
  st[tile] = (2ull << 32) | (prefix + agg);
  return prefix;
}

__global__ void __launch_bounds__(kThreads) jpeg_transform(const __grid_constant__ Plan p, const uint32_t* __restrict__ tables,
                                                          int hoff, int16_t* __restrict__ coefs,
                                                          int* __restrict__ dc, int* __restrict__ aclen) {
  __shared__ uint32_t s_q[128];
  __shared__ uint8_t s_len[2][256];
  const Img im = image_at(p, pick(p, (int)blockIdx.x, [](const Img& m) { return m.cta_base; }));
  for (int i = threadIdx.x; i < 128; i += kThreads) s_q[i] = tables[im.qt + i];
  for (int i = threadIdx.x; i < 512; i += kThreads) s_len[i >> 8][i & 255] = tables[hoff + kAcTab + i] >> 16;
  __syncthreads();
  const int w = ((int)blockIdx.x - im.cta_base) * kThreads + threadIdx.x;
  if (w >= im.nslots) return;
  const Work k = decode(im, w);
  int zz[64];
  block_coefs(im, k, s_q, zz);
  const uint8_t* len = s_len[k.comp ? 1 : 0];
  int bits = 0, run = 0;
#pragma unroll
  for (int i = 1; i < 64; ++i) {
    if (zz[i]) {
      const int nb = nbits(zz[i]);
      bits += (run >> 4) * len[0xF0] + len[(run & 15) << 4 | nb] + nb;
      run = 0;
    } else {
      ++run;
    }
  }
  if (run) bits += len[0];
  const long long g = im.slot_base + k.slot;
  dc[g] = zz[0];
  aclen[g] = bits;
  uint4* o = reinterpret_cast<uint4*>(coefs + g * 64);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      u[h] = (uint32_t)(uint16_t)zz[8 * j + 2 * h] | (uint32_t)(uint16_t)zz[8 * j + 2 * h + 1] << 16;
    o[j] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__global__ void __launch_bounds__(kScanThreads) jpeg_offsets(const __grid_constant__ Plan p, const uint32_t* __restrict__ tables,
                                                            int hoff, const int* __restrict__ dc,
                                                            const int* __restrict__ aclen, uint32_t* __restrict__ off,
                                                            uint32_t* __restrict__ words, uint32_t* __restrict__ nbits_out,
                                                            unsigned long long* states, unsigned int* counter) {
  __shared__ uint8_t s_dclen[32];
  __shared__ uint32_t s_warp[kScanThreads / 32];
  __shared__ uint32_t s_prefix;
  __shared__ int s_tile;
  if (threadIdx.x < 32) s_dclen[threadIdx.x] = tables[hoff + kDcTab + threadIdx.x] >> 16;
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
    __syncthreads();
    const int t = s_tile;
    if (t >= p.scan_tiles) return;
    const Img im = image_at(p, pick(p, t, [](const Img& m) { return m.scan_base; }));
    const int tile = t - im.scan_base;
    const int s0 = tile * kScanTile + threadIdx.x * kScanItems;
    uint32_t len[kScanItems];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int slot = s0 + j;
      len[j] = 0;
      if (slot < im.nslots) {
        int table;
        const int prev = prev_slot(im, slot, table);
        const int d = dc[im.slot_base + slot] - (prev >= 0 ? dc[im.slot_base + prev] : 0);
        const int nb = nbits(d);
        len[j] = aclen[im.slot_base + slot] + s_dclen[table * 16 + nb] + nb;
      }
      sum += len[j];
    }
    uint32_t total;
    const uint32_t excl = block_exclusive_scan<kScanThreads>(sum, total, s_warp);
    if (threadIdx.x == 0) s_prefix = lookback(states + im.scan_base, tile, total);
    __syncthreads();
    const uint32_t base = s_prefix;
    uint32_t o = base + excl;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (s0 + j < im.nslots) off[im.slot_base + s0 + j] = o;
      o += len[j];
    }
    uint32_t* wd = words + im.word_base;
    for (uint32_t i = (base >> 5) + threadIdx.x; i <= (base + total - 1) >> 5; i += kScanThreads) wd[i] = 0;
    if (threadIdx.x == 0 && (tile + 1) * kScanTile >= im.nslots) nbits_out[im.idx] = base + total;
    __syncthreads();
  }
}

// Appends codes MSB first at a bit position of a word buffer whose words
// were zeroed: the first and the last word it touches may be shared with
// the neighbouring blocks and take atomicOr; the ones between are its own.
struct BitWriter {
  uint32_t* words;
  unsigned long long acc;  // the pending bits, right-aligned
  int n;                   // pending bits, < 32 between calls (the leading ones the start's offset in its word)
  uint32_t wi, pos;
  bool first;

  __device__ BitWriter(uint32_t* w, uint32_t start) : words(w), acc(0), n(start & 31), wi(start >> 5), pos(start),
                                                       first(true) {}

  __device__ __forceinline__ void put(uint32_t bits, int len) {  // len <= 27
    acc = (acc << len) | bits;
    n += len;
    pos += len;
    if (n >= 32) {
      n -= 32;
      const uint32_t word = (uint32_t)(acc >> n);
      if (first) {
        atomicOr(words + wi, word);
        first = false;
      } else {
        words[wi] = word;
      }
      ++wi;
      acc &= (1ull << n) - 1;
    }
  }

  __device__ __forceinline__ void finish() {
    if (n > 0) atomicOr(words + wi, (uint32_t)(acc << (32 - n)));
  }
};

__global__ void __launch_bounds__(kThreads) jpeg_emit(const __grid_constant__ Plan p, const uint32_t* __restrict__ tables,
                                                     int hoff, const int16_t* __restrict__ coefs,
                                                     const int* __restrict__ dc, const uint32_t* __restrict__ off,
                                                     uint32_t* __restrict__ words) {
  __shared__ uint32_t s_huff[kHuffWords];
  const Img im = image_at(p, pick(p, (int)blockIdx.x, [](const Img& m) { return m.cta_base; }));
  for (int i = threadIdx.x; i < kHuffWords; i += kThreads) s_huff[i] = tables[hoff + i];
  __syncthreads();
  const int w = ((int)blockIdx.x - im.cta_base) * kThreads + threadIdx.x;
  if (w >= im.nslots) return;
  const Work k = decode(im, w);
  const long long g = im.slot_base + k.slot;
  int zz[64];
  const uint4* src = reinterpret_cast<const uint4*>(coefs + g * 64);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 v = src[j];
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      zz[8 * j + 2 * h] = (int16_t)(u[h] & 0xFFFF);
      zz[8 * j + 2 * h + 1] = (int16_t)(u[h] >> 16);
    }
  }
  int table;
  const int prev = prev_slot(im, k.slot, table);
  const int d = dc[g] - (prev >= 0 ? dc[im.slot_base + prev] : 0);
  BitWriter bw(words + im.word_base, off[g]);
  {
    const int nb = nbits(d);
    const uint32_t e = s_huff[kDcTab + table * 16 + nb];
    bw.put((e & 0xFFFF) << nb | ((uint32_t)(d < 0 ? d - 1 : d) & ((1u << nb) - 1)), (int)(e >> 16) + nb);
  }
  const uint32_t* ac = s_huff + kAcTab + table * 256;
  int run = 0;
#pragma unroll
  for (int i = 1; i < 64; ++i) {
    const int v = zz[i];
    if (v) {
      for (; run > 15; run -= 16) bw.put(ac[0xF0] & 0xFFFF, (int)(ac[0xF0] >> 16));
      const int nb = nbits(v);
      const uint32_t e = ac[run << 4 | nb];
      bw.put((e & 0xFFFF) << nb | ((uint32_t)(v < 0 ? v - 1 : v) & ((1u << nb) - 1)), (int)(e >> 16) + nb);
      run = 0;
    } else {
      ++run;
    }
  }
  if (run) bw.put(ac[0] & 0xFFFF, (int)(ac[0] >> 16));
  if (k.slot == im.nslots - 1) {
    const int pad = (8 - (int)(bw.pos & 7)) & 7;  // the last byte's 1-bits
    if (pad) bw.put((1u << pad) - 1, pad);
  }
  bw.finish();
}

__global__ void __launch_bounds__(kStuffThreads) jpeg_stuff(const __grid_constant__ Plan p, const uint32_t* __restrict__ words,
                                                           const uint32_t* __restrict__ nbits_in,
                                                           uint8_t* __restrict__ out, uint32_t* __restrict__ counts,
                                                           unsigned long long* states, unsigned int* counter) {
  __shared__ int s_first[kMaxImages + 1];
  __shared__ uint32_t s_bytes[kMaxImages];
  __shared__ uint32_t s_warp[kStuffThreads / 32];
  __shared__ uint32_t s_prefix;
  __shared__ int s_tile;
  if (threadIdx.x == 0) {
    int first = 0;
    for (int i = 0; i < p.nimg; ++i) {
      s_bytes[i] = (nbits_in[i] + 7) >> 3;
      s_first[i] = first;
      first += (int)((s_bytes[i] + kStuffTileBytes - 1) / kStuffTileBytes);
    }
    s_first[p.nimg] = first;
  }
  __syncthreads();
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
    __syncthreads();
    const int t = s_tile;
    if (t >= s_first[p.nimg]) return;
    int sel = 0;
    for (int i = 1; i < p.nimg; ++i)
      if (t >= s_first[i]) sel = i;
    const Img im = image_at(p, sel);
    const uint32_t nbytes = s_bytes[sel];
    const int tile = t - s_first[sel];
    const uint32_t b0 = (uint32_t)tile * kStuffTileBytes + threadIdx.x * 16;
    uint32_t wv[4] = {0, 0, 0, 0};
    if (b0 < nbytes) {
      const uint4 v = reinterpret_cast<const uint4*>(words + im.word_base)[b0 >> 4];
      wv[0] = v.x;
      wv[1] = v.y;
      wv[2] = v.z;
      wv[3] = v.w;
    }
    uint32_t ff = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      ff += (b0 + j < nbytes && ((wv[j >> 2] >> (24 - 8 * (j & 3))) & 0xFF) == 0xFF);
    uint32_t total;
    const uint32_t excl = block_exclusive_scan<kStuffThreads>(ff, total, s_warp);
    if (threadIdx.x == 0) s_prefix = lookback(states + im.stuff_base, tile, total);
    __syncthreads();
    uint8_t* o = out + im.out_base + b0 + s_prefix + excl;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (b0 + j < nbytes) {
        const uint8_t b = (wv[j >> 2] >> (24 - 8 * (j & 3))) & 0xFF;
        *o++ = b;
        if (b == 0xFF) *o++ = 0;
      }
    }
    if (threadIdx.x == 0 && (uint32_t)(tile + 1) * kStuffTileBytes >= nbytes) counts[sel] = nbytes + s_prefix + total;
    __syncthreads();
  }
}

}  // namespace

// host: 8 int64 an image: pixels, H, W, components (1 or 3), the offset of
// its 128 quantisation entries in tables, its first stream word (a
// multiple of 4), its stream words (a multiple of 4, at least the worst
// case's), its first output byte.  tables: those entries, then the Huffman
// entries at hoff.  coefs 64 int16 a block; dc, aclen, off one int32 a
// block; nbits and counts one
// uint32 an image; states nstates uint64 of scratch (zeroed here).
extern "C" int wass_jpeg_encode(const long long* host, int nimg, const void* tables, int hoff, void* coefs, void* dc,
                                void* aclen, void* off, void* words, void* out, void* nbits, void* counts, void* states,
                                long long nstates, void* stream) {
  if (nimg < 1 || nimg > kMaxImages || host == nullptr || tables == nullptr || hoff < 0 || coefs == nullptr)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  int slots = 0, ctas = 0, scan = 0, stuff = 0;
  for (int i = 0; i < nimg; ++i) {
    const long long* h = host + 8 * i;
    Img& im = p.img[i];
    im.pix = reinterpret_cast<const uint8_t*>(h[0]);
    if (im.pix == nullptr || h[1] < 1 || h[1] > 65535 || h[2] < 1 || h[2] > 65535 || (h[3] != 1 && h[3] != 3) ||
        h[4] < 0 || h[5] < 0 || h[5] % 4 != 0 || h[6] % 4 != 0 || h[7] < 0)
      return (int)cudaErrorInvalidValue;
    im.H = (int)h[1];
    im.W = (int)h[2];
    im.ncomp = (int)h[3];
    im.qt = (int)h[4];
    im.word_base = h[5];
    im.out_base = h[7];
    const int mcu = im.ncomp == 1 ? 8 : 16;
    im.mcu_cols = (im.W + mcu - 1) / mcu;
    im.mcu_rows = (im.H + mcu - 1) / mcu;
    const long long nslots = (long long)im.mcu_cols * im.mcu_rows * (im.ncomp == 1 ? 1 : 6);
    if (h[6] * 32 < nslots * kMaxBlockBits + 7 || h[6] * 32 > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
    im.nslots = (int)nslots;
    im.idx = i;
    im.slot_base = slots;
    im.cta_base = ctas;
    im.scan_base = scan;
    im.stuff_base = stuff;
    slots += im.nslots;
    ctas += (im.nslots + kThreads - 1) / kThreads;
    scan += (im.nslots + kScanTile - 1) / kScanTile;
    stuff += (int)((h[6] * 4 + kStuffTileBytes - 1) / kStuffTileBytes);
  }
  p.nimg = nimg;
  p.ctas = ctas;
  p.scan_tiles = scan;
  // states: the two tile counters, then the scan's tile states, then the stuffing's.
  const long long need = 2 + scan + stuff;
  if (nstates < need) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaMemsetAsync(states, 0, need * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* s = (unsigned long long*)states;
  unsigned int* scan_counter = (unsigned int*)s;
  unsigned int* stuff_counter = (unsigned int*)(s + 1);
  const uint32_t* tb = (const uint32_t*)tables;
  jpeg_transform<<<ctas, kThreads, 0, st>>>(p, tb, hoff, (int16_t*)coefs, (int*)dc, (int*)aclen);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_offsets<<<min(scan, 4 * sms), kScanThreads, 0, st>>>(p, tb, hoff, (const int*)dc, (const int*)aclen,
                                                            (uint32_t*)off, (uint32_t*)words, (uint32_t*)nbits,
                                                            s + 2, scan_counter);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_emit<<<ctas, kThreads, 0, st>>>(p, tb, hoff, (const int16_t*)coefs, (const int*)dc, (const uint32_t*)off,
                                       (uint32_t*)words);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_stuff<<<min(stuff, 4 * sms), kStuffThreads, 0, st>>>(p, (const uint32_t*)words, (const uint32_t*)nbits,
                                                            (uint8_t*)out, (uint32_t*)counts, s + 2 + scan,
                                                            stuff_counter);
  return (int)cudaGetLastError();
}
