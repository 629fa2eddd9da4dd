// K11: baseline JPEG encoding of an RGB uint8 frame, byte-equal to
// libjpeg(-turbo) at PIL's defaults (Image.save(format="JPEG", quality=q):
// 4:2:0, the integer DCT, the standard Huffman tables, no restart interval).
//
// Replaces no Pallas kernel: it stands in for the JAX package's host encode
// by PIL, easygaussiansplatting_tpu/viewer/server.py:299 `_encode` (also
// viewer/monitor.py:69 and the root sh_demo.py:190), so that a frame
// rendered on the card leaves it as compressed bytes. Plain version:
// utils/jpeg.py::encode_jpeg_plain, whose stages (and their libjpeg
// routines) these kernels follow step for step; the bytes are equal.
//
// What bounds it on an H100: bytes, and far below what launches cost. At
// 979x546 the frame is 1.60 MB, the coefficients 13,020 blocks x 128 B
// written once and read twice, the packed and the stuffed scan a few
// hundred KB: about 6.6 MB, 2 us at 3.35 TB/s, against six launches and
// three memsets. The design is the simple one that is right; making it fast
// is later work.
//   (a) jpeg_blocks_kernel: a CTA an MCU (16x16 pixels, 256 threads). Each
//       thread converts one pixel to Y (jccolor.c rgb_ycc_convert, 16-bit
//       fixed point); 64 threads convert and average a 2x2 cell each for Cb
//       and Cr (jcsample.c h2v2_downsample, bias 1, 2 along a row). Reads
//       past the frame are clamped to its last row and column, as
//       expand_right_edge and jcprepct.c's bottom padding replicate them;
//       chroma rows past ceil(H/2) repeat the last chroma row. Then the
//       islow DCT (jfdctint.c) in shared memory, a thread a row of a block,
//       then a thread a column; the quantiser (jcdctmgr.c: divisor 8 x the
//       table entry, half away from zero); the dummy blocks of a partial
//       MCU (jccoefct.c compress_data: AC zero, DC of the block before);
//       and int16 zigzag coefficients [n_mcu][6][64] out, blocks Y00, Y01,
//       Y10, Y11, Cb, Cr.
//   (b) jpeg_lengths_kernel: a warp a block computes the block's Huffman
//       bits (jchuff.c encode_one_block): lane l codes positions l and
//       l + 32; the DC difference against the previous block of its
//       component in scan order; each nonzero AC's zero run from a 64-bit
//       ballot of the nonzero mask (ZRLs, the (run, size) code, the
//       magnitude bits), EOB when the block ends in zeros. A token is at
//       most 59 bits (3 ZRLs of 11, a 16-bit code, 10 magnitude bits).
//   K3 (csrc/scan.cu, from the wrapper) turns the lengths into bit offsets.
//   (c) jpeg_pack_kernel, launched cooperatively (every CTA resident): each
//       warp recomputes its block's tokens, places them at the block's
//       offset plus a warp scan of the lanes' lengths, and ORs them into a
//       zeroed buffer of 32-bit words, MSB first (atomicOr: a word may hold
//       bits of several blocks; the bits are disjoint, so the order does
//       not matter). The last block also sets the padding 1-bits up to the
//       byte boundary (flush_bits). After a grid barrier each CTA counts the
//       0xFF bytes of a 1,024-byte chunk.
//   K3 turns the chunk counts into stuffing offsets.
//   (d) jpeg_stuff_kernel: a CTA a chunk writes its bytes (big-endian within
//       each word) at their stuffed positions, a 0x00 after every 0xFF, and
//       CTA 0 writes the scan's stuffed length.
// The host adds the headers and EOI (utils/jpeg.py) and reads the length
// once before it copies that many bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_MCU = 6;
constexpr int MCU_COEFS = BLOCKS_PER_MCU * 64;
// A block's Huffman bits are at most 22 (DC) + 63 x 26 (AC) = 1,660.
constexpr int MAX_BLOCK_BITS = 1700;
constexpr int CHUNK_WORDS = THREADS;  // a stuffing chunk: 256 words, 1,024 bytes
constexpr unsigned FULL = 0xffffffffu;

// jpeg_natural_order: the natural index of zigzag position k
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jccolor.c: SCALEBITS 16, FIX(x) = (x * 2^16 + 0.5) truncated
constexpr int SCALEBITS = 16;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);
constexpr int CBCR_OFFSET = 128 << SCALEBITS;
constexpr int FIX_Y_R = 19595, FIX_Y_G = 38470, FIX_Y_B = 7471;
constexpr int FIX_CB_R = 11059, FIX_CB_G = 21709, FIX_HALF = 32768;
constexpr int FIX_CR_G = 27439, FIX_CR_B = 5329;

// jfdctint.c
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int FIX_0_298631336 = 2446;
constexpr int FIX_0_390180644 = 3196;
constexpr int FIX_0_541196100 = 4433;
constexpr int FIX_0_765366865 = 6270;
constexpr int FIX_0_899976223 = 7373;
constexpr int FIX_1_175875602 = 9633;
constexpr int FIX_1_501321110 = 12299;
constexpr int FIX_1_847759065 = 15137;
constexpr int FIX_1_961570560 = 16069;
constexpr int FIX_2_053119869 = 16819;
constexpr int FIX_2_562915447 = 20995;
constexpr int FIX_3_072711026 = 25172;

__device__ __forceinline__ int color_y(int r, int g, int b) {
  return (FIX_Y_R * r + FIX_Y_G * g + FIX_Y_B * b + ONE_HALF) >> SCALEBITS;
}

__device__ __forceinline__ int color_cb(int r, int g, int b) {
  return (-FIX_CB_R * r - FIX_CB_G * g + FIX_HALF * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS;
}

__device__ __forceinline__ int color_cr(int r, int g, int b) {
  return (FIX_HALF * r - FIX_CR_G * g - FIX_CR_B * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS;
}

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// One pass of jpeg_fdct_islow over 8 values `stride` apart, in place. Pass
// 1 (rows) scales the even terms 0 and 4 up by PASS1_BITS; pass 2
// (columns) descales them by PASS1_BITS.
template <bool kRows>
__device__ void fdct_pass(int* d, int stride) {
  constexpr int kBits = kRows ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
  const int tmp0 = d[0] + d[7 * stride], tmp7 = d[0] - d[7 * stride];
  const int tmp1 = d[stride] + d[6 * stride], tmp6_in = d[stride] - d[6 * stride];
  const int tmp2 = d[2 * stride] + d[5 * stride], tmp5_in = d[2 * stride] - d[5 * stride];
  const int tmp3 = d[3 * stride] + d[4 * stride], tmp4_in = d[3 * stride] - d[4 * stride];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (kRows) {
    d[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    d[4 * stride] = (tmp10 - tmp11) * (1 << PASS1_BITS);
  } else {
    d[0] = descale(tmp10 + tmp11, PASS1_BITS);
    d[4 * stride] = descale(tmp10 - tmp11, PASS1_BITS);
  }
  int z1 = (tmp12 + tmp13) * FIX_0_541196100;
  d[2 * stride] = descale(z1 + tmp13 * FIX_0_765366865, kBits);
  d[6 * stride] = descale(z1 - tmp12 * FIX_1_847759065, kBits);
  z1 = tmp4_in + tmp7;
  int z2 = tmp5_in + tmp6_in;
  int z3 = tmp4_in + tmp6_in;
  int z4 = tmp5_in + tmp7;
  const int z5 = (z3 + z4) * FIX_1_175875602;
  const int tmp4 = tmp4_in * FIX_0_298631336;
  const int tmp5 = tmp5_in * FIX_2_053119869;
  const int tmp6 = tmp6_in * FIX_3_072711026;
  const int tmp7s = tmp7 * FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  d[7 * stride] = descale(tmp4 + z1 + z3, kBits);
  d[5 * stride] = descale(tmp5 + z2 + z4, kBits);
  d[3 * stride] = descale(tmp6 + z2 + z3, kBits);
  d[stride] = descale(tmp7s + z1 + z4, kBits);
}

__global__ void __launch_bounds__(THREADS)
    jpeg_blocks_kernel(const uint8_t* __restrict__ rgb, int width, int height, int mcu_cols,
                       int mcu_rows, const int* __restrict__ qtab, int16_t* __restrict__ coef) {
  __shared__ int ws[BLOCKS_PER_MCU][64];
  __shared__ int16_t qz[BLOCKS_PER_MCU][64];
  const int mcu = blockIdx.x;
  const int my = mcu / mcu_cols, mx = mcu % mcu_cols;
  const int t = threadIdx.x;
  {  // Y: a pixel a thread
    const int r = t >> 4, c = t & 15;
    const int gy = min(my * 16 + r, height - 1), gx = min(mx * 16 + c, width - 1);
    const uint8_t* p = rgb + ((long long)gy * width + gx) * 3;
    ws[(r >> 3) * 2 + (c >> 3)][(r & 7) * 8 + (c & 7)] = color_y(p[0], p[1], p[2]) - 128;
  }
  if (t < 64) {  // Cb and Cr: a 2x2 cell a thread
    const int cr = t >> 3, cc = t & 7;
    const int cy = min(my * 8 + cr, (height + 1) / 2 - 1);
    const int gcx = mx * 8 + cc;
    int sb = 0, sr = 0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = min(2 * cy + dy, height - 1);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = min(2 * gcx + dx, width - 1);
        const uint8_t* p = rgb + ((long long)y * width + x) * 3;
        sb += color_cb(p[0], p[1], p[2]);
        sr += color_cr(p[0], p[1], p[2]);
      }
    }
    const int bias = 1 + (gcx & 1);
    ws[4][t] = ((sb + bias) >> 2) - 128;
    ws[5][t] = ((sr + bias) >> 2) - 128;
  }
  __syncthreads();
  if (t < BLOCKS_PER_MCU * 8) fdct_pass<true>(&ws[t >> 3][(t & 7) * 8], 1);
  __syncthreads();
  if (t < BLOCKS_PER_MCU * 8) fdct_pass<false>(&ws[t >> 3][t & 7], 8);
  __syncthreads();
  for (int i = t; i < MCU_COEFS; i += THREADS) {
    const int b = i >> 6, k = i & 63, nat = kZigzag[k];
    const int x = ws[b][nat];
    const int q = 8 * qtab[(b >= 4 ? 64 : 0) + nat];
    const int m = (abs(x) + (q >> 1)) / q;
    qz[b][k] = (int16_t)(x < 0 ? -m : m);
  }
  __syncthreads();
  // dummy blocks: a Y column past ceil(W/8) blocks (Y01, Y11 take the DC of
  // the block to their left), a Y row past ceil(H/8) (Y10, Y11 take Y01's)
  const bool right = mx == mcu_cols - 1 && (((width + 7) >> 3) & 1);
  const bool bottom = my == mcu_rows - 1 && (((height + 7) >> 3) & 1);
  const int16_t dc01 = right ? qz[0][0] : qz[1][0];
  int16_t* out = coef + (long long)mcu * MCU_COEFS;
  for (int i = t; i < MCU_COEFS; i += THREADS) {
    const int b = i >> 6, k = i & 63;
    int16_t v = qz[b][k];
    if (bottom && (b == 2 || b == 3))
      v = k == 0 ? dc01 : 0;
    else if (right && (b == 1 || b == 3))
      v = k == 0 ? qz[b - 1][0] : 0;
    out[i] = v;
  }
}

struct Token {
  unsigned long long val;  // MSB-first bits of the token
  int len;
};

__device__ __forceinline__ int nbits(int v) {
  v = abs(v);
  return v ? 32 - __clz(v) : 0;
}

// The magnitude bits of v: v itself, or v - 1 (its one's complement) below 0
__device__ __forceinline__ unsigned magnitude(int v, int nb) {
  return (unsigned)(v - (v < 0)) & ((1u << nb) - 1u);
}

// The token of a nonzero AC coefficient v at zigzag position k >= 1; `mask`
// has bit j set where position j is nonzero, and bit 0 set.
__device__ __forceinline__ Token ac_token(int v, int k, unsigned long long mask,
                                         const int* __restrict__ code,
                                         const int* __restrict__ len) {
  Token tok = {0ull, 0};
  if (v == 0) return tok;
  const int prev = 63 - __clzll(mask & ((1ull << k) - 1ull));
  const int run = k - prev - 1;
  const int nb = nbits(v);
  const int sym = ((run & 15) << 4) | nb;
  const int zlen = __ldg(&len[0xF0]);
  const unsigned long long zcode = (unsigned long long)__ldg(&code[0xF0]);
  for (int i = 0; i < (run >> 4); ++i) {
    tok.val = (tok.val << zlen) | zcode;
    tok.len += zlen;
  }
  const int clen = __ldg(&len[sym]);
  tok.val = (tok.val << clen) | (unsigned long long)__ldg(&code[sym]);
  tok.val = (tok.val << nb) | magnitude(v, nb);
  tok.len += clen + nb;
  return tok;
}

// Lane `lane`'s two tokens of block b (positions lane and lane + 32): the
// whole warp calls this for one block. huff: codes [4][256], then lengths
// [4][256], tables DC0, AC0, DC1, AC1.
__device__ void block_tokens(const int16_t* __restrict__ coef, long long b, int lane,
                             const int* __restrict__ huff, Token& lo, Token& hi) {
  const int16_t* blk = coef + b * 64;
  const int j = (int)(b % BLOCKS_PER_MCU);
  const long long mcu = b / BLOCKS_PER_MCU;
  const int chroma = j >= 4;
  const int* dc_code = huff + (2 * chroma) * 256;
  const int* ac_code = huff + (2 * chroma + 1) * 256;
  const int* dc_len = dc_code + 4 * 256;
  const int* ac_len = ac_code + 4 * 256;
  const int v_lo = blk[lane], v_hi = blk[lane + 32];
  const unsigned m_lo = __ballot_sync(FULL, v_lo != 0) | 1u;
  const unsigned m_hi = __ballot_sync(FULL, v_hi != 0);
  const unsigned long long mask = ((unsigned long long)m_hi << 32) | m_lo;
  if (lane == 0) {  // the DC difference against the component's previous block
    long long prev = -1;
    if (j >= 4)
      prev = mcu > 0 ? b - BLOCKS_PER_MCU : -1;
    else if (j > 0)
      prev = b - 1;
    else if (mcu > 0)
      prev = b - BLOCKS_PER_MCU + 3;
    const int diff = v_lo - (prev >= 0 ? (int)coef[prev * 64] : 0);
    const int nb = nbits(diff);
    lo.val = ((unsigned long long)__ldg(&dc_code[nb]) << nb) | magnitude(diff, nb);
    lo.len = __ldg(&dc_len[nb]) + nb;
  } else {
    lo = ac_token(v_lo, lane, mask, ac_code, ac_len);
  }
  hi = ac_token(v_hi, lane + 32, mask, ac_code, ac_len);
  if (lane == 31 && v_hi == 0) {  // EOB after the last nonzero AC
    hi.val = (unsigned long long)__ldg(&ac_code[0]);
    hi.len = __ldg(&ac_len[0]);
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
    jpeg_lengths_kernel(const int16_t* __restrict__ coef, long long n_blocks,
                        const int* __restrict__ huff, int* __restrict__ lens) {
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= n_blocks) return;  // a whole warp at once
  Token lo, hi;
  block_tokens(coef, b, lane, huff, lo, hi);
  int n = lo.len + hi.len;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(FULL, n, d);
  if (lane == 0) lens[b] = n;
}

// OR `tok` into the MSB-first word stream at bit `off` (at most 59 bits,
// so at most three words).
__device__ void put_bits(unsigned* words, long long off, Token tok) {
  if (tok.len == 0) return;
  const long long w = off >> 5;
  const int s = (int)(off & 31), e = s + tok.len;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int a = max(s, 32 * j), z = min(e, 32 * j + 32);
    if (a >= z) continue;
    const unsigned long long bits =
        (tok.val >> (tok.len - (z - s))) & ((1ull << (z - a)) - 1ull);
    atomicOr(&words[w + j], (unsigned)(bits << (32 * j + 32 - z)));
  }
}

__device__ __forceinline__ int ff_bytes(unsigned w) {
  return __popc(__vcmpeq4(w, 0xffffffffu)) >> 3;
}

__global__ void __launch_bounds__(THREADS)
    jpeg_pack_kernel(const int16_t* __restrict__ coef, long long n_blocks,
                     const int* __restrict__ huff, const int* __restrict__ ends, unsigned* words,
                     long long n_chunks, int* __restrict__ ff_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long b = (long long)blockIdx.x * WARPS + warp; b < n_blocks; b += n_warps) {
    Token lo, hi;
    block_tokens(coef, b, lane, huff, lo, hi);
    const int s_lo = warp_inclusive_sum(lo.len, lane);
    const int s_hi = warp_inclusive_sum(hi.len, lane);
    const int total_lo = __shfl_sync(FULL, s_lo, 31);
    const long long base = b > 0 ? ends[b - 1] : 0;
    put_bits(words, base + s_lo - lo.len, lo);
    put_bits(words, base + total_lo + s_hi - hi.len, hi);
    if (b == n_blocks - 1 && lane == 0) {  // pad to the byte with 1-bits
      const long long total = ends[b];
      const int pad = (int)((8 - (total & 7)) & 7);
      put_bits(words, total, Token{(1ull << pad) - 1ull, pad});
    }
  }
  cooperative_groups::this_grid().sync();
  __shared__ int warp_sums[WARPS];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int n = ff_bytes(__ldcg(&words[c * CHUNK_WORDS + threadIdx.x]));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(FULL, n, d);
    if (lane == 0) warp_sums[warp] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int i = 0; i < WARPS; ++i) sum += warp_sums[i];
      ff_counts[c] = sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    jpeg_stuff_kernel(const unsigned* __restrict__ words, const int* __restrict__ ends,
                      long long n_blocks, const int* __restrict__ ff_ends, long long n_chunks,
                      uint8_t* __restrict__ out, int* __restrict__ out_len) {
  const long long n_bytes = ((long long)ends[n_blocks - 1] + 7) >> 3;
  const long long c = blockIdx.x;
  if (c == 0 && threadIdx.x == 0) *out_len = (int)(n_bytes + ff_ends[n_chunks - 1]);
  const long long first = c * CHUNK_WORDS * 4;
  if (first >= n_bytes) return;  // the whole CTA at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned w = words[c * CHUNK_WORDS + threadIdx.x];
  const int n = ff_bytes(w);  // bytes past the scan are zero
  const int incl = warp_inclusive_sum(n, lane);
  __shared__ int warp_tot[WARPS];
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = incl - n;
  for (int i = 0; i < warp; ++i) before += warp_tot[i];
  long long pos = first + 4 * threadIdx.x + (c > 0 ? ff_ends[c - 1] : 0) + before;
  for (int q = 0; q < 4; ++q) {
    if (first + 4 * threadIdx.x + q >= n_bytes) break;
    const uint8_t byte = (uint8_t)(w >> (24 - 8 * q));
    out[pos++] = byte;
    if (byte == 0xff) out[pos++] = 0;
  }
}

struct Plan {
  long long mcu_rows, mcu_cols, n_mcu, n_blocks, n_chunks;
};

Plan make_plan(int width, int height) {
  Plan p;
  p.mcu_rows = (height + 15) / 16;
  p.mcu_cols = (width + 15) / 16;
  p.n_mcu = p.mcu_rows * p.mcu_cols;
  p.n_blocks = p.n_mcu * BLOCKS_PER_MCU;
  const long long bytes = (p.n_blocks * MAX_BLOCK_BITS + 7) / 8;
  p.n_chunks = (bytes + CHUNK_WORDS * 4 - 1) / (CHUNK_WORDS * 4);
  return p;
}

bool valid_size(int width, int height) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535) return false;
  // bit offsets are int32 (K3's rows)
  return make_plan(width, height).n_blocks * MAX_BLOCK_BITS < (1LL << 31);
}

const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)jpeg_blocks_kernel;
    case 1: return (const void*)jpeg_lengths_kernel;
    case 2: return (const void*)jpeg_pack_kernel;
    case 3: return (const void*)jpeg_stuff_kernel;
    default: return nullptr;
  }
}

}  // namespace

// (a): rgb [height][width][3] uint8; qtab int32 [2][64], the luminance and
// chrominance tables in natural order; coef int16 [n_mcu][6][64].
extern "C" int egs_jpeg_blocks(const uint8_t* rgb, int width, int height, const int* qtab,
                               int16_t* coef, void* stream) {
  if (!valid_size(width, height)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(width, height);
  jpeg_blocks_kernel<<<(unsigned)p.n_mcu, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, width, height, (int)p.mcu_cols, (int)p.mcu_rows, qtab, coef);
  return (int)cudaGetLastError();
}

// (b): lens int32 [n_blocks]. huff int32 [2][4][256] (codes, then lengths).
extern "C" int egs_jpeg_lengths(const int16_t* coef, long long n_blocks, const int* huff,
                                int* lens, void* stream) {
  if (n_blocks <= 0 || n_blocks % BLOCKS_PER_MCU) return (int)cudaErrorInvalidValue;
  jpeg_lengths_kernel<<<(unsigned)((n_blocks + WARPS - 1) / WARPS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(coef, n_blocks, huff, lens);
  return (int)cudaGetLastError();
}

// (c): ends int32 [n_blocks], the inclusive sums of lens; words uint32
// [n_chunks * 256], cleared here; ff_counts int32 [n_chunks].
extern "C" int egs_jpeg_pack(const int16_t* coef, long long n_blocks, const int* huff,
                             const int* ends, unsigned* words, long long n_chunks,
                             int* ff_counts, void* stream) {
  if (n_blocks <= 0 || n_blocks % BLOCKS_PER_MCU || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(words, 0, (size_t)n_chunks * CHUNK_WORDS * 4, s);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jpeg_pack_kernel, THREADS,
                                                         0)) != cudaSuccess)
    return (int)e;
  const long long want = (n_blocks + WARPS - 1) / WARPS > n_chunks
                             ? (n_blocks + WARPS - 1) / WARPS
                             : n_chunks;
  const long long resident = (long long)per_sm * n_sm;
  const unsigned grid = (unsigned)(want < resident ? want : resident);
  void* args[] = {(void*)&coef, (void*)&n_blocks, (void*)&huff, (void*)&ends,
                  (void*)&words, (void*)&n_chunks, (void*)&ff_counts};
  e = cudaLaunchCooperativeKernel((const void*)jpeg_pack_kernel, dim3(grid), dim3(THREADS), args,
                                  0, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// (d): ff_ends int32 [n_chunks], the inclusive sums of ff_counts; out uint8
// [2 * n_chunks * 1024]; out_len int32 [1], the stuffed scan's bytes.
extern "C" int egs_jpeg_stuff(const unsigned* words, const int* ends, long long n_blocks,
                              const int* ff_ends, long long n_chunks, uint8_t* out,
                              int* out_len, void* stream) {
  if (n_blocks <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  jpeg_stuff_kernel<<<(unsigned)n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      words, ends, n_blocks, ff_ends, n_chunks, out, out_len);
  return (int)cudaGetLastError();
}

// The plan of a frame: out[0..6] = MCUs, blocks, stuffing chunks, words of
// the packed scan, bytes of the stuffed buffer, kernel launches of K11's
// own (4; the wrapper adds K3's two scans), memsets (1).
extern "C" int egs_jpeg_plan(int width, int height, long long* out) {
  if (!valid_size(width, height)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(width, height);
  out[0] = p.n_mcu;
  out[1] = p.n_blocks;
  out[2] = p.n_chunks;
  out[3] = p.n_chunks * CHUNK_WORDS;
  out[4] = 2 * p.n_chunks * CHUNK_WORDS * 4;
  out[5] = 4;
  out[6] = 1;
  return 0;
}

// Kernel `which` (0 blocks, 1 lengths, 2 pack, 3 stuff) as compiled:
// out[0..4] = registers, static shared bytes, local (spill) bytes,
// resident blocks an SM, threads a block.
extern "C" int egs_jpeg_info(int which, int* out) {
  const void* fn = kernel_of(which);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[4] = THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, THREADS, 0);
}
