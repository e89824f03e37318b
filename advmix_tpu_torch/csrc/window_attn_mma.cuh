// The tensor-core route's building blocks (design: window_attn.cuh), shared
// by its forward (window_attn_fwd_bf16.cu) and backward
// (window_attn_bwd_bf16.cu): the tiles' layout in shared memory, the
// fragment loads and `mma.sync` of bf16, the f32 -> bf16 pair split, the
// bias table in the exp2 domain, the copies of a window's rows between
// device memory and the tiles, and the kernels' residency on the card.

#pragma once

#include <cstdint>

#include "window_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A (window, head) tile in shared memory: 64 rows (the 49 tokens, then
// zeros) of head-dim elements (d of them, then zeros up to 48), bf16. A row
// is 56 elements, 112 bytes: the 8 rows that one ldmatrix reads then start
// in 8 distinct groups of 4 banks.
constexpr int kRows = 64;
constexpr int kLd = 56;
constexpr int kTileElems = kRows * kLd;
constexpr int kDimChunks = 3;   // head dim as a product's depth: 3 x 16
constexpr int kDimTiles = 5;    // head dim as a product's width: 5 x 8 = 40
constexpr int kKeyTiles = 7;    // tokens as a product's width: 7 x 8 = 56
constexpr int kTokChunks = 4;   // tokens as a product's depth: 4 x 16
constexpr int kMaxDim = 40;
constexpr int kMmaThreads = 128;  // 4 warps, one a 16-row tile
// a head's bias table, times log2(e), at [kTbOff + rel]; zeros around it, so
// that the rows and columns past 49 read finite values
constexpr int kTbOff = 64;
constexpr int kTbLd = 320;
constexpr int kTokLd = 52;      // a window's 49 token indices, padded
constexpr int kAccLd = 56;      // a row of the summed dS^T, f32
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a (token, part) run's slot in the raw buffer: the 16-byte chunks that
// cover 40 elements at any 2-byte offset
constexpr int kRawSlot = 16 * ((2 * kMaxDim + 14 + 15) / 16);

// shared memory of the kernels, in bytes, in the order the kernels lay it
// out: the tiles (forward q, k, v; backward also dO and the staged dQ),
// the raw buffer of a window's runs, the backward's per-(key, query) sums
// of dS, two windows' log-sums as copied, the current in log2 units, D
// and the padded keys' sums, then the table, the tokens of two windows,
// `rtab`, `rp` and the runs' offsets
constexpr int kTailSmem = kTbLd * 4 + 2 * kTokLd * 4 + 2 * kRows * 4;
constexpr int kFwdSmem =
    3 * kTileElems * 2 + 3 * kTok * kRawSlot + kTailSmem + 3 * kTok * 4;
constexpr int kBwdSmem = 5 * kTileElems * 2 + 4 * kTok * kRawSlot +
                         kTok * kAccLd * 4 + 4 * kRows * 4 +
                         4 * 2 * kMaxDim * 4 + kTailSmem + 4 * kTok * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// commits this thread's copies as a group and waits for all of them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as one register of two bf16, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

// (a, b) as hi + lo, each two bf16: hi = bf16(x), lo = bf16(x - hi), which
// keeps ~16 bits of x's mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// the A fragments (hi and lo) of columns [16 kc, 16 kc + 16) of a warp's
// 16 x 56 f32 product held in accumulator layout; columns 56-63 are zero
__device__ __forceinline__ void a_from_acc(const float (&c)[kKeyTiles][4],
                                           int kc, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(c[2 * kc][0], c[2 * kc][1], hi[0], lo[0]);
  split_bf16(c[2 * kc][2], c[2 * kc][3], hi[1], lo[1]);
  if (2 * kc + 1 < kKeyTiles) {
    split_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1], hi[2], lo[2]);
    split_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3], hi[3], lo[3]);
  } else {
    hi[2] = hi[3] = lo[2] = lo[3] = 0u;
  }
}

// the A fragments of a tile's rows [r0, r0 + 16) over the head dim
__device__ __forceinline__ void load_a(uint32_t (&a)[kDimChunks][4],
                                       const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < kDimChunks; ++kc)
    ldsm_x4(a[kc], tile + (r0 + (lane & 15)) * kLd + 16 * kc + (lane >> 4) * 8);
}

// acc (16 x 56) = the tile's rows [r0, r0 + 16) times rows 0-55 of
// `other`, transposed: each product of a row of one and a row of the
// other, over the head dim
__device__ __forceinline__ void mul_rows_t(float (&acc)[kKeyTiles][4],
                                           const bf16* tile, int r0,
                                           const bf16* other, int lane) {
  uint32_t a[kDimChunks][4];
  load_a(a, tile, r0, lane);
#pragma unroll
  for (int n = 0; n < kKeyTiles; ++n) {
    uint32_t b[4], b2[2];
    const bf16* row = other + (8 * n + (lane & 7)) * kLd;
    ldsm_x4(b, row + (lane >> 3) * 8);
    ldsm_x2(b2, row + 32 + ((lane >> 3) & 1) * 8);
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    mma_bf16(acc[n], a[0], b[0], b[1]);
    mma_bf16(acc[n], a[1], b[2], b[3]);
    mma_bf16(acc[n], a[2], b2[0], b2[1]);
  }
}

// out (16 x 40) = x (16 x 64, f32 in accumulator layout, as hi + lo) times
// the tile's rows 0-63 over its first 40 head-dim columns
__device__ __forceinline__ void mul_tile(float (&out)[kDimTiles][4],
                                         const float (&x)[kKeyTiles][4],
                                         const bf16* tile, int lane) {
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt)
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kTokChunks; ++kc) {
    uint32_t hi[4], lo[4];
    a_from_acc(x, kc, hi, lo);
    const bf16* rows =
        tile + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd;
#pragma unroll
    for (int nt = 0; nt + 1 < kDimTiles; nt += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, rows + 8 * nt + (lane >> 4) * 8);
      mma_bf16(out[nt], hi, b[0], b[1]);
      mma_bf16(out[nt], lo, b[0], b[1]);
      mma_bf16(out[nt + 1], hi, b[2], b[3]);
      mma_bf16(out[nt + 1], lo, b[2], b[3]);
    }
    uint32_t b[2];
    ldsm_x2_t(b, rows + 8 * (kDimTiles - 1));
    mma_bf16(out[kDimTiles - 1], hi, b[0], b[1]);
    mma_bf16(out[kDimTiles - 1], lo, b[0], b[1]);
  }
}

// a warp's 16 x 40 product into rows [r0, r0 + 16) of a tile, scaled, rows
// under 49 only
__device__ __forceinline__ void store_rows(bf16* tile, int r0,
                                           const float (&x)[kDimTiles][4],
                                           float s0, float s1, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, col = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kDimTiles; ++nt) {
    if (ra < kTok)
      *reinterpret_cast<uint32_t*>(tile + ra * kLd + 8 * nt + col) =
          pack_bf16(x[nt][0] * s0, x[nt][1] * s0);
    if (rb < kTok)
      *reinterpret_cast<uint32_t*>(tile + rb * kLd + 8 * nt + col) =
          pack_bf16(x[nt][2] * s1, x[nt][3] * s1);
  }
}

// Ri of token i (row i / 7, column i % 7): the bias-table row of query i
// and key j is Ri - Rj + 84
__device__ __forceinline__ int rpos(int i) {
  return (i / kWin) * (2 * kWin - 1) + i % kWin;
}

// 2^x, flushing results under 2^-126 to zero (probabilities there are
// nothing); 2^-inf = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Where a block's tiles and a window's rows meet. The block's head h0
// owns, in each token row of the source, `parts` runs of d channels: part
// p at p * pstride + h0 d. With `words` (C even and the pointers 4-byte
// aligned), the head starts at an element of the same parity in every
// token row, s = h0 d mod 2: its tile rows hold it at columns [s, s + d),
// so that it moves as aligned 4-byte words (20 a row at most), the first
// and last word's spare half zero. Else it moves an element at a time,
// s = 0. Columns outside [s, s + d) stay zero, and so do the products'
// columns there.
struct Span {
  int ld, pstride, h0, d;
  bool words;
};

__device__ __forceinline__ int shift_of(const Span& sp) {
  return sp.words ? (sp.h0 * sp.d) & 1 : 0;
}

// Where a thread stands in a window's copies: unit `k` of the rows (with
// words, 4 words, 16 bytes of the tile row, 5 a row; else an element), on
// rows `row`, `row` + `rows`, ... of the (token, part) runs; the block's
// other threads idle there.
struct CopyLane {
  int rows, row, k;
};

__device__ __forceinline__ CopyLane copy_lane(const Span& sp) {
  const int n = sp.words ? kMaxDim / 8 : kMaxDim;
  const int tid = static_cast<int>(threadIdx.x);
  return {static_cast<int>(blockDim.x) / n, tid / n, tid % n};
}

// which halves of word i of a thread's unit hold elements of the head's
// run (first element e0 of the unit)
__device__ __forceinline__ uint32_t word_keep(int e0, int i, int d) {
  const int e = e0 + 2 * i;
  return (e >= 0 && e < d ? 0xffffu : 0u) |
         (e + 1 >= 0 && e + 1 < d ? 0xffff0000u : 0u);
}

// the head's run of part p (parts below kSplit from `src`, rows of sp.ld;
// the others from `src2`, rows of sp.pstride) of token o: d elements
template <int kSplit>
__device__ __forceinline__ const bf16* run_of(const bf16* src,
                                              const bf16* src2,
                                              const Span& sp, int o, int p) {
  const int col = sp.h0 * sp.d;
  return p < kSplit ? src + (long long)o * sp.ld + p * sp.pstride + col
                    : src2 + (long long)o * sp.pstride + col;
}

// Batch `q` of `nq` of a window's copies into the raw buffer: each real
// token's run of the head as the 16-byte chunks that cover it, to the
// run's slot, neighbouring threads on neighbouring chunks; `runoff[r]`
// gets the raw byte offset of run r's first element, or -1 for a padded
// token's. Spread over the compute phases, the batches keep the copies in
// flight while the warps compute. The caller waits (cp_async_wait_all).
template <int kParts, int kSplit>
__device__ __forceinline__ void copy_batch(uint8_t* raw, int* runoff,
                                           const bf16* __restrict__ src,
                                           const bf16* __restrict__ src2,
                                           const Span& sp, const int* tok,
                                           int q, int nq) {
  constexpr int kUnits = kTok * kParts * 8;  // 8 a run; 6 cover it
  const int n = static_cast<int>(blockDim.x);
  for (int u = static_cast<int>(threadIdx.x) + q * n; u < kUnits; u += nq * n) {
    const int r = u >> 3, k = u & 7;
    const int t = r / kParts, p = r - t * kParts, o = tok[t];
    const uintptr_t a = o >= 0 ? reinterpret_cast<uintptr_t>(
                                     run_of<kSplit>(src, src2, sp, o, p))
                               : 0;
    const uintptr_t c = (a & ~static_cast<uintptr_t>(15)) + 16 * k;
    if (k == 0)
      runoff[r] = o >= 0 ? r * kRawSlot + static_cast<int>(a & 15) : -1;
    if (o >= 0 && c < a + 2 * sp.d) cp_async16(raw + r * kRawSlot + 16 * k, c);
  }
}

// The raw buffer's runs into the tiles, part p to `tiles` +
// p * kTileElems, at columns [s, s + d) (Span). A padded
// token's row takes bf16(pad[...]) for parts from `pad_from` up to kSplit
// (the projection's bias of k and v), else zeros.
template <int kParts, int kSplit>
__device__ __forceinline__ void unpack_window(bf16* tiles, const uint8_t* raw,
                                              const int* runoff,
                                              const float* __restrict__ pad,
                                              int pad_from, const Span& sp,
                                              const CopyLane& cl) {
  constexpr int kSpans = kTok * kParts;
  const int s = shift_of(sp), d = sp.d;
  const int e0 = sp.words ? 8 * cl.k - s : cl.k;  // the unit's first element
  if (cl.row >= cl.rows || e0 >= d) return;
  const int at = sp.words ? 8 * cl.k : cl.k;
  const int from = 2 * e0;  // its bytes in the head's run
  const float* bias = pad + sp.h0 * d + e0;
  if (sp.words) {
    uint32_t keep[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] = word_keep(e0, i, d);
    // a padded token's (unread) run: any offset of a real run's alignment
    const int unread = 2 * ((sp.h0 * d) & 1);
#pragma unroll 2
    for (int r = cl.row; r < kSpans; r += cl.rows) {
      const int t = r / kParts, p = r - t * kParts, off = runoff[r];
      const uint32_t* q = reinterpret_cast<const uint32_t*>(
          raw + (off >= 0 ? off : unread) + from);
      uint4 v = make_uint4(q[0] & keep[0], q[1] & keep[1], q[2] & keep[2],
                           q[3] & keep[3]);
      if (off < 0) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (p >= pad_from && p < kSplit) {
          const float* b = bias + p * sp.pstride;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = pack_bf16(keep[i] & 0xffffu ? b[2 * i] : 0.f,
                             keep[i] >> 16 ? b[2 * i + 1] : 0.f);
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(tiles + p * kTileElems + t * kLd + at) = v;
    }
  } else {
#pragma unroll 4
    for (int r = cl.row; r < kSpans; r += cl.rows) {
      const int t = r / kParts, p = r - t * kParts, off = runoff[r];
      bf16 v = __float2bfloat16(0.f);
      if (off >= 0)
        v = *reinterpret_cast<const bf16*>(raw + off + from);
      else if (p >= pad_from && p < kSplit)
        v = __float2bfloat16(bias[p * sp.pstride]);
      tiles[p * kTileElems + t * kLd + at] = v;
    }
  }
}

// The tiles' rows of the window's real tokens back to their runs in `dst`
// (rows of sp.ld): part 0 from `tile0`, part p > 0 from `tiles` +
// p * kTileElems; a word that holds one of the run's elements writes
// that element alone.
template <int kParts>
__device__ __forceinline__ void store_window(bf16* __restrict__ dst,
                                             const bf16* tile0,
                                             const bf16* tiles,
                                             const Span& sp,
                                             const CopyLane& cl,
                                             const int* tok) {
  constexpr int kSpans = kTok * kParts;
  const int s = shift_of(sp), d = sp.d;
  const int e0 = sp.words ? 8 * cl.k - s : cl.k;
  if (cl.row >= cl.rows || e0 >= d) return;
  const int at = sp.words ? 8 * cl.k : cl.k;
  const int col = sp.h0 * d + e0;
  if (sp.words) {
    uint32_t keep[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] = word_keep(e0, i, d);
#pragma unroll 2
    for (int r = cl.row; r < kSpans; r += cl.rows) {
      const int t = r / kParts, p = r - t * kParts, o = tok[t];
      const uint4 v = *reinterpret_cast<const uint4*>(
          (p == 0 ? tile0 : tiles + p * kTileElems) + t * kLd + at);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint16_t* a = reinterpret_cast<uint16_t*>(
          dst + (long long)(o < 0 ? 0 : o) * sp.ld + p * sp.pstride + col);
      if (o < 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (keep[i] == 0xffffffffu)
          *reinterpret_cast<uint32_t*>(a + 2 * i) = w[i];
        else if (keep[i] == 0xffffu)
          a[2 * i] = static_cast<uint16_t>(w[i]);
        else if (keep[i])
          a[2 * i + 1] = static_cast<uint16_t>(w[i] >> 16);
      }
    }
  } else {
#pragma unroll 4
    for (int r = cl.row; r < kSpans; r += cl.rows) {
      const int t = r / kParts, p = r - t * kParts, o = tok[t];
      const bf16 v =
          (p == 0 ? tile0 : tiles + p * kTileElems)[t * kLd + at];
      if (o >= 0) dst[(long long)o * sp.ld + p * sp.pstride + col] = v;
    }
  }
}

// The block's shared set-up: the head's table column times log2(e) at
// kTbOff (zeros around it), `rtab` (84 - Rj of each of the 64 rows) and
// `rp` (Ri). The caller syncs.
__device__ __forceinline__ void setup_head(float* tb, int* rtab, int* rp,
                                           const float* __restrict__ table,
                                           const Geo& g, int h0) {
  for (int k = threadIdx.x; k < kTbLd; k += blockDim.x) {
    const int e = k - kTbOff;
    tb[k] = e >= 0 && e < kRel ? table[e * g.heads + h0] * kLog2e : 0.f;
  }
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    rp[i] = rpos(i);
    rtab[i] = (kWin - 1) * (2 * kWin) - rpos(i);
  }
}

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int k = threadIdx.x; k < bytes / 16; k += blockDim.x)
    q[k] = make_uint4(0u, 0u, 0u, 0u);
}

// Blocks of `kernel` (kMmaThreads threads, `smem` bytes of shared memory)
// that the current device holds at once over all its SMs, as the kernel's
// registers, launch bounds and shared memory allow: the wrapper spreads
// each head's windows over about this many blocks in all.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kMmaThreads, smem);
  *blocks = sms * per_sm;
  if (err == cudaSuccess && *blocks < 1) err = cudaErrorInvalidConfiguration;
  return static_cast<int>(err);
}

}  // namespace
