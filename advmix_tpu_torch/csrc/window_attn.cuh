// Windowed multi-head self-attention with a relative-position bias, forward
// and backward, for Hopper (sm_90a): per (image, 7x7 window, head),
// softmax(q k^T * scale + table[rel(i, j)]) v over the window's 49 tokens.
//
// Replaces no TPU kernel: the JAX package has no attention. Added for
// HRFormer-B (advmix_tpu_torch/models/pose_hrformer.py), whose 44
// branch-blocks a forward run this at head dim 39 with an additive learned
// bias, a shape no fused PyTorch path takes. The Python wrapper, the custom
// ops and the plain PyTorch version it is checked against are in
// advmix_tpu_torch/ops/cuda/window_attention.py.
//
// Bound: HBM bytes. A (window, head) problem moves ~15 KB of bf16 q, k, v
// and output for ~0.37 MFLOP, about 24 FLOP a byte against the H100's ~295
// (bf16 tensor cores). The least traffic is q, k and v of the real tokens
// read once and the output written once (forward); q, k, v, the output's
// gradient and the softmax's log-sum read, and dq, dk, dv written
// (backward).
//
// Layout and addressing, both routes. q, k and v are read straight from the
// qkv projection's output in token layout, (B, H, W, 3C) with channel
// part * C + head * d + e; the output (B, H, W, C) and dqkv are written in
// the same layout. The map is centre-padded to whole windows by addressing
// alone (token_of): a token outside the map is a padded one, whose key and
// value are the projection's bias (the source pads with zeros before the
// projection), rounded to the element type as the projection would give
// it. A padded query's output is cropped away, so it is not written.
//
// Two routes, chosen by the wrapper from the input's dtype; they share the
// addressing helpers below and no kernel.
//
// f32: the "simt" route (window_attn_fwd_kernel, window_attn_bwd_kernel,
// below; window_attn_{fwd,bwd}_f32.cu). Forward: one block of 64 threads
// per (window, head); a thread a query row with its 49 scores in registers,
// keys and values as f32 rows in shared memory read as broadcast float4.
// Backward: blocks of 64 threads on a grid of (groups, heads), block g
// walking windows g, g + groups, ...; thread i (a query row) forms P, dS and
// dQ, thread j (a key row) then dV and dK from P and dS in shared memory.
//
// bf16: the "mma" route (window_attn_mma.cuh, window_attn_{fwd,bwd}_bf16.cu),
// on the tensor cores. A block of 4 warps covers one window at a time for
// one head and walks a fixed set of windows (blockIdx.x, + gridDim.x, ...)
// on a grid of about as many blocks as the card holds at once (the
// kernel's residency, `advmix_window_attn_resident`, spread by the
// wrapper's `mma_blocks`). Copies: the head's q, k, v (and dO) of a token
// are runs of d neighbouring channels; the 16-byte chunks that cover each
// run go to a raw buffer by cp.async, started in batches between the
// previous window's compute phases; they are unpacked into bf16 tiles of
// 64 rows (the 49 tokens, then zeros) by 48 columns as aligned 4-byte
// words, 16 bytes a thread: head h's columns sit at [s, s + d) with
// s = h d mod 2, the parity its runs start at in every token row (C
// even), so no element moves alone, and the words' spare halves are
// zero (for an odd C, one element at a time at s = 0). Padded tokens take
// the bias or zeros with no load. Outputs are staged in the tiles and
// written back as words of the runs, a lone element at a run's ends.
// Products are mma.sync m16n8k16 with f32 sums, one warp a 16-row tile:
// 49 queries pad to 64, keys to 56 (scores) or 64 (as a depth), the head
// dim to 48 (depth) or 40 (width). q k^T and dO v^T take their bf16
// operands as stored, so each product is exact and summed in f32. P (in
// P v and P^T dO) and dS (in dS k and dS^T q) are f32 and enter as a bf16
// pair, hi = bf16(x) and lo = bf16(x - hi), in two products: ~16 bits of
// their mantissa. The softmax's max, sum and log-sum stay f32 (in log2
// units inside the kernels). The backward takes one pass a window: a row
// phase (warp w's query rows: P from the log-sums, dP, D = rowsum(P dP),
// dS, dQ) and a column phase (warp w's key rows: P^T and dP^T recomputed
// in the transposed layout, dS^T with the row phase's D, dV, dK, written
// into its own k and v rows), with no serial key loop. What bounds it on
// the H100 (clock64 phase counts): not the bytes but each window's chain
// of copy, unpack, compute and write-back at the warps an SM holds,
// registers and shared memory allowing no more (the launch bounds ask for
// 4 blocks forward, 3 backward).
//
// Backward order of sums, both routes: a block adds its windows' dS into
// the table's 169 entries and the padded keys' dK and dV into the bias'
// k and v parts, in a fixed order (mma: dS^T summed per (key, query) over
// the block's windows in shared memory, each entry owned by one thread,
// then binned once; a padded key's dK and dV summed over the warp's rows
// by a fixed butterfly, then into the warp's sums, added over the warps
// in order); window_attn_reduce_kernel adds the blocks' partials in block
// order. No atomics: the same inputs give the same bits on every run.
//
// Sources. This header holds the declarations, the addressing helpers, the
// simt kernels and the reduction; window_attn_mma.cuh the mma route's
// parts; each element type and direction is a source of its own
// (window_attn_{fwd,bwd}_{f32,bf16}.cu), which nvcc compiles in parallel
// (as one source, the simt route's five head sizes of both element types
// took nvcc 121 s for sm_90a); window_attn.cu holds the two C entries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace advmix_wa {

struct Geo {
  int B, H, W, C, heads, top, left, nwh, nww;
  float scale;
};

int fwd_f32(const void* qkv, const float* bias, const float* table, void* out,
            float* lse, const Geo& g, cudaStream_t stream);
int fwd_bf16(const void* qkv, const float* bias, const float* table,
             void* out, float* lse, const Geo& g, int blocks,
             cudaStream_t stream);
int bwd_f32(const void* dout, const void* qkv, const float* bias,
            const float* table, const float* lse, void* dqkv, float* partial,
            float* dtable, float* dbias, const Geo& g, int groups,
            cudaStream_t stream);
int bwd_bf16(const void* dout, const void* qkv, const float* bias,
             const float* table, const float* lse, void* dqkv,
             float* partial, float* dtable, float* dbias, const Geo& g,
             int groups, cudaStream_t stream);
// blocks of the bf16 (mma) kernel that the current device holds at once
int fwd_bf16_resident(int* blocks);
int bwd_bf16_resident(int* blocks);

}  // namespace advmix_wa

namespace {

using advmix_wa::Geo;

constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;                    // 49 tokens a window
constexpr int kRel = (2 * kWin - 1) * (2 * kWin - 1);  // 169 table rows
constexpr int kThreads = 64;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// the bias value a padded token gets: rounded to T, as the projection of a
// zero token in T gives it
template <typename T>
__device__ __forceinline__ float as_elem(float v) {
  return to_f<T>(from_f<T>(v));
}

// the token index (b, y, x) of token t of window `win`, or -1 if padded
__device__ __forceinline__ int token_of(const Geo& g, int win, int t) {
  const int per_img = g.nwh * g.nww;
  const int b = win / per_img;
  const int r = win - b * per_img;
  const int wy = r / g.nww, wx = r - wy * g.nww;
  const int y = wy * kWin + t / kWin - g.top;
  const int x = wx * kWin + t % kWin - g.left;
  if (y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
  return (b * g.H + y) * g.W + x;
}

// bias-table row of query i and key j (Swin's relative_position_index)
__device__ __forceinline__ int rel_of(int i, int j) {
  return (i / kWin - j / kWin + kWin - 1) * (2 * kWin - 1) +
         (i % kWin - j % kWin + kWin - 1);
}

__device__ __forceinline__ void axpy4(float* acc, float s, float4 b) {
  acc[0] += s * b.x;
  acc[1] += s * b.y;
  acc[2] += s * b.z;
  acc[3] += s * b.w;
}

__device__ __forceinline__ float dot4(const float* a, float4 b) {
  return a[0] * b.x + a[1] * b.y + a[2] * b.z + a[3] * b.w;
}

// rows [part * C + head * d, + d) of the window's tokens into `dst`
// (kTok rows of DP floats; 0 past d), padded tokens taking `pad` (the bias'
// part, or nullptr for zeros)
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int ld,
                                          int col, int d, const int* tok,
                                          const float* pad) {
  for (int k = threadIdx.x; k < kTok * DP; k += blockDim.x) {
    const int t = k / DP, e = k - t * DP;
    float v = 0.f;
    if (e < d) {
      const int o = tok[t];
      if (o >= 0)
        v = to_f<T>(src[(long long)o * ld + col + e]);
      else if (pad != nullptr)
        v = as_elem<T>(pad[e]);
    }
    dst[k] = v;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ bias,
                           const float* __restrict__ table, T* __restrict__ out,
                           float* __restrict__ lse, Geo g) {
  constexpr int D4 = DP / 4;
  __shared__ float4 ks[kTok * D4];
  __shared__ float4 vs[kTok * D4];
  __shared__ float tb[kRel];
  __shared__ int tok[kTok];
  const int win = blockIdx.x, head = blockIdx.y;
  const int C = g.C, d = C / g.heads, ld = 3 * C;
  for (int t = threadIdx.x; t < kTok; t += blockDim.x)
    tok[t] = token_of(g, win, t);
  for (int e = threadIdx.x; e < kRel; e += blockDim.x)
    tb[e] = table[e * g.heads + head];
  __syncthreads();
  load_rows<T, DP>(reinterpret_cast<float*>(ks), qkv, ld, C + head * d, d,
                   tok, bias + C + head * d);
  load_rows<T, DP>(reinterpret_cast<float*>(vs), qkv, ld, 2 * C + head * d, d,
                   tok, bias + 2 * C + head * d);
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= kTok) return;
  const int oi = tok[i];
  if (oi < 0) return;  // a padded query: cropped away
  float q[DP];
  const T* qrow = qkv + (long long)oi * ld + head * d;
#pragma unroll
  for (int e = 0; e < DP; ++e) q[e] = e < d ? to_f<T>(qrow[e]) : 0.f;

  float s[kTok];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D4; ++c) acc += dot4(q + 4 * c, ks[j * D4 + c]);
    s[j] = acc * g.scale + tb[rel_of(i, j)];
    m = fmaxf(m, s[j]);
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    s[j] = expf(s[j] - m);
    l += s[j];
  }
  float o[DP];
#pragma unroll
  for (int e = 0; e < DP; ++e) o[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
#pragma unroll
    for (int c = 0; c < D4; ++c) axpy4(o + 4 * c, s[j], vs[j * D4 + c]);
  }
  const float inv = 1.f / l;
  T* orow = out + (long long)oi * C + head * d;
#pragma unroll
  for (int e = 0; e < DP; ++e)
    if (e < d) orow[e] = from_f<T>(o[e] * inv);
  lse[((long long)win * g.heads + head) * kTok + i] = m + logf(l);
}

// dynamic shared memory of the backward kernel, in bytes
template <int DP>
constexpr int bwd_smem() {
  return 4 * kTok * DP * 4 + (2 * kTok * kTok + kRel + kTok) * 4 + kTok * 4;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const T* __restrict__ dout,
                           const T* __restrict__ qkv,
                           const float* __restrict__ bias,
                           const float* __restrict__ table,
                           const float* __restrict__ lse, T* __restrict__ dqkv,
                           float* __restrict__ partial, Geo g) {
  constexpr int D4 = DP / 4;
  extern __shared__ float4 smem4[];
  float4* qs = smem4;  // q rows of the window (0 for padded tokens)
  float4* ks = qs + kTok * D4;   // k rows; then a padded key's dK
  float4* vs = ks + kTok * D4;   // v rows; then a padded key's dV
  float4* dos = vs + kTok * D4;  // the output's gradient (0 when padded)
  float* P = reinterpret_cast<float*>(dos + kTok * D4);  // [i][j]
  float* dS = P + kTok * kTok;                            // [i][j]
  float* tb = dS + kTok * kTok;
  float* lse_s = tb + kRel;
  int* tok = reinterpret_cast<int*>(lse_s + kTok);

  const int head = blockIdx.y, groups = gridDim.x;
  const int C = g.C, d = C / g.heads, ld = 3 * C;
  const int nwin = g.B * g.nwh * g.nww;
  const int tid = threadIdx.x;
  for (int e = tid; e < kRel; e += blockDim.x)
    tb[e] = table[e * g.heads + head];
  // this block's partial sums over its windows: table rows tid, tid + 64,
  // tid + 128 (< 169); the bias' k and v parts, entries tid, tid + 64 (< 2d)
  float acc_tb[3] = {0.f, 0.f, 0.f};
  float acc_pad[2] = {0.f, 0.f};

  for (int win = blockIdx.x; win < nwin; win += groups) {
    for (int t = tid; t < kTok; t += blockDim.x) {
      tok[t] = token_of(g, win, t);
      lse_s[t] = lse[((long long)win * g.heads + head) * kTok + t];
    }
    __syncthreads();
    load_rows<T, DP>(reinterpret_cast<float*>(qs), qkv, ld, head * d, d, tok,
                     nullptr);
    load_rows<T, DP>(reinterpret_cast<float*>(ks), qkv, ld, C + head * d, d,
                     tok, bias + C + head * d);
    load_rows<T, DP>(reinterpret_cast<float*>(vs), qkv, ld, 2 * C + head * d,
                     d, tok, bias + 2 * C + head * d);
    load_rows<T, DP>(reinterpret_cast<float*>(dos), dout, C, head * d, d, tok,
                     nullptr);
    __syncthreads();

    // query rows: P, dS, dQ
    if (tid < kTok) {
      const int i = tid, oi = tok[i];
      if (oi < 0) {
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          P[i * kTok + j] = 0.f;
          dS[i * kTok + j] = 0.f;
        }
      } else {
        float q[DP];
        const float* qf = reinterpret_cast<const float*>(qs) + i * DP;
#pragma unroll
        for (int e = 0; e < DP; ++e) q[e] = qf[e];
        const float li = lse_s[i];
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < D4; ++c) acc += dot4(q + 4 * c, ks[j * D4 + c]);
          P[i * kTok + j] = expf(acc * g.scale + tb[rel_of(i, j)] - li);
        }
        float go[DP];
        const float* gf = reinterpret_cast<const float*>(dos) + i * DP;
#pragma unroll
        for (int e = 0; e < DP; ++e) go[e] = gf[e];
        float dp[kTok];
        float rowsum = 0.f;
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < D4; ++c) acc += dot4(go + 4 * c, vs[j * D4 + c]);
          dp[j] = acc;
          rowsum += P[i * kTok + j] * acc;
        }
        float dq[DP];
#pragma unroll
        for (int e = 0; e < DP; ++e) dq[e] = 0.f;
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          const float ds = P[i * kTok + j] * (dp[j] - rowsum);
          dS[i * kTok + j] = ds;
#pragma unroll
          for (int c = 0; c < D4; ++c) axpy4(dq + 4 * c, ds, ks[j * D4 + c]);
        }
        T* row = dqkv + (long long)oi * ld + head * d;
#pragma unroll
        for (int e = 0; e < DP; ++e)
          if (e < d) row[e] = from_f<T>(dq[e] * g.scale);
      }
    }
    __syncthreads();

    // key rows: dV = P^T dO, dK = scale dS^T Q
    if (tid < kTok) {
      const int j = tid, oj = tok[j];
      float dv[DP], dk[DP];
#pragma unroll
      for (int e = 0; e < DP; ++e) {
        dv[e] = 0.f;
        dk[e] = 0.f;
      }
#pragma unroll 7
      for (int i = 0; i < kTok; ++i) {
        const float p = P[i * kTok + j], ds = dS[i * kTok + j];
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          axpy4(dv + 4 * c, p, dos[i * D4 + c]);
          axpy4(dk + 4 * c, ds, qs[i * D4 + c]);
        }
      }
      if (oj >= 0) {
        T* row = dqkv + (long long)oj * ld + head * d;
#pragma unroll
        for (int e = 0; e < DP; ++e)
          if (e < d) {
            row[C + e] = from_f<T>(dk[e] * g.scale);
            row[2 * C + e] = from_f<T>(dv[e]);
          }
      } else {
        float* kf = reinterpret_cast<float*>(ks) + j * DP;
        float* vf = reinterpret_cast<float*>(vs) + j * DP;
#pragma unroll
        for (int e = 0; e < DP; ++e) {
          kf[e] = dk[e] * g.scale;
          vf[e] = dv[e];
        }
      }
    }
    __syncthreads();

    // the table's entries, and the padded keys' k and v gradients
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = tid + r * kThreads;
      if (e < kRel) {
        const int dy = e / (2 * kWin - 1) - (kWin - 1);
        const int dx = e % (2 * kWin - 1) - (kWin - 1);
        float acc = 0.f;
        for (int yi = max(0, dy); yi < min(kWin, kWin + dy); ++yi)
          for (int xi = max(0, dx); xi < min(kWin, kWin + dx); ++xi)
            acc += dS[(yi * kWin + xi) * kTok + (yi - dy) * kWin + (xi - dx)];
        acc_tb[r] += acc;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * kThreads;
      if (e < 2 * d) {
        const float* src = reinterpret_cast<const float*>(e < d ? ks : vs);
        const int col = e < d ? e : e - d;
        float acc = 0.f;
        for (int j = 0; j < kTok; ++j)
          if (tok[j] < 0) acc += src[j * DP + col];
        acc_pad[r] += acc;
      }
    }
    __syncthreads();  // the next window overwrites the shared rows
  }

  const int width = kRel + 2 * d;
  float* dst = partial + ((long long)head * groups + blockIdx.x) * width;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    if (tid + r * kThreads < kRel) dst[tid + r * kThreads] = acc_tb[r];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (tid + r * kThreads < 2 * d) dst[kRel + tid + r * kThreads] = acc_pad[r];
}

// the blocks' partials of each head, added in block order: the table's
// gradient (169, heads), and the bias' (3C): q part 0, k and v parts from
// the padded keys
__global__ void window_attn_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dtable,
                                          float* __restrict__ dbias, int heads,
                                          int C, int groups) {
  const int head = blockIdx.x, e = threadIdx.x;
  const int d = C / heads, width = kRel + 2 * d;
  if (e >= width) return;
  const float* src = partial + (long long)head * groups * width + e;
  float acc = 0.f;
  for (int gi = 0; gi < groups; ++gi) acc += src[(long long)gi * width];
  if (e < kRel) {
    dtable[e * heads + head] = acc;
  } else {
    const int k = e - kRel;  // k part [0, d), v part [d, 2d)
    dbias[(k < d ? C : 2 * C - d) + head * d + k] = acc;
    if (k < d) dbias[head * d + k] = 0.f;
  }
}

// the reduction of a backward's partials, (heads, groups, 169 + 2d)
inline int reduce_partials(const float* partial, float* dtable, float* dbias,
                           const Geo& g, int groups, cudaStream_t stream) {
  const int d = g.C / g.heads;
  const int threads = ((kRel + 2 * d + 31) / 32) * 32;
  window_attn_reduce_kernel<<<g.heads, threads, 0, stream>>>(
      partial, dtable, dbias, g.heads, g.C, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_fwd(const void* qkv, const float* bias, const float* table,
               void* out, float* lse, const Geo& g, cudaStream_t stream) {
  const dim3 grid(g.B * g.nwh * g.nww, g.heads);
  window_attn_fwd_kernel<T, DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), bias, table, static_cast<T*>(out), lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_bwd(const void* dout, const void* qkv, const float* bias,
               const float* table, const float* lse, void* dqkv,
               float* partial, float* dtable, float* dbias, const Geo& g,
               int groups, cudaStream_t stream) {
  constexpr int smem = bwd_smem<DP>();
  static bool opted = false;  // one opt-in above 48 KB per instantiation
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attn_bwd_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid(groups, g.heads);
  window_attn_bwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(qkv), bias, table,
      lse, static_cast<T*>(dqkv), partial, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_partials(partial, dtable, dbias, g, groups, stream);
}

// DP: the head dim rounded up to a multiple of 8, up to 40
template <typename T>
int fwd_for(const void* qkv, const float* bias, const float* table,
            void* out, float* lse, const Geo& g, cudaStream_t stream) {
  switch ((g.C / g.heads + 7) / 8 * 8) {
    case 8: return launch_fwd<T, 8>(qkv, bias, table, out, lse, g, stream);
    case 16: return launch_fwd<T, 16>(qkv, bias, table, out, lse, g, stream);
    case 24: return launch_fwd<T, 24>(qkv, bias, table, out, lse, g, stream);
    case 32: return launch_fwd<T, 32>(qkv, bias, table, out, lse, g, stream);
    case 40: return launch_fwd<T, 40>(qkv, bias, table, out, lse, g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_for(const void* dout, const void* qkv, const float* bias,
            const float* table, const float* lse, void* dqkv, float* partial,
            float* dtable, float* dbias, const Geo& g, int groups,
            cudaStream_t stream) {
#define WA_BWD(DP)                                                       \
  return launch_bwd<T, DP>(dout, qkv, bias, table, lse, dqkv, partial,  \
                           dtable, dbias, g, groups, stream)
  switch ((g.C / g.heads + 7) / 8 * 8) {
    case 8: WA_BWD(8);
    case 16: WA_BWD(16);
    case 24: WA_BWD(24);
    case 32: WA_BWD(32);
    case 40: WA_BWD(40);
  }
#undef WA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
