// The window-attention backward in bf16: the tensor-core route
// (window_attn.cuh's design note; its parts in window_attn_mma.cuh). A
// source of its own, which nvcc builds beside the others.

#include "window_attn_mma.cuh"

namespace {

// One block of 4 warps for head blockIdx.y; grid (groups, heads), block
// x walking windows x, x + groups, ... in order, the next window's runs
// and log-sums copied while this one is computed. Per window: the row
// phase (warp w: query rows [16 w, 16 w + 16)) recomputes P from the
// log-sums, forms dP = dO v^T, D = rowsum(P dP), dS = P (dP - D) and
// dQ = scale dS k; the column phase (warp w: key rows [16 w, 16 w + 16))
// recomputes P^T and dP^T in the transposed layout, forms dS^T with the
// row phase's D, adds it into the block's per-(key, query) sums, and forms
// dV = P^T dO and dK = scale dS^T q into its own k and v rows (no other
// warp reads them then), adding a padded key's into the block's sums.
// After the last window the block bins its sums into the table's 169
// entries and writes them and the padded keys' sums as its partial
// (window_attn_reduce_kernel adds the blocks' partials).
__global__ void __launch_bounds__(kMmaThreads, 3)
    window_attn_bwd_mma_kernel(const bf16* __restrict__ dout,
                               const bf16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               const float* __restrict__ table,
                               const float* __restrict__ lse,
                               bf16* __restrict__ dqkv,
                               float* __restrict__ partial, Geo g,
                               int words) {
  extern __shared__ uint4 smem[];
  // tiles: [0] q, [1] k, then dK, [2] v, then dV, [3] dO, [4] dQ (staged)
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  uint8_t* raw = reinterpret_cast<uint8_t*>(tiles + 5 * kTileElems);
  float* acc = reinterpret_cast<float*>(raw + 4 * kTok * kRawSlot);
  float* lse_in = acc + kTok * kAccLd;  // [2][64], as copied
  float* lse2 = lse_in + 2 * kRows;     // [64], log2 units; +inf: P = 0
  float* dsum = lse2 + kRows;           // [64]: D of each query
  float* padacc = dsum + kRows;         // [4 warps][dK, dV][40]
  float* tb = padacc + 4 * 2 * kMaxDim;
  int* tokbuf = reinterpret_cast<int*>(tb + kTbLd);  // [2][kTokLd]
  int* rtab = tokbuf + 2 * kTokLd;
  int* rp = rtab + kRows;
  int* runoff = rp + kRows;

  const int d = g.C / g.heads, h0 = blockIdx.y, groups = gridDim.x;
  const Span sp{3 * g.C, g.C, h0, d, words != 0};
  const CopyLane cl = copy_lane(sp);
  const int nwin = g.B * g.nwh * g.nww;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, r0 = 16 * w;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const bf16* Q = tiles;
  bf16* K = tiles + kTileElems;
  bf16* V = tiles + 2 * kTileElems;
  const bf16* dO = tiles + 3 * kTileElems;
  bf16* dQs = tiles + 4 * kTileElems;
  const float* tbh = tb + kTbOff;
  float* pad_w = padacc + w * 2 * kMaxDim;
  const float scale2 = g.scale * kLog2e;

  zero_smem(tiles,
            5 * kTileElems * 2 + 4 * kTok * kRawSlot + kTok * kAccLd * 4);
  for (int k = threadIdx.x; k < kRows; k += blockDim.x) {
    lse2[k] = CUDART_INF_F;
    dsum[k] = 0.f;
  }
  for (int k = threadIdx.x; k < 4 * 2 * kMaxDim; k += blockDim.x)
    padacc[k] = 0.f;
  setup_head(tb, rtab, rp, table, g, h0);
  int win = blockIdx.x, par = 0;
  if (threadIdx.x < kTok && win < nwin)
    tokbuf[threadIdx.x] = token_of(g, win, threadIdx.x);
  __syncthreads();
  const int Ra = rp[ra], Rb = rp[rb], Ca = rtab[ra], Cb = rtab[rb];
  const bool ka = ra < kTok, kb = rb < kTok;  // real key rows
  const float kill_a = ka ? 0.f : -CUDART_INF_F;
  const float kill_b = kb ? 0.f : -CUDART_INF_F;
  // the head's log-sums of window wi (49 floats) into buffer b
  auto copy_lse = [&](int wi, int b) {
    for (int k = threadIdx.x; k < kTok; k += blockDim.x)
      cp_async4(lse_in + b * kRows + k,
                lse + ((long long)wi * g.heads + h0) * kTok + k);
  };
  if (win < nwin) {
    copy_batch<4, 3>(raw, runoff, qkv, dout, sp, tokbuf, 0, 1);
    copy_lse(win, 0);
  }

  for (; win < nwin; win += groups, par ^= 1) {
    const int next = win + groups;
    int* tok = tokbuf + par * kTokLd;
    const int* tok_next = tokbuf + (par ^ 1) * kTokLd;
    cp_async_wait_all();
    __syncthreads();  // this window's runs are in; the last one's are out
    unpack_window<4, 3>(tiles, raw, runoff, bias, 1, sp, cl);
    for (int t = threadIdx.x; t < kTok; t += blockDim.x)
      lse2[t] = tok[t] >= 0 ? lse_in[par * kRows + t] * kLog2e : CUDART_INF_F;
    if (threadIdx.x < kTok && next < nwin)
      tokbuf[(par ^ 1) * kTokLd + threadIdx.x] =
          token_of(g, next, threadIdx.x);
    __syncthreads();  // the tiles; the raw buffer is free
    // the next window's copies, in four batches between the phases
    const int nq = next < nwin ? 4 : 0;
    if (nq) {
      copy_batch<4, 3>(raw, runoff, qkv, dout, sp, tok_next, 0, nq);
      copy_lse(next, par ^ 1);
    }

    // row phase
    {
      float p[kKeyTiles][4], dp[kKeyTiles][4];
      mul_rows_t(p, Q, r0, K, lane);
      const float la = lse2[ra], lb = lse2[rb];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * n + 2 * (lane & 3) + c;
          const int cj = rtab[j];
          const float kill = j < kTok ? 0.f : -CUDART_INF_F;  // keys 49-55
          p[n][c] = exp2_ftz(fmaf(p[n][c], scale2, tbh[Ra + cj]) - la + kill);
          p[n][2 + c] =
              exp2_ftz(fmaf(p[n][2 + c], scale2, tbh[Rb + cj]) - lb + kill);
        }
      if (nq) copy_batch<4, 3>(raw, runoff, qkv, dout, sp, tok_next, 1, nq);
      mul_rows_t(dp, dO, r0, V, lane);
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        da += p[n][0] * dp[n][0] + p[n][1] * dp[n][1];
        db += p[n][2] * dp[n][2] + p[n][3] * dp[n][3];
      }
      da = quad_sum(da);
      db = quad_sum(db);
      if ((lane & 3) == 0) {
        dsum[ra] = da;
        dsum[rb] = db;
      }
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        dp[n][0] = p[n][0] * (dp[n][0] - da);
        dp[n][1] = p[n][1] * (dp[n][1] - da);
        dp[n][2] = p[n][2] * (dp[n][2] - db);
        dp[n][3] = p[n][3] * (dp[n][3] - db);
      }
      float dq[kDimTiles][4];
      mul_tile(dq, dp, K, lane);
      store_rows(dQs, r0, dq, g.scale, g.scale, lane);
    }
    __syncthreads();  // D of every query; every read of k and v as keys

    // column phase
    {
      float pt[kKeyTiles][4], dst[kKeyTiles][4];
      if (nq) copy_batch<4, 3>(raw, runoff, qkv, dout, sp, tok_next, 2, nq);
      mul_rows_t(pt, K, r0, Q, lane);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 8 * n + 2 * (lane & 3) + c;
          const int Ri = rp[i];
          const float li = lse2[i];
          pt[n][c] =
              exp2_ftz(fmaf(pt[n][c], scale2, tbh[Ri + Ca]) - li + kill_a);
          pt[n][2 + c] =
              exp2_ftz(fmaf(pt[n][2 + c], scale2, tbh[Ri + Cb]) - li + kill_b);
        }
      if (nq) copy_batch<4, 3>(raw, runoff, qkv, dout, sp, tok_next, 3, nq);
      mul_rows_t(dst, V, r0, dO, lane);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const int i = 8 * n + 2 * (lane & 3);
        const float d0 = dsum[i], d1 = dsum[i + 1];
        dst[n][0] = pt[n][0] * (dst[n][0] - d0);
        dst[n][1] = pt[n][1] * (dst[n][1] - d1);
        dst[n][2] = pt[n][2] * (dst[n][2] - d0);
        dst[n][3] = pt[n][3] * (dst[n][3] - d1);
        if (ka) {
          float2* s = reinterpret_cast<float2*>(acc + ra * kAccLd + i);
          *s = make_float2(s->x + dst[n][0], s->y + dst[n][1]);
        }
        if (kb) {
          float2* s = reinterpret_cast<float2*>(acc + rb * kAccLd + i);
          *s = make_float2(s->x + dst[n][2], s->y + dst[n][3]);
        }
      }
      // a padded key's dK (scaled) and dV: summed over the warp's rows,
      // then into the block's sums
      const bool pa = ka && tok[ra] < 0, pb = kb && tok[rb] < 0;
      const bool any_pad = __any_sync(0xffffffffu, pa || pb);
      auto add_pad = [&](const float (&x)[kDimTiles][4], float sc,
                         float* dstp) {
#pragma unroll
        for (int nt = 0; nt < kDimTiles; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = (pa ? x[nt][c] * sc : 0.f) +
                      (pb ? x[nt][2 + c] * sc : 0.f);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) dstp[8 * nt + 2 * lane + c] += v;
          }
      };
      float dx[kDimTiles][4];
      mul_tile(dx, pt, dO, lane);
      __syncwarp();  // the warp's reads of its v rows are done
      store_rows(V, r0, dx, 1.f, 1.f, lane);
      if (any_pad) add_pad(dx, 1.f, pad_w + kMaxDim);
      mul_tile(dx, dst, Q, lane);
      store_rows(K, r0, dx, g.scale, g.scale, lane);
      if (any_pad) add_pad(dx, g.scale, pad_w);
    }
    __syncthreads();
    store_window<3>(dqkv, dQs, tiles, sp, cl, tok);
  }

  // the block's partial: the table's 169 entries of the head, binned from
  // the per-(key, query) sums in a fixed order, then the padded keys' dK
  // and dV, summed over the warps in order
  __syncthreads();
  const int width = kRel + 2 * d;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float sum = 0.f;
    if (e < kRel) {
      const int dy = e / (2 * kWin - 1) - (kWin - 1);
      const int dx = e % (2 * kWin - 1) - (kWin - 1);
      for (int yi = max(0, dy); yi < min(kWin, kWin + dy); ++yi)
        for (int xi = max(0, dx); xi < min(kWin, kWin + dx); ++xi)
          sum += acc[((yi - dy) * kWin + xi - dx) * kAccLd + yi * kWin + xi];
    } else {
      // dK elements [0, d), dV elements [d, 2d), at tile columns + s
      const int f = e - kRel, s = shift_of(sp);
      const float* ps = padacc + (f < d ? f + s : kMaxDim + f - d + s);
      for (int wi = 0; wi < 4; ++wi) sum += ps[wi * 2 * kMaxDim];
    }
    partial[((long long)h0 * groups + blockIdx.x) * width + e] = sum;
  }
}

// the kernel's opt-in to its shared memory above 48 KB, made once, at the
// first call (the residency query or an eager launch, before any capture)
int opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  return static_cast<int>(err);
}

}  // namespace

int advmix_wa::bwd_bf16_resident(int* blocks) {
  const int err = opt_in();
  if (err != 0) return err;
  return resident_blocks(window_attn_bwd_mma_kernel, kBwdSmem, blocks);
}

int advmix_wa::bwd_bf16(const void* dout, const void* qkv,
                        const float* bias, const float* table,
                        const float* lse, void* dqkv, float* partial,
                        float* dtable, float* dbias, const Geo& g,
                        int groups, cudaStream_t stream) {
  if (g.C / g.heads > kMaxDim || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int opted = opt_in();
  if (opted != 0) return opted;
  const bool words = g.C % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(qkv) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dout) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dqkv) & 3) == 0;
  const dim3 grid(groups, g.heads);
  window_attn_bwd_mma_kernel<<<grid, kMmaThreads, kBwdSmem, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(qkv), bias,
      table, lse, static_cast<bf16*>(dqkv), partial, g, words ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_partials(partial, dtable, dbias, g, groups, stream);
}
