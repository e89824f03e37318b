// The window-attention forward in bf16: the tensor-core route
// (window_attn.cuh's design note; its parts in window_attn_mma.cuh). A
// source of its own, which nvcc builds beside the others.

#include "window_attn_mma.cuh"

namespace {

// One block of 4 warps for head blockIdx.y, walking windows blockIdx.x,
// + gridDim.x, ...; warp w owns query rows [16 w, 16 w + 16).
__global__ void __launch_bounds__(kMmaThreads, 4)
    window_attn_fwd_mma_kernel(const bf16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               const float* __restrict__ table,
                               bf16* __restrict__ out,
                               float* __restrict__ lse, Geo g, int words) {
  extern __shared__ uint4 smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // q, k, v
  uint8_t* raw = reinterpret_cast<uint8_t*>(tiles + 3 * kTileElems);
  float* tb = reinterpret_cast<float*>(raw + 3 * kTok * kRawSlot);
  int* tokbuf = reinterpret_cast<int*>(tb + kTbLd);  // [2][kTokLd]
  int* rtab = tokbuf + 2 * kTokLd;
  int* rp = rtab + kRows;
  int* runoff = rp + kRows;

  const int d = g.C / g.heads, h0 = blockIdx.y;
  const Span sp{3 * g.C, g.C, h0, d, words != 0};
  const Span osp{g.C, 0, h0, d, words != 0};
  const CopyLane cl = copy_lane(sp);
  const int nwin = g.B * g.nwh * g.nww;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  bf16* Q = tiles;
  const bf16* K = tiles + kTileElems;
  const bf16* V = tiles + 2 * kTileElems;
  const float* tbh = tb + kTbOff;
  const float scale2 = g.scale * kLog2e;

  zero_smem(tiles, 3 * kTileElems * 2 + 3 * kTok * kRawSlot);
  setup_head(tb, rtab, rp, table, g, h0);
  int win = blockIdx.x, par = 0;
  if (threadIdx.x < kTok && win < nwin)
    tokbuf[threadIdx.x] = token_of(g, win, threadIdx.x);
  __syncthreads();
  const int Ra = rp[ra], Rb = rp[rb];
  if (win < nwin)
    copy_batch<3, 3>(raw, runoff, qkv, nullptr, sp, tokbuf, 0, 1);

  for (; win < nwin; win += gridDim.x, par ^= 1) {
    const int next = win + gridDim.x;
    int* tok = tokbuf + par * kTokLd;
    const int* tok_next = tokbuf + (par ^ 1) * kTokLd;
    cp_async_wait_all();
    __syncthreads();  // this window's runs are in; the last one's are out
    unpack_window<3, 3>(tiles, raw, runoff, bias, 1, sp, cl);
    if (threadIdx.x < kTok && next < nwin)
      tokbuf[(par ^ 1) * kTokLd + threadIdx.x] =
          token_of(g, next, threadIdx.x);
    __syncthreads();  // the tiles; the raw buffer is free
    // the next window's copies, in three batches between the phases
    const int nq = next < nwin ? 3 : 0;
    if (nq) copy_batch<3, 3>(raw, runoff, qkv, nullptr, sp, tok_next, 0, nq);

    // S = q k^T scale + B[rel] in the exp2 domain; keys 49-55 masked
    float s[kKeyTiles][4];
    mul_rows_t(s, Q, r0, K, lane);
    if (nq) copy_batch<3, 3>(raw, runoff, qkv, nullptr, sp, tok_next, 1, nq);
    float ma = -CUDART_INF_F, mb = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 8 * n + 2 * (lane & 3) + c;
        const int cj = rtab[j];
        const bool key = j < kTok;
        s[n][c] = key ? fmaf(s[n][c], scale2, tbh[Ra + cj]) : -CUDART_INF_F;
        s[n][2 + c] =
            key ? fmaf(s[n][2 + c], scale2, tbh[Rb + cj]) : -CUDART_INF_F;
        ma = fmaxf(ma, s[n][c]);
        mb = fmaxf(mb, s[n][2 + c]);
      }
    ma = quad_max(ma);
    mb = quad_max(mb);
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[n][c] = exp2_ftz(s[n][c] - ma);
        s[n][2 + c] = exp2_ftz(s[n][2 + c] - mb);
        la += s[n][c];
        lb += s[n][2 + c];
      }
    la = quad_sum(la);
    lb = quad_sum(lb);
    if (nq) copy_batch<3, 3>(raw, runoff, qkv, nullptr, sp, tok_next, 2, nq);

    // O = P v / l, into the warp's own q rows (read above, by it alone)
    float o[kDimTiles][4];
    mul_tile(o, s, V, lane);
    store_rows(Q, r0, o, 1.f / la, 1.f / lb, lane);
    if ((lane & 3) == 0) {
      float* l = lse + ((long long)win * g.heads + h0) * kTok;
      if (ra < kTok && tok[ra] >= 0) l[ra] = (ma + log2f(la)) * kLn2;
      if (rb < kTok && tok[rb] >= 0) l[rb] = (mb + log2f(lb)) * kLn2;
    }
    __syncthreads();
    store_window<1>(out, tiles, tiles, osp, cl, tok);
  }
}

}  // namespace

static_assert(kFwdSmem <= 48 * 1024, "the forward takes no opt-in");

int advmix_wa::fwd_bf16_resident(int* blocks) {
  return resident_blocks(window_attn_fwd_mma_kernel, kFwdSmem, blocks);
}

int advmix_wa::fwd_bf16(const void* qkv, const float* bias,
                        const float* table, void* out, float* lse,
                        const Geo& g, int blocks, cudaStream_t stream) {
  if (g.C / g.heads > kMaxDim || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool words = g.C % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(qkv) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const dim3 grid(blocks, g.heads);
  window_attn_fwd_mma_kernel<<<grid, kMmaThreads, kFwdSmem, stream>>>(
      static_cast<const bf16*>(qkv), bias, table, static_cast<bf16*>(out),
      lse, g, words ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
