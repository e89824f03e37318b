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
// (bf16 tensor cores) or ~20 (f32 CUDA cores). The least traffic is q, k and
// v of the real tokens read once and the output written once (forward); q,
// k, v, the output's gradient and the softmax's log-sum read, and dq, dk, dv
// written (backward).
//
// Layout and addressing. q, k and v are read straight from the qkv
// projection's output in token layout, (B, H, W, 3C) with channel
// part * C + head * d + e; the output (B, H, W, C) and dqkv are written in
// the same layout. The map is centre-padded to whole windows by addressing
// alone: a token outside the map is a padded one, whose key and value are
// the projection's bias (the source pads with zeros before the projection),
// rounded to the element type as the projection would give it. A padded
// query's output is cropped away, so it is not computed.
//
// Forward design (window_attn_fwd_kernel): one block of 64 threads per
// (window, head). The window's keys and values go to shared memory as f32
// rows padded to DP (a multiple of 4); each of the 49 real-or-padded query
// rows is one thread, which holds its q row and its 49 scores in registers,
// reads every key and value row as float4 values that all lanes of the warp
// share (broadcast, no bank conflict), and keeps the softmax in f32. It
// writes its output row and the softmax's log-sum (lse) for the backward.
//
// Backward design (window_attn_bwd_kernel): blocks of 64 threads, a grid
// of (groups, heads); block g walks windows g, g + groups, ... in order.
// Per window: thread i (a query row) recomputes its probabilities from the
// lse, forms dP = dO V^T and dS = P (dP - rowsum(P dP)) and writes dQ; P
// and dS go to shared memory; thread j (a key row) then forms dV = P^T dO
// and dK = scale dS^T Q and writes them, or, for a padded key, leaves them
// in shared memory; last, the block adds dS into the table's 169 entries
// and the padded keys' dK and dV into the bias's k and v parts, in fixed
// order, in registers that persist over the block's windows. Each block
// writes its partial sums once; window_attn_reduce_kernel adds the blocks'
// partials in block order. No atomics, so the same inputs give the same
// bits on every run.
//
// Sources. The kernels and their launchers are in window_attn.cuh; each
// element type and direction is instantiated in a source of its own
// (window_attn_{fwd,bwd}_{f32,bf16}.cu), which nvcc compiles in parallel.
// This source holds the two C entries.

#include "window_attn.cuh"

extern "C" int advmix_window_attn_fwd(const void* qkv, const void* bias,
                                      const void* table, void* out, void* lse,
                                      int B, int H, int W, int C, int heads,
                                      int top, int left, int nwh, int nww,
                                      float scale, int dtype, void* stream) {
  const advmix_wa::Geo g{B, H, W, C, heads, top, left, nwh, nww, scale};
  const auto run = dtype == 0   ? advmix_wa::fwd_f32
                   : dtype == 1 ? advmix_wa::fwd_bf16
                                : nullptr;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(qkv, static_cast<const float*>(bias),
             static_cast<const float*>(table), out, static_cast<float*>(lse),
             g, static_cast<cudaStream_t>(stream));
}

extern "C" int advmix_window_attn_bwd(const void* dout, const void* qkv,
                                      const void* bias, const void* table,
                                      const void* lse, void* dqkv,
                                      void* partial, void* dtable,
                                      void* dbias, int B, int H, int W, int C,
                                      int heads, int top, int left, int nwh,
                                      int nww, float scale, int dtype,
                                      int groups, void* stream) {
  const advmix_wa::Geo g{B, H, W, C, heads, top, left, nwh, nww, scale};
  const auto run = dtype == 0   ? advmix_wa::bwd_f32
                   : dtype == 1 ? advmix_wa::bwd_bf16
                                : nullptr;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(dout, qkv, static_cast<const float*>(bias),
             static_cast<const float*>(table), static_cast<const float*>(lse),
             dqkv, static_cast<float*>(partial), static_cast<float*>(dtable),
             static_cast<float*>(dbias), g, groups,
             static_cast<cudaStream_t>(stream));
}
