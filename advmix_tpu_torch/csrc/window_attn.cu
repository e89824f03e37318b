// The window-attention kernels' C entries (design: window_attn.cuh): the
// forward and the backward each pick the route from the element type, f32
// (simt) or bf16 (mma); the third gives the mma kernels' residency.

#include "window_attn.cuh"

extern "C" int advmix_window_attn_fwd(const void* qkv, const void* bias,
                                      const void* table, void* out, void* lse,
                                      int B, int H, int W, int C, int heads,
                                      int top, int left, int nwh, int nww,
                                      float scale, int dtype, int blocks,
                                      void* stream) {
  const advmix_wa::Geo g{B, H, W, C, heads, top, left, nwh, nww, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const float*>(bias);
  const auto t = static_cast<const float*>(table);
  const auto l = static_cast<float*>(lse);
  if (dtype == 0) return advmix_wa::fwd_f32(qkv, b, t, out, l, g, s);
  if (dtype == 1) return advmix_wa::fwd_bf16(qkv, b, t, out, l, g, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const float*>(bias);
  const auto t = static_cast<const float*>(table);
  const auto l = static_cast<const float*>(lse);
  const auto p = static_cast<float*>(partial);
  const auto dt = static_cast<float*>(dtable);
  const auto db = static_cast<float*>(dbias);
  if (dtype == 0)
    return advmix_wa::bwd_f32(dout, qkv, b, t, l, dqkv, p, dt, db, g, groups,
                              s);
  if (dtype == 1)
    return advmix_wa::bwd_bf16(dout, qkv, b, t, l, dqkv, p, dt, db, g, groups,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// *blocks: how many blocks of the mma kernel, the forward's (backward 0) or
// the backward's (1), the current device holds at once over all its SMs
extern "C" int advmix_window_attn_resident(int backward, int* blocks) {
  return backward ? advmix_wa::bwd_bf16_resident(blocks)
                  : advmix_wa::fwd_bf16_resident(blocks);
}
