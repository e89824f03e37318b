// The window-attention forward kernels in f32, every head size
// (window_attn.cuh): a source of their own, which nvcc builds beside the
// others.

#include "window_attn.cuh"

int advmix_wa::fwd_f32(const void* qkv, const float* bias,
                       const float* table, void* out, float* lse,
                       const Geo& g, cudaStream_t stream) {
  return fwd_for<float>(qkv, bias, table, out, lse, g, stream);
}
