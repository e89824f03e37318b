// The window-attention forward kernels in bf16, every head size
// (window_attn.cuh): a source of their own, which nvcc builds beside the
// others.

#include "window_attn.cuh"

int advmix_wa::fwd_bf16(const void* qkv, const float* bias,
                        const float* table, void* out, float* lse,
                        const Geo& g, cudaStream_t stream) {
  return fwd_for<__nv_bfloat16>(qkv, bias, table, out, lse, g, stream);
}
