// The window-attention backward kernels in f32, every head size
// (window_attn.cuh): a source of their own, which nvcc builds beside the
// others.

#include "window_attn.cuh"

int advmix_wa::bwd_f32(const void* dout, const void* qkv,
                       const float* bias, const float* table,
                       const float* lse, void* dqkv, float* partial,
                       float* dtable, float* dbias, const Geo& g,
                       int groups, cudaStream_t stream) {
  return bwd_for<float>(dout, qkv, bias, table, lse, dqkv, partial, dtable,
                    dbias, g, groups, stream);
}
