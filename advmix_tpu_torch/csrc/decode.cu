// Heatmap decode for Hopper (sm_90a): per (image, joint) map, the maximum,
// its FIRST row-major index, the POST_PROCESS quarter-pixel offset and the
// mask on non-positive peaks.
//
// Replaces the Pallas TPU kernel advmix_tpu/ops/pallas/decode_kernel.py:
// decode_heatmaps_pallas (_decode_kernel). The Python wrapper and the plain
// PyTorch version it is checked against are in
// advmix_tpu_torch/ops/cuda/decode_kernel.py.
//
// Bound: memory. The kernel reads each heatmap value once (B*J*H*W*4 bytes,
// 26.7 MB for the eval batch 128 x 17 x 64 x 48) and writes 12 bytes per
// map; the arithmetic is one compare per value. Design: one block per map
// over its contiguous H*W row of the NCHW tensor, so a warp's loads are
// coalesced; each thread keeps (max, lowest index) over a strided range,
// then a warp-shuffle and a shared-memory reduction combine the pairs.
// Ties go to the smaller index, which is np.argmax's order. A NaN counts as
// larger than any number, so a map holding one decodes as the plain version
// does (coords 0, maxval NaN).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// true if candidate (ov, oi) beats the current (v, i)
__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  const bool onan = ov != ov, vnan = v != v;  // NaN tests
  if (onan || vnan) return onan && (!vnan || oi < i);
  return ov > v || (ov == v && oi < i);
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // d is 0 or NaN
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ hm, float* __restrict__ coords,
              float* __restrict__ maxvals, int h, int w, int post_process) {
  const int n = h * w;
  const float* map = hm + static_cast<size_t>(blockIdx.x) * n;

  float best = -CUDART_INF_F;
  int best_i = n;  // sentinel: loses every tie, so an all -inf map gives 0
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = __ldg(map + i);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }

  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_best[warp] = best;
    warp_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp != 0) return;

  best = lane < kWarps ? warp_best[lane] : -CUDART_INF_F;
  best_i = lane < kWarps ? warp_idx[lane] : n;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane != 0) return;

  const int py = best_i / w;
  const int px = best_i - py * w;
  float x = static_cast<float>(px);
  float y = static_cast<float>(py);
  // the neighbours are read only when the peak is strictly inside, which
  // keeps every read in bounds
  if (post_process && px > 1 && px < w - 1 && py > 1 && py < h - 1) {
    const float dx = map[py * w + px + 1] - map[py * w + px - 1];
    const float dy = map[(py + 1) * w + px] - map[(py - 1) * w + px];
    x += sign_of(dx) * 0.25f;
    y += sign_of(dy) * 0.25f;
  }
  const bool valid = best > 0.0f;
  coords[2 * blockIdx.x] = valid ? x : 0.0f;
  coords[2 * blockIdx.x + 1] = valid ? y : 0.0f;
  maxvals[blockIdx.x] = best;
}

}  // namespace

extern "C" {

// hm: (maps, h, w) f32 contiguous; coords: (maps, 2); maxvals: (maps,).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int advmix_decode_heatmaps(const float* hm, float* coords, float* maxvals,
                           int maps, int h, int w, int post_process,
                           void* stream) {
  decode_kernel<<<maps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hm, coords, maxvals, h, w, post_process);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
