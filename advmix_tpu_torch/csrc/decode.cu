// Heatmap decode for Hopper (sm_90a): per (image, joint) map, the maximum,
// its FIRST row-major index, the POST_PROCESS quarter-pixel offset and the
// mask on non-positive peaks.
//
// Replaces the Pallas TPU kernel advmix_tpu/ops/pallas/decode_kernel.py:
// decode_heatmaps_pallas (_decode_kernel). The Python wrapper, the route
// chooser and the plain PyTorch version it is checked against are in
// advmix_tpu_torch/ops/cuda/decode_kernel.py.
//
// Bound: bytes. The kernel reads each heatmap value once (B*J*H*W*4 bytes,
// 26.7 MB for the eval batch 128 x 17 x 64 x 48) and writes 12 bytes per
// map; the arithmetic is one compare per value.
//
// Design, vector route (decode_warp_kernel): one warp per map, kWarpMaps
// maps per block. A lane reads the map as 16-byte float4 values on the
// read-only path, kLoads of them started back to back before the first
// compare, so a warp keeps kLoads x 512 bytes in flight and the whole batch
// (2,176 warps for the eval batch) is resident on the 132 SMs at once: no
// second wave and no block-wide barrier. The (value, index) pairs are
// reduced with shuffles only, and lane 0 writes the map's result. The route
// needs H*W % 4 == 0 and a 16-byte aligned base.
//
// Scalar route (decode_block_kernel): one block per map with 4-byte loads,
// a shuffle and a shared-memory reduction. It takes any shape and any
// 4-byte aligned base. The wrapper chooses the route from the arguments
// before the launch; neither is a fallback of the other.
//
// The reduction is over pairs under "larger value, then smaller index, a NaN
// largest". It is associative and commutative, so threads may visit a map's
// values in any order and in any vector width, and ties still go to
// np.argmax's first row-major index.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct Best {
  float v;
  int i;
};

// true if candidate (ov, oi) beats the current (v, i)
__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  const bool onan = ov != ov, vnan = v != v;  // NaN tests
  if (onan || vnan) return onan && (!vnan || oi < i);
  return ov > v || (ov == v && oi < i);
}

// The identity of the reduction for a map of n values: the sentinel index n
// loses every tie, so an all -inf map still decodes to index 0.
__device__ __forceinline__ Best none(int n) { return {-CUDART_INF_F, n}; }

__device__ __forceinline__ void take(Best& b, float ov, int oi) {
  if (better(ov, oi, b.v, b.i)) {
    b.v = ov;
    b.i = oi;
  }
}

// four consecutive values starting at index i
__device__ __forceinline__ void take4(Best& b, const float4 q, int i) {
  take(b, q.x, i);
  take(b, q.y, i + 1);
  take(b, q.z, i + 2);
  take(b, q.w, i + 3);
}

// every lane ends with the warp's best pair
__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, b.v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, b.i, off);
    take(b, ov, oi);
  }
  return b;
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // d is 0 or NaN
}

// One thread's epilogue for map number `out`, whose values `map` points
// at: coordinates, the quarter-pixel offset toward the larger neighbour,
// the mask on non-positive peaks. The neighbours are read only when the
// peak is strictly inside, which keeps every read in bounds, and the mask
// comes after the offset.
__device__ __forceinline__ void finish(const float* map, Best b, int h, int w,
                                       int post_process, int out,
                                       float* __restrict__ coords,
                                       float* __restrict__ maxvals) {
  const int py = b.i / w;
  const int px = b.i - py * w;
  float x = static_cast<float>(px);
  float y = static_cast<float>(py);
  if (post_process && px > 1 && px < w - 1 && py > 1 && py < h - 1) {
    const float dx = map[py * w + px + 1] - map[py * w + px - 1];
    const float dy = map[(py + 1) * w + px] - map[(py - 1) * w + px];
    x += sign_of(dx) * 0.25f;
    y += sign_of(dy) * 0.25f;
  }
  const bool valid = b.v > 0.0f;
  coords[2 * out] = valid ? x : 0.0f;
  coords[2 * out + 1] = valid ? y : 0.0f;
  maxvals[out] = b.v;
}

// Vector route: one warp per map, kWarpMaps maps per block, kLoads float4
// loads in flight per lane. kWarpMinBlocks blocks per SM bounds the
// registers so that every warp of the eval batch is resident at once.
constexpr int kWarpMaps = 4;
constexpr int kLoads = 8;
constexpr int kWarpMinBlocks = 5;

__global__ void __launch_bounds__(kWarpMaps * 32, kWarpMinBlocks)
decode_warp_kernel(const float* __restrict__ hm, float* __restrict__ coords,
                   float* __restrict__ maxvals, int maps, int h, int w,
                   int post_process) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpMaps + (threadIdx.x >> 5);
  if (m >= maps) return;  // whole warps leave; no barrier follows
  const int n = h * w;
  const int n4 = n >> 2;
  const float* map = hm + static_cast<size_t>(m) * n;
  const float4* map4 = reinterpret_cast<const float4*>(map);

  Best b = none(n);
  for (int base = lane; base < n4; base += 32 * kLoads) {
    float4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i4 = base + 32 * u;
      // beyond the map: -inf at an index >= n never wins
      q[u] = i4 < n4 ? __ldg(map4 + i4)
                     : make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                   -CUDART_INF_F, -CUDART_INF_F);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      take4(b, q[u], 4 * (base + 32 * u));
  }
  b = warp_best(b);
  if (lane == 0)
    finish(map, b, h, w, post_process, m, coords, maxvals);
}

// Scalar route: one block per map.
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;

__global__ void __launch_bounds__(kBlockThreads)
decode_block_kernel(const float* __restrict__ hm, float* __restrict__ coords,
                    float* __restrict__ maxvals, int h, int w,
                    int post_process) {
  const int n = h * w;
  const float* map = hm + static_cast<size_t>(blockIdx.x) * n;

  Best b = none(n);
  for (int i = threadIdx.x; i < n; i += kBlockThreads)
    take(b, __ldg(map + i), i);
  b = warp_best(b);

  __shared__ float warp_v[kBlockWarps];
  __shared__ int warp_i[kBlockWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_v[warp] = b.v;
    warp_i[warp] = b.i;
  }
  __syncthreads();
  if (warp != 0) return;

  b = lane < kBlockWarps ? Best{warp_v[lane], warp_i[lane]} : none(n);
  b = warp_best(b);
  if (lane == 0)
    finish(map, b, h, w, post_process, blockIdx.x, coords, maxvals);
}

}  // namespace

extern "C" {

// hm: (maps, h, w) f32 contiguous; coords: (maps, 2); maxvals: (maps,).
// route 0: scalar (any shape); route 1: vector, which needs h*w % 4 == 0 and
// hm 16-byte aligned. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
int advmix_decode_heatmaps(const float* hm, float* coords, float* maxvals,
                           int maps, int h, int w, int post_process,
                           int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    decode_warp_kernel<<<(maps + kWarpMaps - 1) / kWarpMaps, kWarpMaps * 32,
                         0, s>>>(hm, coords, maxvals, maps, h, w,
                                 post_process);
  } else if (route == 0) {
    decode_block_kernel<<<maps, kBlockThreads, 0, s>>>(hm, coords, maxvals, h,
                                                       w, post_process);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
