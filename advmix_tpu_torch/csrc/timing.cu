// Kernels that only timing scripts launch (chip_smoke.py through
// advmix_tpu_torch/ops/cuda/timing.py). The port's own paths never call
// them. They are yardsticks for the kernels of decode.cu and oks.cu:
//
// - an empty kernel: the least time a single launch can read under the
//   script's event timing;
// - an expf probe: the rate at which the card retires expf with nothing
//   around it, the ceiling of the OKS kernel's inner loop;
// - the first OKS design (one entry per thread over 16 x 16 tiles, every
//   entry of the square computed, the sigma table in the launch's
//   parameters), the baseline that oks.cu's triangular kernel is timed
//   against.

#include <cuda_runtime.h>

// per-joint 1/(2 sigma)^2 passed by value; part of the C interface, so it
// has external linkage
constexpr int kMaxJoints = 128;
struct InvVar {
  float v[kMaxJoints];
};

namespace {

// ---------------------------------------------------------------------------
// launch floor and expf rate
// ---------------------------------------------------------------------------

__global__ void empty_kernel() {}

constexpr int kProbeLanes = 4;

__global__ void expf_probe_kernel(float* __restrict__ out, int iters,
                                  float x0) {
  float x = x0 + 1e-3f * static_cast<float>(threadIdx.x);
  float acc[kProbeLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kProbeLanes; ++u)
      acc[u] = __fadd_rn(acc[u], expf(-(x + static_cast<float>(u))));
    x += 1e-4f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// ---------------------------------------------------------------------------
// OKS: the first design, one entry per thread
// ---------------------------------------------------------------------------

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
oks_entry_kernel(const float* __restrict__ kpts,
                 const float* __restrict__ areas, const InvVar invvar,
                 float* __restrict__ out, int p, int j, float inv_j) {
  extern __shared__ float smem[];
  float* row_x = smem;  // [j][kTile]
  float* row_y = row_x + j * kTile;
  float* col_x = row_y + j * kTile;
  float* col_y = col_x + j * kTile;
  float* row_a = col_y + j * kTile;  // [kTile]
  float* col_a = row_a + kTile;

  const int img = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const float* pts = kpts + static_cast<size_t>(img) * p * j * 2;
  const float* ar = areas + static_cast<size_t>(img) * p;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  for (int t = tid; t < kTile * j; t += kTile * kTile) {
    const int c = t / j;  // candidate within the tile
    const int jj = t - c * j;
    const int ri = row0 + c;
    const int ci = col0 + c;
    row_x[jj * kTile + c] = ri < p ? pts[(ri * j + jj) * 2] : 0.0f;
    row_y[jj * kTile + c] = ri < p ? pts[(ri * j + jj) * 2 + 1] : 0.0f;
    col_x[jj * kTile + c] = ci < p ? pts[(ci * j + jj) * 2] : 0.0f;
    col_y[jj * kTile + c] = ci < p ? pts[(ci * j + jj) * 2 + 1] : 0.0f;
  }
  if (tid < kTile) {
    row_a[tid] = row0 + tid < p ? ar[row0 + tid] : 0.0f;
    col_a[tid] = col0 + tid < p ? ar[col0 + tid] : 0.0f;
  }
  __syncthreads();

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int i = row0 + ty;
  const int k = col0 + tx;
  if (i >= p || k >= p) return;

  const float denom = __fadd_rn(
      __fmul_rn(__fadd_rn(row_a[ty], col_a[tx]), 0.5f), 2.220446049250313e-16f);
  const float inv_denom = __fdiv_rn(0.5f, denom);
  float acc = 0.0f;
  for (int jj = 0; jj < j; ++jj) {
    const float dx = __fsub_rn(row_x[jj * kTile + ty], col_x[jj * kTile + tx]);
    const float dy = __fsub_rn(row_y[jj * kTile + ty], col_y[jj * kTile + tx]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float e = __fmul_rn(d2, __fmul_rn(invvar.v[jj], inv_denom));
    acc = __fadd_rn(acc, expf(-e));
  }
  out[(static_cast<size_t>(img) * p + i) * p + k] = __fmul_rn(acc, inv_j);
}

}  // namespace

extern "C" {

int advmix_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// blocks x threads threads each add 4 * iters values of expf; out holds
// blocks * threads floats
int advmix_expf_probe(float* out, int blocks, int threads, int iters,
                      void* stream) {
  expf_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, 0.5f);
  return static_cast<int>(cudaGetLastError());
}

// kpts: (m, p, j, 2) f32; areas: (m, p); out: (m, p, p); invvar holds
// j <= kMaxJoints values; inv_j is 1/j rounded to f32 by the caller.
int advmix_oks_matrix_baseline(const float* kpts, const float* areas,
                               InvVar invvar, float* out, int m, int p, int j,
                               float inv_j, void* stream) {
  const dim3 grid((p + kTile - 1) / kTile, (p + kTile - 1) / kTile, m);
  const dim3 block(kTile, kTile);
  const size_t smem =
      (4 * kTile * static_cast<size_t>(j) + 2 * kTile) * sizeof(float);
  oks_entry_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      kpts, areas, invvar, out, p, j, inv_j);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
