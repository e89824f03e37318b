// Pairwise OKS matrices for Hopper (sm_90a), for OKS-NMS in COCO eval:
//   S[m,i,k] = (1/J) * sum_j exp(-d2_ijk * invvar_j * 0.5 / ((a_i + a_k)/2 + eps))
// with eps = np.spacing(1) = 2.220446049250313e-16 and invvar = 1/(2 sigma)^2.
//
// Replaces both Pallas TPU kernels of advmix_tpu/ops/pallas/oks_kernel.py:
// oks_matrix_batched_pallas (_oks_image_kernel), M images of P candidates,
// and oks_matrix_pallas (_oks_tile_kernel), one image of N candidates. One
// kernel with an image axis serves both; the Python wrappers and the plain
// PyTorch version are in advmix_tpu_torch/ops/cuda/oks_kernel.py.
//
// Bound: the M*P*P*J exponentials and their ~9 f32 operations each; the
// output is M*P*P*4 bytes and the input a few KB. Design: a 2-D grid of
// kTile x kTile output tiles per image (grid z walks the images). A block
// stages its row and column candidates' x, y and area in shared memory,
// joint-major so a warp's column reads hit consecutive banks; each thread
// computes one (i, k) entry with a sequential loop over J, in the Pallas
// body's order and formula. The _rn intrinsics keep nvcc from contracting
// a multiply and an add into an FMA, so each step rounds as the plain
// version's separate tensor ops do. Only the P x P entries asked for are
// written: nothing is padded to the TPU's 128-wide tile.

#include <cuda_runtime.h>

constexpr int kMaxJoints = 128;  // = MAX_JOINTS in ops/cuda/build.py

// per-joint 1/(2 sigma)^2, passed by value (kernel parameter space); it is
// part of the C interface, so it has external linkage
struct InvVar {
  float v[kMaxJoints];
};

namespace {

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
oks_kernel(const float* __restrict__ kpts, const float* __restrict__ areas,
           const InvVar invvar, float* __restrict__ out, int p, int j,
           float inv_j) {
  extern __shared__ float smem[];
  float* row_x = smem;              // [j][kTile]
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

  const float denom = __fadd_rn(__fmul_rn(__fadd_rn(row_a[ty], col_a[tx]), 0.5f),
                                2.220446049250313e-16f);
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

// kpts: (m, p, j, 2) f32; areas: (m, p); out: (m, p, p); all contiguous on
// the device. invvar holds j <= kMaxJoints values; inv_j is 1/j rounded to
// f32 by the caller.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int advmix_oks_matrix(const float* kpts, const float* areas, InvVar invvar,
                      float* out, int m, int p, int j, float inv_j,
                      void* stream) {
  const dim3 grid((p + kTile - 1) / kTile, (p + kTile - 1) / kTile, m);
  const dim3 block(kTile, kTile);
  const size_t smem = (4 * kTile * static_cast<size_t>(j) + 2 * kTile) *
                      sizeof(float);
  oks_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      kpts, areas, invvar, out, p, j, inv_j);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
