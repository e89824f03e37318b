// Pairwise OKS matrices for Hopper (sm_90a), for OKS-NMS in COCO eval:
//   S[m,i,k] = (1/J) * sum_j exp(-d2_ijk * invvar_j * 0.5 / ((a_i + a_k)/2 + eps))
// with eps = np.spacing(1) = 2.220446049250313e-16 and invvar = 1/(2 sigma)^2.
//
// Replaces both Pallas TPU kernels of advmix_tpu/ops/pallas/oks_kernel.py:
// oks_matrix_batched_pallas (_oks_image_kernel), M images of P candidates,
// and oks_matrix_pallas (_oks_tile_kernel), one image of N candidates. One
// kernel with an image axis serves both; the Python wrappers, the tile
// chooser and the plain PyTorch version are in
// advmix_tpu_torch/ops/cuda/oks_kernel.py.
//
// Bound: operations at the shapes a COCO val2017 pass has (M in the
// thousands, P = 32 or 128): J exponentials and ~9 f32 operations each per
// entry, against 4 output bytes per entry.
//
// Design:
// - S is symmetric to the bit (dx*dx does not see the sign of dx, a_i + a_k
//   commutes), so only the tiles on and above the diagonal are computed:
//   the grid enumerates the tile pairs (I, K >= I). An off-diagonal block
//   writes its tile and the mirrored one; a diagonal block computes only
//   the micro-tiles on and above the diagonal, folded onto its first 136
//   threads, and fills the rest by mirroring. This halves the exponentials.
// - A block has 16 x 16 threads and each thread a kMicro x kMicro
//   micro-tile, so a tile is 16*kMicro candidates wide and each staged
//   value feeds kMicro entries.
// - A tile's candidates are one contiguous run of the input, loaded
//   linearly as float2 (x, y) and stored joint-major in shared memory, so
//   the compute loop reads a micro-tile's row and column points as 16-byte
//   values, the columns on consecutive addresses across a warp. A diagonal
//   block stages once.
// - The finished tile goes through shared memory, so both the direct and
//   the mirrored stores write whole rows of consecutive addresses. With
//   1 x 1 micro-tiles, which the wrapper takes only for grids too small to
//   fill the card, a thread stores its entry and the mirrored one itself:
//   there the launch's latency counts, not the width of its stores, and
//   the second barrier is saved.
// - The per-joint 1/(2 sigma)^2 table is read from device memory into
//   shared memory: no table travels in the launch's parameters.
// The _rn intrinsics keep nvcc from contracting a multiply and an add into
// an FMA, and the sum over J is sequential, so each step rounds as the
// plain version's separate tensor ops do. Only the P x P entries asked for
// are written: nothing is padded to the TPU's 128-wide tile.

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;  // micro-tiles per tile side
constexpr int kThreads = kSide * kSide;
// micro-tiles on and above a tile's diagonal
constexpr int kDiagMicros = kSide * (kSide + 1) / 2;

template <int kMicro>
struct Shape {
  static constexpr int kTile = kSide * kMicro;
  // float2 per joint row: +2 keeps every row 16-byte aligned and spreads
  // the staging stores of one candidate's joints over the banks
  static constexpr int kStride = kTile + 2;
  static constexpr int kOutStride = kTile + 1;  // conflict-free transpose
  static size_t smem_bytes(int j) {
    return (2 * static_cast<size_t>(j) * kStride * 2 + kTile * kOutStride +
            2 * kTile + j) * sizeof(float);
  }
};

// kMicro consecutive float2 from 16-byte aligned shared memory (8-byte
// aligned for kMicro == 1)
template <int kMicro>
__device__ __forceinline__ void load_micro(const float2* src,
                                           float2 (&dst)[kMicro]) {
  if constexpr (kMicro == 1) {
    dst[0] = src[0];
  } else {
#pragma unroll
    for (int u = 0; u < kMicro; u += 2) {
      const float4 q = *reinterpret_cast<const float4*>(src + u);
      dst[u] = make_float2(q.x, q.y);
      dst[u + 1] = make_float2(q.z, q.w);
    }
  }
}

// Stage `count` candidates (the rest of the tile as zeros) from their
// contiguous run `src` into dst[joint][candidate].
template <int kMicro>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      int count, int j, float2* dst) {
  using S = Shape<kMicro>;
  const int tid = threadIdx.x;
  int c = tid / j;
  int jj = tid - c * j;
  const int dc = kThreads / j;
  const int dj = kThreads - dc * j;
  for (int e = tid; e < S::kTile * j; e += kThreads) {
    dst[jj * S::kStride + c] =
        e < count * j ? __ldg(src + e) : make_float2(0.0f, 0.0f);
    c += dc;
    jj += dj;
    if (jj >= j) {
      jj -= j;
      ++c;
    }
  }
}

template <int kMicro>
__global__ void __launch_bounds__(kThreads)
oks_kernel(const float* __restrict__ kpts, const float* __restrict__ areas,
           const float* __restrict__ invvar, float* __restrict__ out, int p,
           int j, float inv_j) {
  using S = Shape<kMicro>;
  constexpr int kTile = S::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* row_pts = reinterpret_cast<float2*>(smem_raw);  // [j][kStride]
  float2* col_pts = row_pts + j * S::kStride;
  float* tile = reinterpret_cast<float*>(col_pts + j * S::kStride);
  float* row_a = tile + kTile * S::kOutStride;  // [kTile]
  float* col_a = row_a + kTile;
  float* s_invvar = col_a + kTile;  // [j]

  // tile pair (ti, tk >= ti) number blockIdx.x of the upper triangle
  const int tiles = (p + kTile - 1) / kTile;
  int ti = 0;
  int tk = blockIdx.x;
  while (tk >= tiles - ti) {
    tk -= tiles - ti;
    ++ti;
  }
  tk += ti;
  const bool diag = ti == tk;
  const int img = blockIdx.y;
  const int row0 = ti * kTile;
  const int col0 = tk * kTile;
  const int rows = min(kTile, p - row0);
  const int cols = min(kTile, p - col0);
  const int tid = threadIdx.x;

  const float2* pts =
      reinterpret_cast<const float2*>(kpts) + static_cast<size_t>(img) * p * j;
  const float* ar = areas + static_cast<size_t>(img) * p;
  stage<kMicro>(pts + static_cast<size_t>(row0) * j, rows, j, row_pts);
  if (diag) {
    col_pts = row_pts;
  } else {
    stage<kMicro>(pts + static_cast<size_t>(col0) * j, cols, j, col_pts);
  }
  if (tid < kTile) {
    row_a[tid] = tid < rows ? __ldg(ar + row0 + tid) : 0.0f;
    col_a[tid] = tid < cols ? __ldg(ar + col0 + tid) : 0.0f;
  }
  for (int t = tid; t < j; t += kThreads) s_invvar[t] = __ldg(invvar + t);
  __syncthreads();

  // this thread's micro-tile (a, b); in a diagonal tile the 136 micro-tiles
  // with b >= a are folded onto the first threads: rows r and 15 - r of the
  // triangle hold 17 micro-tiles together
  int a = tid / kSide;
  int b = tid % kSide;
  bool active = true;
  if (diag) {
    active = tid < kDiagMicros;
    const int r = tid / (kSide + 1);
    const int c = tid - r * (kSide + 1);
    if (c < kSide - r) {
      a = r;
      b = r + c;
    } else {
      a = kSide - 1 - r;
      b = a + c - (kSide - r);
    }
  }
  active = active && kMicro * a < rows && kMicro * b < cols;
  float* out_img = out + static_cast<size_t>(img) * p * p;

  if (active) {
    float scale[kMicro][kMicro];
    float acc[kMicro][kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
#pragma unroll
      for (int v = 0; v < kMicro; ++v) {
        const float denom = __fadd_rn(
            __fmul_rn(__fadd_rn(row_a[kMicro * a + u], col_a[kMicro * b + v]),
                      0.5f),
            2.220446049250313e-16f);
        scale[u][v] = __fdiv_rn(0.5f, denom);
        acc[u][v] = 0.0f;
      }
    }
    for (int jj = 0; jj < j; ++jj) {
      float2 r[kMicro];
      float2 c[kMicro];
      load_micro<kMicro>(row_pts + jj * S::kStride + kMicro * a, r);
      load_micro<kMicro>(col_pts + jj * S::kStride + kMicro * b, c);
      const float iv = s_invvar[jj];
#pragma unroll
      for (int u = 0; u < kMicro; ++u) {
#pragma unroll
        for (int v = 0; v < kMicro; ++v) {
          const float dx = __fsub_rn(r[u].x, c[v].x);
          const float dy = __fsub_rn(r[u].y, c[v].y);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float e = __fmul_rn(d2, __fmul_rn(iv, scale[u][v]));
          acc[u][v] = __fadd_rn(acc[u][v], expf(-e));
        }
      }
    }
    if constexpr (kMicro == 1) {
      const float s = __fmul_rn(acc[0][0], inv_j);
      out_img[static_cast<size_t>(row0 + a) * p + col0 + b] = s;
      if (!diag || a != b)
        out_img[static_cast<size_t>(col0 + b) * p + row0 + a] = s;
    } else {
#pragma unroll
      for (int u = 0; u < kMicro; ++u) {
#pragma unroll
        for (int v = 0; v < kMicro; ++v) {
          tile[(kMicro * a + u) * S::kOutStride + kMicro * b + v] =
              __fmul_rn(acc[u][v], inv_j);
        }
      }
    }
  }
  if constexpr (kMicro == 1) return;  // stored above
  __syncthreads();

  // the tile itself; below a diagonal tile's diagonal, the mirrored entry
  for (int t = tid; t < kTile * kTile; t += kThreads) {
    const int r = t / kTile;
    const int c = t % kTile;
    if (r < rows && c < cols) {
      const bool computed = !diag || c / kMicro >= r / kMicro;
      out_img[static_cast<size_t>(row0 + r) * p + col0 + c] =
          computed ? tile[r * S::kOutStride + c] : tile[c * S::kOutStride + r];
    }
  }
  if (diag) return;
  // the mirrored tile, read transposed so that the stores follow a row
  for (int t = tid; t < kTile * kTile; t += kThreads) {
    const int r = t / kTile;  // a column candidate
    const int c = t % kTile;  // a row candidate
    if (r < cols && c < rows) {
      out_img[static_cast<size_t>(col0 + r) * p + row0 + c] =
          tile[c * S::kOutStride + r];
    }
  }
}

template <int kMicro>
cudaError_t launch(const float* kpts, const float* areas, const float* invvar,
                   float* out, int m, int p, int j, float inv_j,
                   cudaStream_t stream) {
  using S = Shape<kMicro>;
  const size_t smem = S::smem_bytes(j);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        oks_kernel<kMicro>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int tiles = (p + S::kTile - 1) / S::kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, m);
  oks_kernel<kMicro><<<grid, kThreads, smem, stream>>>(kpts, areas, invvar,
                                                       out, p, j, inv_j);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kpts: (m, p, j, 2) f32, 8-byte aligned; areas: (m, p); invvar: (j,), the
// per-joint 1/(2 sigma)^2; out: (m, p, p); all contiguous on the device.
// inv_j is 1/j rounded to f32 by the caller; micro is the micro-tile side
// (1, 2 or 4: tiles of 16, 32 or 64 candidates); m is at most 65535.
// Launches on `stream`, allocates nothing, returns the CUDA error code.
int advmix_oks_matrix(const float* kpts, const float* areas,
                      const float* invvar, float* out, int m, int p, int j,
                      float inv_j, int micro, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (micro == 1) {
    rc = launch<1>(kpts, areas, invvar, out, m, p, j, inv_j, s);
  } else if (micro == 2) {
    rc = launch<2>(kpts, areas, invvar, out, m, p, j, inv_j, s);
  } else if (micro == 4) {
    rc = launch<4>(kpts, areas, invvar, out, m, p, j, inv_j, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
