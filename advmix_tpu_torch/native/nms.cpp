// Host NMS scans for the port's COCO evaluation, loaded via ctypes
// (advmix_tpu_torch/native/__init__.py).
//
// A copy of the OKS functions of advmix_tpu/native/nms.cpp: greedy and
// soft OKS-NMS in double precision, and the greedy scan over a
// precomputed similarity matrix, which is the host half of the
// device-matrix + host-scan split (the matrix comes from the port's CUDA
// OKS kernel, advmix_tpu_torch/csrc/oks.cu). Semantics match the numpy
// oracles in advmix_tpu_torch/ops/nms.py (reference lib/nms/nms.py).
// Also glass_compose, the host preparation of glass_blur's swap
// permutation (advmix_tpu_torch/ops/corruptions.py). Pure C ABI.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// OKS between keypoint vector g (3j floats) and each row of d (n, 3j).
static void oks_row(const double* g, const double* d, int n, int j,
                    double a_g, const double* a_d, const double* vars,
                    double* out) {
  for (int i = 0; i < n; ++i) {
    const double* di = d + i * 3 * j;
    double s = 0.0;
    double denom = (a_g + a_d[i]) / 2.0 + 2.220446049250313e-16;
    for (int k = 0; k < j; ++k) {
      double dx = di[3 * k] - g[3 * k];
      double dy = di[3 * k + 1] - g[3 * k + 1];
      double e = (dx * dx + dy * dy) / vars[k] / denom / 2.0;
      s += std::exp(-e);
    }
    out[i] = s / j;
  }
}

// Greedy OKS NMS. kpts: (n, 3j) flat; returns number kept.
int oks_nms(const double* kpts, const double* scores, const double* areas,
            int n, int j, double thresh, const double* sigmas,
            int* keep_out) {
  if (n <= 0) return 0;
  std::vector<double> vars(j);
  for (int k = 0; k < j; ++k) {
    double s2 = sigmas[k] * 2.0;
    vars[k] = s2 * s2;
  }
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] > scores[b];
  });
  std::vector<char> suppressed(n, 0);
  std::vector<double> ious(n);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int jj = order[oj];
      if (suppressed[jj]) continue;
      oks_row(kpts + i * 3 * j, kpts + jj * 3 * j, 1, j, areas[i],
              areas + jj, vars.data(), ious.data());
      if (ious[0] > thresh) suppressed[jj] = 1;
    }
  }
  return n_keep;
}

// Soft OKS NMS with gaussian rescoring (lib/nms/nms.py:138-177 semantics).
int soft_oks_nms(const double* kpts, const double* scores_in,
                 const double* areas, int n, int j, double thresh,
                 const double* sigmas, int max_dets, int* keep_out) {
  if (n <= 0) return 0;
  std::vector<double> vars(j);
  for (int k = 0; k < j; ++k) {
    double s2 = sigmas[k] * 2.0;
    vars[k] = s2 * s2;
  }
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return scores_in[a] > scores_in[b];
  });
  std::vector<double> scores(n);
  for (int i = 0; i < n; ++i) scores[i] = scores_in[order[i]];

  int n_keep = 0;
  std::vector<double> iou(1);
  while (!order.empty() && n_keep < max_dets) {
    int i = order.front();
    // rescore the remainder
    std::vector<int> rest(order.begin() + 1, order.end());
    std::vector<double> rest_scores(scores.begin() + 1, scores.end());
    for (size_t r = 0; r < rest.size(); ++r) {
      oks_row(kpts + i * 3 * j, kpts + rest[r] * 3 * j, 1, j, areas[i],
              areas + rest[r], vars.data(), iou.data());
      rest_scores[r] *= std::exp(-(iou[0] * iou[0]) / thresh);
    }
    // stable re-sort by rescored values, descending
    std::vector<int> perm(rest.size());
    std::iota(perm.begin(), perm.end(), 0);
    std::stable_sort(perm.begin(), perm.end(), [&](int a, int b) {
      return rest_scores[a] > rest_scores[b];
    });
    order.resize(rest.size());
    scores.resize(rest.size());
    for (size_t r = 0; r < perm.size(); ++r) {
      order[r] = rest[perm[r]];
      scores[r] = rest_scores[perm[r]];
    }
    keep_out[n_keep++] = i;
  }
  return n_keep;
}

// Greedy suppression given a precomputed similarity matrix (n, n) — the
// host half of the TPU-matrix + host-scan split (nms_kernel.cu analog).
int greedy_from_matrix(const float* sim, const float* scores, int n,
                       float thresh, int* keep_out) {
  if (n <= 0) return 0;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] > scores[b];
  });
  std::vector<char> suppressed(n, 0);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int jj = order[oj];
      if (!suppressed[jj] && sim[i * n + jj] > thresh) suppressed[jj] = 1;
    }
  }
  return n_keep;
}

// Compose imagecorruptions glass_blur's sequential interior pixel swaps
// (`glass_blur`'s descending double loop) into a single source-index
// permutation. `src` must come in as the identity permutation (0..h*w-1);
// deltas holds the (dx, dy) stream in draw order, 2 ints per swap.
void glass_compose(int h, int w, int max_delta, int iters,
                   const int* deltas, int* src) {
  long t = 0;
  for (int it = 0; it < iters; ++it) {
    for (int hh = h - max_delta; hh > max_delta; --hh) {
      for (int ww = w - max_delta; ww > max_delta; --ww) {
        const int dx = deltas[2 * t], dy = deltas[2 * t + 1];
        ++t;
        const int hp = hh + dy, wp = ww + dx;
        const int a = src[hh * w + ww];
        src[hh * w + ww] = src[hp * w + wp];
        src[hp * w + wp] = a;
      }
    }
  }
}

}  // extern "C"
