"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests need a CUDA device and nvcc; without a card they skip. The
file imports nothing of JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips `tests/conftest.py`, which imports jax.) The inputs
are `chip_smoke.py`'s, at the eval path's shapes.

Tolerances: decode is bit-equal (the same comparisons, the same f32 adds
of 0.25). OKS: rtol 1e-5, atol 1e-6, since CUDA's `expf` and torch's `exp`
may differ in the last bit. Keep lists: equal.
"""

import numpy as np
import pytest
import torch

from advmix_tpu_torch.native import greedy_from_matrix
from advmix_tpu_torch.ops.cuda.decode_kernel import (decode_heatmaps,
                                                     decode_heatmaps_plain)
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                  oks_matrix_batched,
                                                  oks_matrix_batched_plain)
from advmix_tpu_torch.ops.nms import oks_nms_np
from chip_smoke import decode_inputs, flat_kpts, oks_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_matches_plain(cuda, post_process):
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [(64, 2), (64, 16), (64, 128), (47, 32),
                                 (1, 130), (1, 300)])
def test_cuda_oks_matches_plain(cuda, m, p):
    """M=1 goes through the single-image wrapper (N=130 crosses a tile
    edge); the keep lists of the greedy scan over the kernel's matrices
    equal the numpy OKS-NMS oracle."""
    kpts, scores, areas = oks_inputs(np.random.RandomState(m + p), m, p)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    wrapper = oks_matrix if m == 1 else oks_matrix_batched
    before = wrapper.launches
    got = oks_matrix(kt[0], at[0])[None] if m == 1 else oks_matrix_batched(
        kt, at)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, oks_matrix_batched_plain(kt, at),
                               rtol=1e-5, atol=1e-6)
    sims = got.cpu().numpy()
    for i in range(min(m, 4)):
        keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32), 0.9)
        assert keep == oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                                  scores[i], areas[i], 0.9)
