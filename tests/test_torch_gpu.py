"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests need a CUDA device and nvcc; without a card they skip. The
file imports nothing of JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips `tests/conftest.py`, which imports jax.) The inputs
are `chip_smoke.py`'s, at the eval path's shapes and at shapes that cross
the kernels' tile, vector and alignment edges.

Tolerances: decode is bit-equal (the same comparisons, the same f32 adds
of 0.25). OKS: rtol 1e-5, atol 1e-6, since CUDA's `expf` and torch's `exp`
may differ in the last bit. Keep lists: equal.
"""

import numpy as np
import pytest
import torch

from advmix_tpu_torch.native import greedy_from_matrix
from advmix_tpu_torch.ops.cuda.decode_kernel import (decode_heatmaps,
                                                     decode_heatmaps_plain,
                                                     decode_route)
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                  oks_matrix_batched,
                                                  oks_matrix_batched_plain)
from advmix_tpu_torch.ops.cuda.timing import (decode_by, oks_baseline,
                                              oks_by_micro)
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


def shifted_view(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a contiguous view one element into a fresh buffer:
    4-byte aligned, neither 8 nor 16."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view_as(t)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,shift,route", [
    ((3, 5, 17, 13), False, "scalar"),   # H*W % 4 != 0
    ((2, 17, 64, 48), True, "scalar"),   # a 4-byte aligned view
    ((2, 17, 64, 48), False, "vector"),
    ((3, 5, 16, 12), False, "vector"),   # 15 maps: not whole blocks of 4
    ((1, 1, 2, 2), False, "vector")])    # one 16-byte value per map
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_routes_match_plain(cuda, shape, shift, route,
                                        post_process):
    rng = np.random.RandomState(sum(shape))
    hm = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    hm[0, 0] = torch.round(hm[0, 0] * 2) / 2  # exact ties
    if shift:
        hm = shifted_view(hm)
    assert decode_route(shape[2], shape[3], hm.data_ptr()) == route
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["scalar", "vector"])
def test_cuda_decode_designs_match_plain(cuda, design):
    """Either route, forced on the aligned eval-path maps, computes the
    same function."""
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    for post_process in (True, False):
        ck, mk = decode_by(design, hm, post_process)
        cp, mp = decode_heatmaps_plain(hm, post_process)
        assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [
    (64, 2), (64, 15), (64, 16), (64, 17), (64, 33), (64, 128), (47, 32),
    (1, 2), (1, 33), (1, 128), (1, 130), (1, 300)])
def test_cuda_oks_matches_plain(cuda, m, p):
    """M=1 goes through the single-image wrapper (N=130 and 300 cross tile
    edges). The matrix is symmetric to the bit, every micro-tile size
    gives the same bits, and the keep lists of the greedy scan over the
    kernel's matrices equal the numpy OKS-NMS oracle."""
    kpts, scores, areas = oks_inputs(np.random.RandomState(m + p), m, p)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    wrapper = oks_matrix if m == 1 else oks_matrix_batched
    before = wrapper.launches
    got = oks_matrix(kt[0], at[0])[None] if m == 1 else oks_matrix_batched(
        kt, at)
    assert wrapper.launches == before + 1
    want = oks_matrix_batched_plain(kt, at)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, got.transpose(1, 2))
    for micro in (1, 2, 4):
        assert torch.equal(oks_by_micro(kt, at, micro), got)
    torch.testing.assert_close(oks_baseline(kt, at), want, rtol=1e-5,
                               atol=1e-6)
    sims = got.cpu().numpy()
    for i in range(min(m, 4)):
        keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32), 0.9)
        assert keep == oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                                  scores[i], areas[i], 0.9)


@pytest.mark.gpu
def test_cuda_oks_takes_a_4_byte_aligned_view(cuda):
    """The kernel loads (x, y) as one 8-byte value; the wrapper realigns a
    view that is not 8-byte aligned."""
    kpts, _, areas = oks_inputs(np.random.RandomState(5), 3, 33)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    assert torch.equal(oks_matrix_batched(shifted_view(kt), shifted_view(at)),
                       oks_matrix_batched(kt, at))
