"""What the CUDA kernels' designs rest on, checked on the CPU: the plain
OKS matrix is symmetric to the bit (which licenses computing only the
upper triangle), the wrappers' choosers (decode route, OKS micro-tile) pick
from the arguments as documented, the C entry points match their ctypes
signatures, and each source carries its note. The kernels themselves are
held to their plain versions on a card by tests/test_torch_gpu.py.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from advmix_tpu_torch.ops.cuda import build, timing
from advmix_tpu_torch.ops.cuda.decode_kernel import ROUTES, decode_route
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix_batched_plain,
                                                  oks_micro)
from chip_smoke import oks_bounds, oks_inputs


@pytest.mark.parametrize("p", [2, 17, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_oks_is_symmetric_to_the_bit(seed, p):
    kpts, _, areas = oks_inputs(np.random.RandomState(seed), 3, p)
    s = oks_matrix_batched_plain(torch.from_numpy(kpts),
                                 torch.from_numpy(areas.astype(np.float32)))
    assert torch.equal(s, s.transpose(1, 2))


@pytest.mark.parametrize("h,w,offset,want", [
    (64, 48, 0, "vector"), (16, 12, 0, "vector"), (96, 72, 0, "vector"),
    (17, 13, 0, "scalar"), (5, 5, 0, "scalar"), (3, 2, 0, "scalar"),
    (64, 48, 1, "scalar"), (64, 48, 2, "scalar"), (64, 48, 4, "vector")])
def test_decode_route_from_shape_and_alignment(h, w, offset, want):
    """`offset` floats into a fresh (16-byte aligned) buffer: a contiguous
    view at a storage offset that is not a multiple of 4 floats is not
    16-byte aligned and takes the scalar route."""
    buf = torch.empty(2 * 3 * h * w + offset)
    assert buf.data_ptr() % 16 == 0
    hm = buf[offset:].view(2, 3, h, w)
    assert hm.is_contiguous()
    assert decode_route(h, w, hm.data_ptr()) == want
    assert want in ROUTES


@pytest.mark.parametrize("m,p,want", [
    (47, 32, 1), (1, 130, 1), (1, 300, 1), (64, 2, 1), (64, 16, 1),
    (1600, 32, 2), (64, 128, 2), (4096, 64, 4), (4096, 128, 4)])
def test_oks_micro_from_shape(m, p, want):
    """Tiles no wider than the matrix, and two blocks per SM before a
    larger micro-tile is taken (132 SMs on an H100)."""
    assert oks_micro(m, p, 132) == want


def test_oks_bounds_count_the_triangle():
    (full, full_by), (need, need_by) = oks_bounds(4096, 128)
    assert full_by == "operations" and need_by == "bytes"
    assert need < full
    # P = 32: the output's bytes bound it either way
    assert oks_bounds(1600, 32)[0] == oks_bounds(1600, 32)[1]


@pytest.mark.parametrize("m,p", [(47, 32), (1, 130), (1600, 32)])
def test_oks_needed_bound_is_bytes_at_the_small_shapes(m, p):
    """The bound that the smoke's `kernels` line reports is that of the
    P(P+1)/2 entries needed, never more than the P x P one."""
    (full, _), (need, need_by) = oks_bounds(m, p)
    assert need_by == "bytes" and need <= full


def _c_entries():
    """name -> number of parameters of every `extern "C"` entry."""
    found = {}
    for path in glob.glob(os.path.join(build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r"\bint (advmix_\w+)\(([^)]*)\)", src):
            found[name] = len([a for a in params.split(",") if a.strip()])
    return found


def test_ctypes_signatures_match_the_sources():
    entries = _c_entries()
    assert set(entries) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert len(argtypes) == entries[name], name


@pytest.mark.parametrize("source,replaces", [
    ("decode.cu", ["advmix_tpu/ops/pallas/decode_kernel.py",
                   "decode_heatmaps_pallas"]),
    ("oks.cu", ["advmix_tpu/ops/pallas/oks_kernel.py",
                "oks_matrix_batched_pallas", "oks_matrix_pallas"])])
def test_source_note_names_kernel_bound_and_design(source, replaces):
    with open(os.path.join(build.CSRC, source)) as f:
        note = f.read().split("#include")[0]
    for name in replaces:
        assert name in note
    assert re.search(r"^// Bound: (bytes|operations)", note, re.M)
    assert re.search(r"^// Design", note, re.M)


def test_timing_launchers_refuse_cpu_tensors():
    """The yardstick launchers have no plain version to fall back on."""
    hm = torch.zeros(1, 1, 4, 4)
    for design in ("scalar", "vector"):
        with pytest.raises(ValueError):
            timing.decode_by(design, hm)
    kpts, areas = torch.zeros(1, 2, 17, 2), torch.ones(1, 2)
    with pytest.raises(ValueError):
        timing.oks_by_micro(kpts, areas, 2)
    with pytest.raises(ValueError):
        timing.oks_baseline(kpts, areas)
    with pytest.raises(ValueError):
        timing.expf_probe(torch.zeros(4), 1, 4, 1)
