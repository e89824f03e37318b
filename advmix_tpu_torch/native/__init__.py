"""Host C++ NMS scans and glass_blur's swap composition, built with g++
at first use and loaded via ctypes.

Port of `advmix_tpu/native/__init__.py`. The library is built from this
package's own copy of `nms.cpp` into `advmix_tpu_torch/_build/`, never
beside the JAX package's source. Where no g++ exists, every entry point
falls back to the numpy oracles of `ops/nms.py` or a Python loop, as the
JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

from ..ops.nms import COCO_SIGMAS, oks_nms_np, soft_oks_nms_np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "nms.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(BUILD_DIR, "libadvmix_torch_nms.so")

_P = ctypes.c_void_p


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent test workers may
    # build at once, and a reader must never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def get_lib():
    """The loaded library, building it if needed; None without a g++."""
    try:
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.oks_nms.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_double, _P, _P]
    lib.oks_nms.restype = ctypes.c_int
    lib.soft_oks_nms.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, _P, ctypes.c_int, _P]
    lib.soft_oks_nms.restype = ctypes.c_int
    lib.greedy_from_matrix.argtypes = [_P, _P, ctypes.c_int, ctypes.c_float,
                                       _P]
    lib.greedy_from_matrix.restype = ctypes.c_int
    lib.glass_compose.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _P, _P]
    lib.glass_compose.restype = None
    return lib


def _f64(a):
    return np.ascontiguousarray(a, np.float64)


def oks_nms(kpts: np.ndarray, scores: np.ndarray, areas: np.ndarray,
            thresh: float, sigmas=None):
    """Greedy OKS-NMS over (N, 3J) flat keypoints; kept indices."""
    lib = get_lib()
    if lib is None:
        return oks_nms_np(kpts, scores, areas, thresh, sigmas)
    kpts, scores, areas = _f64(kpts), _f64(scores), _f64(areas)
    sig = _f64(COCO_SIGMAS if sigmas is None else sigmas)
    n, j = kpts.shape[0], kpts.shape[1] // 3
    keep = np.zeros(max(n, 1), np.int32)
    cnt = lib.oks_nms(kpts.ctypes.data, scores.ctypes.data, areas.ctypes.data,
                      n, j, thresh, sig.ctypes.data, keep.ctypes.data)
    return keep[:cnt].tolist()


def soft_oks_nms(kpts: np.ndarray, scores: np.ndarray, areas: np.ndarray,
                 thresh: float, sigmas=None, max_dets: int = 20):
    """Gaussian soft OKS-NMS; kept indices in selection order."""
    lib = get_lib()
    if lib is None:
        return soft_oks_nms_np(kpts, scores, areas, thresh, sigmas,
                               max_dets=max_dets)
    kpts, scores, areas = _f64(kpts), _f64(scores), _f64(areas)
    sig = _f64(COCO_SIGMAS if sigmas is None else sigmas)
    n, j = kpts.shape[0], kpts.shape[1] // 3
    keep = np.zeros(max(n, max_dets, 1), np.int32)
    cnt = lib.soft_oks_nms(kpts.ctypes.data, scores.ctypes.data,
                           areas.ctypes.data, n, j, thresh, sig.ctypes.data,
                           max_dets, keep.ctypes.data)
    return keep[:cnt].tolist()


def greedy_from_matrix(sim: np.ndarray, scores: np.ndarray, thresh: float):
    """Greedy scan over a precomputed (N, N) similarity matrix: visit by
    descending score, keep, suppress every later candidate with
    sim > thresh (the reference keeps sim <= thresh)."""
    n = sim.shape[0]
    if sim.shape != (n, n) or scores.shape != (n,):
        raise ValueError(f"sim {sim.shape} and scores {scores.shape} differ")
    lib = get_lib()
    if lib is None:
        keep = []
        suppressed = np.zeros(n, bool)
        for i in np.argsort(-scores, kind="stable"):
            if suppressed[i]:
                continue
            keep.append(int(i))
            suppressed |= sim[i] > thresh
            suppressed[i] = True
        return keep
    sim = np.ascontiguousarray(sim, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(max(n, 1), np.int32)
    cnt = lib.greedy_from_matrix(sim.ctypes.data, scores.ctypes.data, n,
                                 thresh, keep.ctypes.data)
    return keep[:cnt].tolist()


def glass_compose(h: int, w: int, max_delta: int, iters: int,
                  deltas: np.ndarray) -> np.ndarray:
    """Compose glass_blur's sequential interior pixel swaps into one
    source-index permutation (int32 (h*w,)). deltas: int32 (n_swaps, 2)
    (dx, dy) in draw order, n_swaps = iters * interior_h * interior_w."""
    deltas = np.ascontiguousarray(deltas, np.int32)
    n_h = len(range(h - max_delta, max_delta, -1))
    n_w = len(range(w - max_delta, max_delta, -1))
    expected = iters * n_h * n_w
    if deltas.shape != (expected, 2):
        raise ValueError(
            f"deltas shape {deltas.shape} != ({expected}, 2) for "
            f"h={h} w={w} max_delta={max_delta} iters={iters}")
    src = np.arange(h * w, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        lib.glass_compose(h, w, max_delta, iters, deltas.ctypes.data,
                          src.ctypes.data)
        return src
    return glass_compose_py(h, w, max_delta, iters, deltas)


def glass_compose_py(h: int, w: int, max_delta: int, iters: int,
                     deltas: np.ndarray) -> np.ndarray:
    """The same composition as a Python loop, for a machine without g++
    (fine for test-sized images)."""
    src = np.arange(h * w, dtype=np.int32)
    t = 0
    for _ in range(iters):
        for hh in range(h - max_delta, max_delta, -1):
            base = hh * w
            for ww in range(w - max_delta, max_delta, -1):
                dx, dy = deltas[t]
                t += 1
                p = base + ww
                q = (hh + dy) * w + (ww + dx)
                src[p], src[q] = src[q], src[p]
    return src
