"""Build and load the port's hand-written CUDA kernels.

The sources in `advmix_tpu_torch/csrc/*.cu` have a plain C interface.
`nvcc` compiles each source for `sm_90a` in its own process, all started
together, and links the objects into one shared library under
`advmix_tpu_torch/_build/`, which `ctypes` loads. The build happens at the
first launch (or an explicit `build()`), never at import, so the CPU-only
test environment can import every module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libadvmix_torch_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_JOINTS = 128  # = kMaxJoints in csrc/timing.cu


class InvVar(ctypes.Structure):
    """csrc/timing.cu's per-joint 1/(2 sigma)^2 table, which the baseline
    OKS kernel takes by value in its launch parameters."""
    _fields_ = [("v", _F * MAX_JOINTS)]


# argument types of every `extern "C"` entry of csrc/*.cu; each returns the
# CUDA error code of its launch
SIGNATURES = {
    "advmix_decode_heatmaps": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "advmix_oks_matrix": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # csrc/timing.cu: launched by ops/cuda/timing.py only
    "advmix_empty_launch": [_P],
    "advmix_expf_probe": [_P, _I, _I, _I, _P],
    "advmix_oks_matrix_baseline": [_P, _P, InvVar, _P, _I, _I, _I, _F, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    built = os.path.getmtime(LIB)
    return any(os.path.getmtime(s) > built for s in _sources())


def build(force: bool = False) -> dict:
    """Compile every kernel source in parallel and link the library.

    Returns {"seconds": wall time, "log": nvcc's -Xptxas -v output} (an
    empty log when the library was already current and `force` is off)."""
    if not force and not _stale():
        return {"seconds": 0.0, "log": ""}
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, os.path.basename(LIB))
        subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp_lib,
                        *[obj for _, obj, _ in procs]],
                       check=True, capture_output=True, text=True)
        # rename into place: a concurrent loader never sees a partial file
        os.replace(tmp_lib, LIB)
    return {"seconds": time.perf_counter() - t0, "log": "".join(logs)}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    build()
    lib = ctypes.CDLL(LIB)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def check_cuda_tensor(name: str, t, dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous `dtype` CUDA tensor of `ndim` dims."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_status(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
