"""Device ms per sweep batch of what the eval preprocessor launched: the
pass's corruption, then normalization and targets (a few small kernels)."""
from ._per_iter import ms_per_iter


def read(trace):
    return ms_per_iter(trace.device_s_in("pb.prep"), trace)
