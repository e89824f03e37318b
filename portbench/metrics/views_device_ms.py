"""Device ms per AdvMix iteration of what the preprocessor launched (the
warp, the 3-view synthesis, the targets)."""
from ._per_iter import ms_per_iter


def read(trace):
    return ms_per_iter(trace.device_s_in("pb.prep"), trace)
