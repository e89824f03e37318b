"""Device ms per AdvMix iteration of what the AdvMix step launched."""
from ._per_iter import ms_per_iter


def read(trace):
    return ms_per_iter(trace.device_s_in("pb.step"), trace)
