"""Device ms per sweep batch of what the eval step launched (two
forwards, flip back, decode, inverse affine)."""
from ._per_iter import ms_per_iter


def read(trace):
    return ms_per_iter(trace.device_s_in("pb.step"), trace)
