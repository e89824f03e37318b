"""Device ms per traced AdvMix iteration of the window-attention kernels
(`csrc/window_attn.cu`: every kernel whose name holds `window_attn`, forward,
backward and the backward's reduction), read by name, since a replayed
CUDA graph opens no program span. Nothing where the trace holds none."""
from ._per_iter import ms_per_iter

NAME = "window_attn"


def kernels(trace) -> list:
    return [o for o in trace.kernels() if NAME in o.name]


def read(trace):
    ops = kernels(trace)
    if not ops:
        return None
    return ms_per_iter(sum(o.end - o.start for o in ops) * 1e-9, trace)
