"""Device-idle ms per sweep batch inside the program's
`advmix.eval_forward` span (the eval step's two forwards, flip back, shift
and mean): the host time of those forwards in which the card ran nothing.
Nothing where the trace holds no such span."""
from ._per_iter import ms_per_iter

SPAN = "advmix.eval_forward"


def read(trace):
    if SPAN not in trace.program_spans:
        return None
    return ms_per_iter(trace.program_s(SPAN)[1], trace)
