"""Device ms per traced AdvMix iteration of what rank 0 launched inside the
program's `advmix.all_reduce` spans (`parallel/dist.all_reduce_`: D's and
G's gradient means, the BN-buffer means after the D and G steps, the loss
means): the collectives' kernels, which also hold any wait for a slower
rank; the flattening and write-back copies of each coalesced call lie
outside the span. Nothing where the trace holds no such span (one rank)."""
from ._per_iter import ms_per_iter

SPAN = "advmix.all_reduce"


def read(trace):
    if SPAN not in trace.program_spans:
        return None
    return ms_per_iter(trace.program_s(SPAN)[0], trace)
