"""Host ms per AdvMix iteration spent issuing work (to_device, prep,
step spans of the benchmark), the read-back wait left out."""
from ._per_iter import host_issue_ms


def read(trace):
    return host_issue_ms(trace)
