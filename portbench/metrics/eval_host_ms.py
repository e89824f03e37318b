"""Host ms per sweep batch spent issuing work (to_device, prep, step spans
of the benchmark), the copy of the predictions left out."""
from ._per_iter import host_issue_ms


def read(trace):
    return host_issue_ms(trace)
