"""Share of the traced sweep window in which no device operation ran."""
from ._per_iter import idle_pct


def read(trace):
    return idle_pct(trace)
