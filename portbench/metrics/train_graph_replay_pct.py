"""Share of the traced AdvMix iterations that replayed the step's CUDA
graph: 100 x the program's `advmix.count.graph_replay` events inside the
traced iterations over the traced iterations. Each iteration counts either
a replay or an eager step (`advmix.count.eager_step`), so 100 is the graph
path throughout and a fall-back to the eager step lowers it. Nothing where
the trace holds neither counter."""

STEP_COUNTS = ("advmix.count.graph_replay", "advmix.count.eager_step")


def read(trace):
    if trace.n_iters == 0 or not any(k in trace.counts for k in STEP_COUNTS):
        return None
    return 100.0 * trace.counts.get(STEP_COUNTS[0], 0) / trace.n_iters
