"""Kernels launched per AdvMix iteration in the traced window."""


def read(trace):
    if trace.n_iters == 0:
        return None
    return len(trace.kernels()) / trace.n_iters
