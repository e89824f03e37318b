"""Model FLOPs per AdvMix iteration (G forward and backward, teacher
forward, D forward and backward, D forward and input gradient; counted on
the reference models) over the iteration's wall time, against 989 TFLOP/s
bf16 dense."""
from ._per_iter import mfu


def read(trace):
    return mfu(trace)
