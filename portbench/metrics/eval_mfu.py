"""Model FLOPs per sweep batch (two forwards per image, counted on the
reference model) over the batch's wall time, against 989 TFLOP/s bf16
dense."""
from ._per_iter import mfu


def read(trace):
    return mfu(trace)
