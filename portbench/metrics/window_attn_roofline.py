"""The window-attention kernels' share of their roofline: their least HBM
traffic an iteration (`kinds/advmix_train_attn.window_attn_bytes`, handed
over as `trace.extra["window_attn_bytes"]`) at 3.35 TB/s, over those
kernels' device time in the traced iterations. Nothing where the trace
holds no such kernel or the cell gives no bytes."""
from portbench.flops import hbm_roofline_pct

from .window_attn_device_ms import kernels


def read(trace):
    ops = kernels(trace)
    nbytes = trace.extra.get("window_attn_bytes")
    if not ops or not nbytes or trace.n_iters == 0:
        return None
    seconds = sum(o.end - o.start for o in ops) * 1e-9
    return hbm_roofline_pct(nbytes * trace.n_iters, seconds)
