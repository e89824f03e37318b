"""The decode kernel's share of its roofline: its least traffic (f32
heatmaps read once, (x, y) and the maximum written once) at the HBM's
3.35 TB/s, over the kernel's device time in the trace. Nothing where the
trace holds no decode kernel."""
from portbench.flops import hbm_roofline_pct


def read(trace):
    ops = [o for o in trace.kernels() if "decode" in o.name.lower()]
    nbytes = trace.extra.get("decode_bytes")
    if not ops or not nbytes:
        return None
    seconds = sum(o.end - o.start for o in ops) * 1e-9
    return hbm_roofline_pct(nbytes * len(ops), seconds)
