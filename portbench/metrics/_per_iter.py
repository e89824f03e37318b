"""Helpers the per-layer readers share: per-iteration averages over the
traced window."""


def ms_per_iter(seconds: float, trace) -> float | None:
    if trace.n_iters == 0:
        return None
    return seconds / trace.n_iters * 1e3


def host_issue_ms(trace) -> float | None:
    """Host ms per iteration inside the benchmark's spans around the calls
    that issue work (to_device, prep, step), without the read-back wait."""
    return ms_per_iter(trace.host_s_in("pb.to_device", "pb.prep", "pb.step"),
                       trace)


def idle_pct(trace) -> float | None:
    if trace.n_iters == 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def mfu(trace) -> float | None:
    """Model FLOPs of the untraced iterations of the window over their wall
    time, against the bf16 dense peak."""
    from portbench.flops import mfu_pct

    if not trace.iter_s or not trace.flops_per_iter:
        return None
    return mfu_pct(trace.flops_per_iter * len(trace.iter_s),
                   sum(trace.iter_s))
