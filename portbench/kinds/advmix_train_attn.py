"""AdvMix min-max training, one rank, of a pose network with windowed
attention (HRFormer): the `advmix_train` kind, which it subclasses
unchanged, and the least HBM bytes of the attention kernels an iteration
(`trace_extra`: `window_attn_bytes`), which `metrics/window_attn_roofline`
reads.

The program's model module (`advmix_tpu_torch/models/<MODEL.NAME>.py`) is
looked up before anything is built, so a program that lacks it fails at
once with a clear error.

Bytes (`window_attn_bytes`): per block call on a branch of T = B x H x W
tokens, C channels, `heads` heads, e bytes an element (2: the bf16 of
TRAIN.DTYPE), the kernels' least traffic. Forward: q, k and v of the real
tokens read once, the output written once, 4 T C e. Backward: q, k, v and
the output's gradient read, the softmax's f32 log-sum of each real query
read (4 T heads), and dq, dk, dv written, 7 T C e + 4 T heads. The padded
tokens' keys and values are the projection's bias and cost no traffic; the
bias table's 169 x heads entries and the bias are left out (under 0.1%).
An AdvMix iteration makes three forwards of D's attention (the teacher's,
D's on the mix, D's in the G step) and two backwards (D's update; the
gradient to the mix for G).

FLOPs (`train_mfu`) are the training kind's, `flops.advmix_iteration_flops`,
unchanged, so that the metric means the same in every training cell.
"""

from __future__ import annotations

import importlib.util

from . import advmix_train

FORWARDS, BACKWARDS = 3, 2  # per block call and AdvMix iteration


def _branch_calls(extra: dict, image_size) -> list:
    """(tokens per image, channels, heads) of every block call of one
    forward, over stages 2-4: branch i of a stage runs at 1/(4 x 2^i) of
    the input."""
    w, h = image_size
    calls = []
    for si in (2, 3, 4):
        s = extra[f"STAGE{si}"]
        for _ in range(s["NUM_MODULES"]):
            for i in range(s["NUM_BRANCHES"]):
                f = 4 * 2 ** i
                calls += [((h // f) * (w // f), s["NUM_CHANNELS"][i],
                           s["NUM_HEADS"][i])] * s["NUM_BLOCKS"][i]
    return calls


def window_attn_bytes(model_cfg: dict, batch: int, image_size,
                      elem_bytes: int = 2) -> int:
    """Least HBM bytes of the window-attention kernels in one AdvMix
    iteration (module docstring)."""
    total = 0
    for tokens, c, heads in _branch_calls(model_cfg["EXTRA"], image_size):
        t = batch * tokens
        fwd = 4 * t * c * elem_bytes
        bwd = 7 * t * c * elem_bytes + 4 * t * heads
        total += FORWARDS * fwd + BACKWARDS * bwd
    return total


class CellRun(advmix_train.CellRun):
    def __init__(self, ctx):
        name = ctx.cfg.MODEL.NAME
        if importlib.util.find_spec(f"advmix_tpu_torch.models.{name}") is None:
            raise SystemExit(f"[portbench] the program has no "
                             f"advmix_tpu_torch/models/{name}.py: it cannot "
                             f"run {ctx.cell.name}")
        super().__init__(ctx)

    def trace_extra(self) -> dict:
        elem = 2 if str(self.cfg.TRAIN.DTYPE) == "bfloat16" else 4
        return {"window_attn_bytes": window_attn_bytes(
            self.model_cfg, self.batch, self.image_size, elem)}
