"""The steps' debug outputs: the output heatmaps and their decoded peaks,
which the trainer reads back every PRINT_FREQ batches to dump images.

Port of `advmix_tpu/engine/heatmap_debug.py` (reference
`save_debug_images`, `lib/core/function.py:92-95, 194-197`).
"""

from __future__ import annotations

import torch

from ..ops.heatmap import get_max_preds


def debug_outputs(out: torch.Tensor) -> dict:
    """{output (B, J, Hh, Hw), pred_coords (B, J, 2) in heatmap pixels,
    pred_maxvals (B, J, 1)} of NCHW heatmaps, detached."""
    out = out.detach()
    preds, maxvals = get_max_preds(out)
    return {"output": out, "pred_coords": preds, "pred_maxvals": maxvals}
