"""Checkpoints with `torch.save`.

Counterpart of `advmix_tpu/engine/checkpoint.py` (reference
`save_checkpoint`, `lib/utils/utils.py:97-108`, and the AUTO_RESUME logic of
`tools/train.py:238-269`): one `checkpoint.pth` per run, rewritten after
every epoch, with the models, both optimizers, the epoch and the best
score; `model_best.pth`, D's state dict at the best epoch; and
`final_state`, D's state dict (BN running statistics included) at the end,
which `models.load_model_file` and the validate entry point read back. The
JAX package's orbax directories are not reproduced; its weights come in
through `models/convert.py`.

Over several ranks, rank 0 writes every file and the others wait for it at
a barrier; a restore loads the file on every rank and then broadcasts
rank 0's modules (`parallel/dist.py`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel import dist as pdist
from .state import AdvMixState


def _modules(state) -> dict:
    if isinstance(state, AdvMixState):
        return {"model_d": state.model_d, "model_g": state.model_g,
                "optimizer_d": state.optimizer_d,
                "optimizer_g": state.optimizer_g}
    return {"model_d": state.model, "optimizer_d": state.optimizer}


def _pose_model(state):
    return state.model_d if isinstance(state, AdvMixState) else state.model


def _write(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a crash mid-save leaves the last file whole


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.dir = output_dir
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "checkpoint.pth")

    def save(self, epoch: int, state, perf: float, is_best: bool) -> None:
        if pdist.is_main():
            payload = {"epoch": int(epoch), "perf": float(perf),
                       "step": int(state.step)}
            payload.update({k: m.state_dict()
                            for k, m in _modules(state).items()})
            _write(payload, self.path)
            if is_best:
                _write(_pose_model(state).state_dict(),
                       os.path.join(self.dir, "model_best.pth"))
        pdist.barrier()

    def restore(self, state) -> Optional[dict]:
        """Load the last checkpoint into `state` (AUTO_RESUME). Returns
        {"epoch", "perf"} of it, or None when there is none. The teacher is
        not in it: it is rebuilt from the fine-tune weights, as at the
        start."""
        if not os.path.isfile(self.path):
            return None
        payload = torch.load(self.path, map_location="cpu")
        for k, m in _modules(state).items():
            m.load_state_dict(payload[k])
            if isinstance(m, torch.nn.Module):
                pdist.broadcast_module_(m)
        state.step = int(payload["step"])
        return {"epoch": payload["epoch"], "perf": payload["perf"]}


def export_final_state(output_dir: str, state,
                       name: str = "final_state") -> str:
    """The final weights (`tools/train.py:331-337`): D's whole state dict,
    f32, on the CPU."""
    path = os.path.join(output_dir, name)
    if pdist.is_main():
        _write({k: v.detach().cpu() for k, v in
                _pose_model(state).state_dict().items()}, path)
    pdist.barrier()
    return path
