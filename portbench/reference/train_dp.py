"""The reference AdvMix iteration over data-parallel ranks, in plain
PyTorch: `train.AdvMixReference` on a global batch cut into contiguous
shards, one a rank, computed one after another on one device as the
program's ranks compute them side by side (`engine/steps.make_advmix_step`
with a `group`: no cross-replica BatchNorm, gradients and BatchNorm
statistics averaged).

Per iteration: G and the mix on each shard (one G); the teacher on each
shard's clean view; D's step, each shard's D forward starting from the same
BatchNorm statistics, its loss's gradient averaged over the shards (each
shard's mean loss over its rows, then the mean over the shards) before one
optimizer step, and the shards' new running statistics averaged after it;
then G's step, each shard's D forward again from those averaged statistics,
the gradient to each shard's mix taken back through G and averaged before
G's optimizer step, and the statistics averaged again. The losses returned
are the means over the shards, as the program's ranks report them; the
first gradients are the averaged ones, and the first mixing weights are
shard 0's (rank 0's).
"""

from __future__ import annotations

import torch

from . import train


def _stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def _load(model, stats: dict) -> None:
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for k, v in stats.items():
            bufs[k].copy_(v)


def _mean_stats(model, shards: list) -> None:
    """Each running mean and variance the mean over the shards' (the
    batch counts are the same on every shard)."""
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for k in shards[0]:
            if k.endswith("num_batches_tracked"):
                bufs[k].copy_(shards[0][k])
            else:
                bufs[k].copy_(torch.stack([s[k] for s in shards]).mean(0))


class AdvMixDPReference(train.AdvMixReference):
    def __init__(self, d, g, lr, ranks: int, alpha=0.1, adv_weight=1.0,
                 opt="adam", wd=0.0):
        super().__init__(d, g, lr, alpha, adv_weight, opt, wd)
        self.ranks = int(ranks)

    def step(self, views, target, weight) -> dict:
        d, g = self.d.train(), self.g.train()
        n = self.ranks
        b = views.shape[0] // n
        rows = [slice(r * b, (r + 1) * b) for r in range(n)]
        logits = [g(views[s]) for s in rows]
        if self.first_mix_weights is None:
            self.first_mix_weights = torch.softmax(logits[0], dim=1).detach()
        mixed = [train.mix(lg, views[s]) for lg, s in zip(logits, rows)]
        with torch.no_grad():
            t_out = [self.teacher(views[s, :3]) for s in rows]

        self.opt_d.zero_grad(set_to_none=True)
        start, new, loss_d = _stats(d), [], 0.0
        for r, s in enumerate(rows):
            _load(d, start)
            out = d(mixed[r].detach())
            loss = (train.joints_loss(out, target[s], weight[s])
                    * (1 - self.alpha)
                    + train.joints_loss(out, t_out[r], weight[s])
                    * self.alpha)
            (loss / n).backward()
            loss_d += loss.item() / n
            new.append(_stats(d))
            del out
        _mean_stats(d, new)
        self.opt_d.step()

        self.opt_g.zero_grad(set_to_none=True)
        start, new, loss_g = _stats(d), [], 0.0
        for r, s in enumerate(rows):
            _load(d, start)
            m_in = mixed[r].detach().requires_grad_(True)
            loss = -train.joints_loss(d(m_in), target[s], weight[s]) \
                * self.adv
            (dm,) = torch.autograd.grad(loss, m_in)
            mixed[r].backward(dm / n)
            loss_g += loss.item() / n
            new.append(_stats(d))
        _mean_stats(d, new)
        if self.first_grads is None:
            self.first_grads = {"d": train.grads_of(d),
                                "g": train.grads_of(g)}
        self.opt_g.step()
        return {"loss_d": loss_d, "loss_g": loss_g}
