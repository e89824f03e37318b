"""Faults planted under the timed path, for the tests and for the fault
readings of the output check: the program's `make_advmix_step` and
`make_eval_step` are wrapped for the length of a `with planted(kind):`
block.

- "unchanged": the AdvMix step returns its models as it found them;
- "g_unchanged": the AdvMix step returns G as it found it (G's optimizer
  step skipped), D updated as usual;
- "single_bn_update": D's BatchNorm statistics update once per iteration,
  in the D step, and not again in the G step's second train-mode forward;
- "half_batch": the step sees the first half of the batch only (the train
  step takes its mean over that half; the eval step answers the second half
  with the first half's answers);
- "answer": the eval step's first joint of every image is moved four
  heatmap pixels to the right where it is produced.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "g_unchanged", "single_bn_update", "half_batch",
         "answer")


def _half(batch: dict) -> dict:
    return {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _keeping_mix(step, wrapped):
    """`wrapped`, which calls `step`, showing the step's
    `last_mix_weights` as its own after each call."""
    def call(batch):
        out = wrapped(batch)
        call.last_mix_weights = step.last_mix_weights
        return out

    call.last_mix_weights = None
    return call


def _second_forward_frozen_stats(step, model_d):
    """`step` with D's BatchNorm momentum 0 from D's second forward of each
    call on, so that the G step's forward leaves the statistics as the D
    step left them."""
    bns = [m for m in model_d.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]

    def wrapped(batch):
        calls = [0]
        saved = [m.momentum for m in bns]

        def pre(_module, _args):
            calls[0] += 1
            if calls[0] == 2:
                for m in bns:
                    m.momentum = 0.0

        hook = model_d.register_forward_pre_hook(pre)
        try:
            return step(batch)
        finally:
            hook.remove()
            for m, v in zip(bns, saved):
                m.momentum = v

    return wrapped


@contextlib.contextmanager
def planted(kind: str | None):
    if kind is None:
        yield
        return
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; have {KINDS}")
    from advmix_tpu_torch.engine import steps

    orig_adv, orig_eval = steps.make_advmix_step, steps.make_eval_step

    def make_adv(state, *a, **k):
        step = orig_adv(state, *a, **k)
        if kind == "half_batch":
            return _keeping_mix(step, lambda batch: step(_half(batch)))
        if kind == "single_bn_update":
            return _keeping_mix(step, _second_forward_frozen_stats(
                step, state.model_d))
        if kind not in ("unchanged", "g_unchanged"):
            return step
        models = (state.model_g,) if kind == "g_unchanged" \
            else (state.model_d, state.model_g)

        def unchanged(batch):
            kept = [(t, t.detach().clone()) for m in models
                    for t in list(m.parameters()) + list(m.buffers())]
            out = step(batch)
            with torch.no_grad():
                for t, v in kept:
                    t.copy_(v)
            return out

        return _keeping_mix(step, unchanged)

    def make_eval(model, cfg, *a, **k):
        step = orig_eval(model, cfg, *a, **k)
        hm_w = float(cfg.MODEL.HEATMAP_SIZE[0])

        def faulty(batch):
            if kind == "half_batch":
                preds, maxvals, metrics = step(_half(batch))[:3]
                return (torch.cat([preds, preds]),
                        torch.cat([maxvals, maxvals]), metrics)
            preds, maxvals, metrics = step(batch)[:3]
            if kind == "answer":
                preds = preds.clone()
                preds[:, 0, 0] += 4.0 * batch["scale"][:, 0] * 200.0 / hm_w
            return preds, maxvals, metrics

        faulty.forward = step.forward
        return faulty

    steps.make_advmix_step, steps.make_eval_step = make_adv, make_eval
    try:
        yield
    finally:
        steps.make_advmix_step, steps.make_eval_step = orig_adv, orig_eval
