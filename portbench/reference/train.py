"""The reference AdvMix min-max iteration, in plain PyTorch.

AdvMix (Wang et al., CVPR 2021, `lib/core/function.py:train_advmix`): G
turns the three views into per-pixel softmax weights and mixes them; D
trains on the detached mix against the ground-truth heatmaps (weight
1 - alpha) and against a frozen teacher's heatmaps of the clean view
(weight alpha); then G trains to raise D's loss on the same mix, through
D as just updated and again in train mode, so D's BatchNorm statistics
update twice per iteration. Both optimizers are the configuration's
TRAIN.OPTIMIZER, as the program builds them (`optimizer`). Targets are the
unnormalized Gaussians of `JointsDataset.generate_target` and the loss is
`JointsMSELoss` with the repository's default criterion, SmoothL1.
"""

from __future__ import annotations

import copy

import torch


def targets(joints, vis, image_size, heatmap_size, sigma):
    """Gaussian heatmaps (B, J, Hh, Hw) and weights (B, J) from joints
    (B, J, 2) in crop pixels: the peak at int(x / stride + 0.5), a hard
    (6 sigma + 1)^2 window, weight 0 where the window leaves the map."""
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    sx = float(image_size[0]) / w
    sy = float(image_size[1]) / h
    r = int(sigma * 3)
    mx = torch.trunc(joints[..., 0] / sx + 0.5)
    my = torch.trunc(joints[..., 1] / sy + 0.5)
    out = (mx - r >= w) | (my - r >= h) | (mx + r + 1 < 0) | (my + r + 1 < 0)
    weight = vis.to(torch.float32) * (~out).to(torch.float32)
    xs = torch.arange(w, device=joints.device, dtype=torch.float32)
    ys = torch.arange(h, device=joints.device, dtype=torch.float32)
    dx = xs - mx[..., None]
    dy = ys - my[..., None]
    gx = torch.exp(-dx * dx / (2 * sigma ** 2)) * (dx.abs() <= r)
    gy = torch.exp(-dy * dy / (2 * sigma ** 2)) * (dy.abs() <= r)
    t = gy[..., :, None] * gx[..., None, :]
    return t * (weight > 0.5)[..., None, None], weight


def joints_loss(out, target, weight):
    """0.5 x the per-joint mean over batch and pixels of SmoothL1 (beta 1)
    between weighted prediction and target, averaged over joints."""
    b, j = out.shape[:2]
    d = (out.reshape(b, j, -1) - target.reshape(b, j, -1)) * weight[..., None]
    a = d.abs()
    e = torch.where(a < 1.0, 0.5 * d * d, a - 0.5)
    return 0.5 * e.mean(dim=(0, 2)).sum() / j


def mix(logits, views, k=3):
    w = torch.softmax(logits, dim=1)
    return sum(views[:, 3 * i:3 * i + 3] * w[:, i:i + 1] for i in range(k))


def optimizer(name: str, params, lr: float, wd: float):
    """TRAIN.OPTIMIZER `name` over `params`: "adam", Adam without weight
    decay (the program's "adam"); "adamw", AdamW with weight decay `wd`
    (TRAIN.WD)."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, foreach=False)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=wd,
                                 foreach=False)
    raise ValueError(f"the reference has no optimizer {name!r}: "
                     "adam or adamw")


class AdvMixReference:
    """D, G and the teacher (a frozen copy of D as handed in, eval mode),
    each an f32 reference module, and their optimizers (`optimizer`)."""

    def __init__(self, d, g, lr, alpha=0.1, adv_weight=1.0, opt="adam",
                 wd=0.0):
        self.d, self.g = d, g
        self.teacher = copy.deepcopy(d).eval().requires_grad_(False)
        self.opt_d = optimizer(opt, d.parameters(), lr, wd)
        self.opt_g = optimizer(opt, g.parameters(), lr, wd)
        self.alpha, self.adv = alpha, adv_weight
        self.first_grads = None
        self.first_mix_weights = None

    def step(self, views, target, weight) -> dict:
        d, g = self.d.train(), self.g.train()
        logits = g(views)
        if self.first_mix_weights is None:
            self.first_mix_weights = torch.softmax(logits, dim=1).detach()
        mixed = mix(logits, views)
        with torch.no_grad():
            t_out = self.teacher(views[:, :3])
        self.opt_d.zero_grad(set_to_none=True)
        out = d(mixed.detach())
        loss_d = (joints_loss(out, target, weight) * (1 - self.alpha)
                  + joints_loss(out, t_out, weight) * self.alpha)
        loss_d.backward()
        self.opt_d.step()
        del out
        m_in = mixed.detach().requires_grad_(True)
        loss_g = -joints_loss(d(m_in), target, weight) * self.adv
        (dm,) = torch.autograd.grad(loss_g, m_in)
        self.opt_g.zero_grad(set_to_none=True)
        mixed.backward(dm)
        if self.first_grads is None:
            self.first_grads = {"d": grads_of(d), "g": grads_of(g)}
        self.opt_g.step()
        return {"loss_d": loss_d.item(), "loss_g": loss_g.item()}


def grads_of(model) -> dict:
    """{name: a copy of the gradient}; a missing gradient counts as 0."""
    return {k: (torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone())
            for k, p in model.named_parameters()}


def norms(tensors: dict) -> dict:
    """{name: float64 L2 norm}."""
    return {k: float(v.detach().to(torch.float64).norm())
            for k, v in tensors.items()}


def mix_diff(prog: torch.Tensor, ref: torch.Tensor, k: int = 3) -> float:
    """|prog - ref| / |ref - 1/k| over the first step's per-pixel mixing
    weights (B, k, H, W): G's forward at its initial weights, element by
    element, against the weights' spread about the uniform mix. Rows that
    the program did not produce count as the uniform mix; weights of
    another shape read 1."""
    r = ref.detach().to(torch.float64)
    p = prog.detach().to(device=r.device, dtype=torch.float64)
    if p.shape[1:] != r.shape[1:] or p.shape[0] > r.shape[0]:
        return 1.0
    if p.shape[0] < r.shape[0]:
        p = torch.cat([p, torch.full_like(r[p.shape[0]:], 1.0 / k)])
    return float((p - r).norm() / (r - 1.0 / k).norm())


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2]) if n else 0.0


def leaf_numbers(prog: dict, ref: dict, keep=None) -> dict:
    """Leaf by leaf over the leaves in `keep` (all where None), each
    against den = max(|ref|, the median leaf's |ref|):
    "gap": | |prog| - |ref| | / den, the gap of the norms;
    "diff": |prog - ref| / den, element by element, which also sees
    rounding that a norm averages away. Also the norms ("prog", "ref")
    and "den_median"."""
    names = [k for k in ref if keep is None or k in keep]
    out = {"gap": {}, "diff": {}, "prog": {}, "ref": {}}
    for k in names:
        r = ref[k].detach().to(torch.float64)
        p = prog[k].detach().to(device=r.device, dtype=torch.float64)
        out["prog"][k] = float(p.norm())
        out["ref"][k] = float(r.norm())
        out["diff"][k] = float((p - r).norm())
    med = median(list(out["ref"].values()))
    out["den_median"] = med
    for k in names:
        den = max(out["ref"][k], med)
        dp = abs(out["prog"][k] - out["ref"][k])
        out["gap"][k] = dp / den if den > 0 else dp
        out["diff"][k] = out["diff"][k] / den if den > 0 else out["diff"][k]
    return out


def moving_leaves(first_grads: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference first gradient's norm is at least `floor`
    times the median leaf's: the others (a bias in front of a norm) move
    under Adam by round-off alone and are left out of the change."""
    n = norms(first_grads)
    med = median(list(n.values()))
    return {k for k, v in n.items() if v >= floor * med}
