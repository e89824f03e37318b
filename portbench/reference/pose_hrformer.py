"""Plain PyTorch reference of HRFormer (Yuan et al., "HRFormer:
High-Resolution Transformer for Dense Prediction", NeurIPS 2021), as the
mmpose `HRFormer` backbone under a `HeatmapHead` without deconvolutions.

Float32 `torch.nn`, the layer equations written out: the window attention
pads the (B, H, W, C) map with zeros to whole windows (split as the source
splits it), cuts it into windows, projects every token (a padded token's
key and value are the projection's bias), scales q by d^-0.5, adds the
relative-position bias gathered from its table by the source's
`double_step_seq` index, takes the softmax, multiplies by v, merges the
windows and crops the padding. State names are the published code's
(`stage2.0.branches.0.0.attn.attn.qkv.weight`, `...ffn.dw3x3.weight`,
`stage3.0.fuse_layers.2.0.1.2.weight`) with HRNet's stem and `final_layer`.

Departures from the source, each shared with the program:
- the last module of stage 4 fuses into branch 0 only, as HRNet's does
  (the source's `multiscale_output=True` also computes three coarser fused
  outputs that its head never reads);
- the fuse's upsampling is nearest, as HRNet's and the original HRFormer
  code's;
- BatchNorm is per replica (the source's SyncBN over its 8 cards);
- stochastic depth draws its per-sample masks from a hash of the step
  counter buffer `drop_path_step` (advanced by every train-mode forward)
  and of the call's slot, thresholded by `drop_path_threshold`, instead of
  torch's global RNG: the program draws the same masks, on the CPU and on
  a card, and a replayed CUDA graph draws new ones each iteration;
- `final_layer` is a convolution named as HRNet's (the source's
  `head.final_layer`).

`quant` (the control of the output check, `numerics.fp8_quant`) rounds the
linears' inputs, weights and outputs, both products of the attention
(q k^T and attn v: operands and result) and, through `models.Conv`, every
convolution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .models import Bottleneck, Conv, Upsample, bn, conv_bn

M32 = 0xFFFFFFFF


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return q(F.linear(q(x), q(self.weight), self.bias))


def double_step_seq(step1, len1, step2, len2):
    seq1 = torch.arange(0, step1 * len1, step1)
    seq2 = torch.arange(0, step2 * len2, step2)
    return (seq1[:, None] + seq2[None, :]).reshape(1, -1)


class WindowMSA(nn.Module):
    quant = None

    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        coords = double_step_seq(2 * window - 1, window, 1, window)
        index = (coords + coords.T).flip(1).contiguous()
        self.register_buffer("relative_position_index", index)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        q8 = self.quant or (lambda t: t)
        b, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q8(q8(q) @ q8(k.transpose(-2, -1)))
        rel = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].view(n, n, h)
        attn = torch.softmax(attn + rel.permute(2, 0, 1)[None], dim=-1)
        out = q8(q8(attn) @ q8(v))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LocalWindowSelfAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.window = window
        self.attn = WindowMSA(dim, heads, window)

    def forward(self, x, hh, ww):
        b, n, c = x.shape
        w = self.window
        x = x.view(b, hh, ww, c)
        ph = math.ceil(hh / w) * w - hh
        pw = math.ceil(ww / w) * w - ww
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        nh, nw = (hh + ph) // w, (ww + pw) // w
        x = x.view(b, nh, w, nw, w, c).permute(0, 1, 3, 2, 4, 5)
        out = self.attn(x.reshape(-1, w * w, c))
        out = out.reshape(b, nh, nw, w, w, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hh + ph, ww + pw, c)
        out = out[:, ph // 2:hh + ph // 2, pw // 2:ww + pw // 2]
        return out.reshape(b, n, c)


class CrossFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Conv(dim, hidden, 1)
        self.norm1 = bn(hidden)
        self.dw3x3 = Conv(hidden, hidden, 3, 1, 1, groups=hidden)
        self.norm2 = bn(hidden)
        self.fc2 = Conv(hidden, dim, 1)
        self.norm3 = bn(dim)

    def forward(self, x, hh, ww):
        b, n, c = x.shape
        x = x.permute(0, 2, 1).reshape(b, c, hh, ww)
        x = F.gelu(self.norm1(self.fc1(x)))
        x = F.gelu(self.norm2(self.dw3x3(x)))
        x = F.gelu(self.norm3(self.fc2(x)))
        return x.reshape(b, c, n).permute(0, 2, 1)


def mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def drop_masks(step, thresholds, batch):
    """(slots, batch) f32: 0 where sample n of slot l is dropped, else
    2^24 / (2^24 - threshold), from 32-bit hashes of (step, l, n)."""
    dev = thresholds.device
    slot = torch.arange(thresholds.numel(), device=dev)[:, None]
    n = torch.arange(batch, device=dev)[None, :]
    h = mix32(step & M32)
    h = mix32((h + slot * 0x9E3779B1) & M32)
    h = mix32((h + n) & M32)
    keep = (h >> 8) >= thresholds[:, None]
    inv = 16777216.0 / (16777216 - thresholds).to(torch.float32)
    return keep.to(torch.float32) * inv[:, None]


class HRFormerBlock(nn.Module):
    def __init__(self, dim, heads, window, mlp_ratio, rate, slot):
        super().__init__()
        self.rate, self.slot = rate, slot
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = LocalWindowSelfAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = CrossFFN(dim, int(dim * mlp_ratio))
        self.masks = None

    def drop_path(self, x, call):
        if self.masks is None or self.rate == 0.0:
            return x
        return x * self.masks[self.slot + call][:, None, None]

    def forward(self, x):
        b, c, hh, ww = x.shape
        x = x.reshape(b, c, -1).permute(0, 2, 1)
        x = x + self.drop_path(self.attn(self.norm1(x), hh, ww), 0)
        x = x + self.drop_path(self.ffn(self.norm2(x), hh, ww), 1)
        return x.permute(0, 2, 1).reshape(b, c, hh, ww)


def down_step(cin, cout, last):
    layers = [Conv(cin, cin, 3, 2, 1, groups=cin, bias=False), bn(cin),
              Conv(cin, cout, 1, bias=False), bn(cout)]
    if not last:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class HRFormerModule(nn.Module):
    def __init__(self, branches, ch, multi_out):
        super().__init__()
        n = len(ch)
        self.branches = nn.ModuleList(branches)
        self.fuse_layers = None
        if n > 1:
            rows = []
            for i in range(n if multi_out else 1):
                row = []
                for j in range(n):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(nn.Sequential(
                            Conv(ch[j], ch[i], 1, bias=False), bn(ch[i]),
                            Upsample(2 ** (j - i))))
                    else:
                        row.append(nn.Sequential(*[
                            down_step(ch[j], ch[i] if k == i - j - 1
                                      else ch[j], k == i - j - 1)
                            for k in range(i - j)]))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        ys = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        out = []
        for row in self.fuse_layers:
            acc = 0
            for j, layer in enumerate(row):
                acc = acc + (ys[j] if layer is None else layer(ys[j]))
            out.append(F.relu(acc))
        return out


class HRFormer(nn.Module):
    def __init__(self, extra, num_joints):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = bn(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = bn(64)
        n1 = extra["STAGE1"]["NUM_BLOCKS"][0]
        self.layer1 = nn.Sequential(Bottleneck(64, 64, 1, True),
                                    *[Bottleneck(256, 64)
                                      for _ in range(n1 - 1)])
        stages = [extra[f"STAGE{si}"] for si in (2, 3, 4)]
        depths = [s["NUM_MODULES"] * s["NUM_BLOCKS"][0] for s in stages]
        dpr = [x.item() for x in torch.linspace(
            0, float(extra.get("DROP_PATH_RATE", 0.0)), sum(depths),
            device="cpu")]
        rates = []
        pre = [256]
        for si, s in zip((2, 3, 4), stages):
            cur = list(s["NUM_CHANNELS"])
            trans = []
            for i in range(len(cur)):
                if i < len(pre):
                    trans.append(conv_bn(pre[i], cur[i], 3, 1, True)
                                 if cur[i] != pre[i] else None)
                else:
                    trans.append(nn.Sequential(*[
                        conv_bn(pre[-1], cur[i] if k == i - len(pre)
                                else pre[-1], 3, 2, True)
                        for k in range(i + 1 - len(pre))]))
            setattr(self, f"transition{si - 1}", nn.ModuleList(trans))
            mods = []
            base = sum(depths[:si - 2])
            for m in range(s["NUM_MODULES"]):
                stage_dpr = dpr[base + m * s["NUM_BLOCKS"][0]:]
                branches = []
                for i in range(s["NUM_BRANCHES"]):
                    blocks = []
                    for j in range(s["NUM_BLOCKS"][i]):
                        blocks.append(HRFormerBlock(
                            cur[i], s["NUM_HEADS"][i], s["WINDOW_SIZES"][i],
                            s["MLP_RATIOS"][i], stage_dpr[j], 2 * len(rates)))
                        rates.append(stage_dpr[j])
                    branches.append(nn.Sequential(*blocks))
                mods.append(HRFormerModule(
                    branches, cur, not (si == 4 and m == s["NUM_MODULES"] - 1)))
            setattr(self, f"stage{si}", nn.Sequential(*mods))
            pre = cur
        self.final_layer = Conv(pre[0], num_joints,
                                extra.get("FINAL_CONV_KERNEL", 1), 1, 0,
                                bias=True)
        self.register_buffer("drop_path_step", torch.zeros((),
                                                           dtype=torch.int64))
        self.register_buffer("drop_path_threshold", torch.tensor(
            [int(round(r * 16777216)) for r in rates for _ in (0, 1)],
            dtype=torch.int64))

    def forward(self, x):
        blocks = [m for m in self.modules() if isinstance(m, HRFormerBlock)]
        masks = None
        if self.training:
            masks = drop_masks(self.drop_path_step, self.drop_path_threshold,
                               x.shape[0])
            self.drop_path_step.add_(1)
        for m in blocks:
            m.masks = masks
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si in (2, 3, 4):
            trans = getattr(self, f"transition{si - 1}")
            xs = [xs[i] if t is None else t(xs[i] if i < len(xs) else xs[-1])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{si}")(xs)
        for m in blocks:
            m.masks = None
        return self.final_layer(xs[0])


def pose_net(extra, num_joints):
    return HRFormer(extra, num_joints)
