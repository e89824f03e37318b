"""HRFormer pose network (Yuan et al., "HRFormer: High-Resolution
Transformer for Dense Prediction", NeurIPS 2021), NCHW between blocks.

HRNet's layout (`pose_hrnet.PoseHighResolutionNet`: the stem of two
stride-2 3x3 convs, Bottleneck layer1, the transitions, three stages of
multi-branch modules whose last fuses into branch 0 only, and a 1x1
`final_layer` on the highest-resolution branch) with transformer blocks in
the branches of stages 2-4. A block (`HRFormerBlock`) on (B, C, H, W):

    x = x + DropPath(WinMSA(LN(x)))
    x = x + DropPath(CrossFFN(LN(x)))

LN is a LayerNorm with eps 1e-6 over the channels. WinMSA centre-pads the
map to whole 7x7 windows, takes `qkv = Linear(C, 3C)` of each token (a
padded token's key and value are the projection's bias), softmax(q k^T *
d^-0.5 + B[rel]) v per window and head with a learned (13 * 13, heads)
table B indexed Swin's way, `proj = Linear(C, C)`, and crops the padding:
the qkv projection and `proj` run here, the rest is the CUDA kernel of
`ops/cuda/window_attention.py` on a card (its plain version on the CPU).
CrossFFN is a 1x1 conv C -> 4C, a 3x3 depthwise conv and a 1x1 conv
4C -> C, each followed by BN and GELU. The fuse's finer->coarser steps are
depthwise-separable (a depthwise 3x3 stride-2 conv, BN, a 1x1 conv, BN, and
a ReLU on every step but a chain's last); its coarser->finer paths are
HRNet's.

Module and state names are the published code's (mmpose `HRFormer`:
`stage3.0.branches.1.0.attn.attn.qkv.weight`,
`...attn.attn.relative_position_bias_table`, `...ffn.dw3x3`,
`stage2.0.fuse_layers.1.0.0.2`), with HRNet's stem and `final_layer`.
Stochastic depth rises linearly from 0 to MODEL.EXTRA.DROP_PATH_RATE over
the stages' blocks, as the published code lays it out (block j of module m
of a stage takes rate number m * NUM_BLOCKS[0] + j of the stage's share).
Its masks are not torch's random numbers: they are a hash of the step
counter buffer `drop_path_step`, which every train-mode forward advances
on the device, and of the call's slot, thresholded by the buffer
`drop_path_threshold` (`layers.drop_path_scales`); both buffers are in the
state dict, so a model loaded from another's state draws the same masks.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.cuda.window_attention import relative_position_index, \
    window_attention
from .layers import BatchNorm2d, Conv2d, DropPath, LayerNorm, Linear, \
    drop_path_scales, drop_path_threshold
from .pose_hrnet import MultiBranchModule, PoseHighResolutionNet


class WindowMSA(nn.Module):
    """The window attention's parameters: the qkv and output projections,
    the relative-position bias table and its index (a buffer kept, as the
    published code keeps it, in the state dict)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)


class LocalWindowSelfAttention(nn.Module):
    """(B, H, W, C) -> (B, H, W, C): the qkv projection, the windowed
    attention (`window_attention`: padding, partition, bias and crop by the
    kernel's addressing) and the output projection."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.attn = WindowMSA(dim, heads, window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn
        out = window_attention(a.qkv(x), a.qkv.bias,
                               a.relative_position_bias_table, a.heads,
                               a.window)
        return a.proj(out)


class CrossFFN(nn.Module):
    """1x1 conv, 3x3 depthwise conv, 1x1 conv, each followed by BN and
    GELU, on NCHW."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1, bias=True)
        self.norm1 = BatchNorm2d(hidden)
        self.dw3x3 = Conv2d(hidden, hidden, 3, 1, 1, groups=hidden, bias=True)
        self.norm2 = BatchNorm2d(hidden)
        self.fc2 = Conv2d(hidden, dim, 1, bias=True)
        self.norm3 = BatchNorm2d(dim)
        self.act = nn.GELU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm1(self.fc1(x)))
        x = self.act(self.norm2(self.dw3x3(x)))
        return self.act(self.norm3(self.fc2(x)))


class HRFormerBlock(nn.Module):
    """One transformer block of a branch; DropPath slots `slot` (the
    attention's residual) and `slot + 1` (the FFN's)."""

    expansion = 1

    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float,
                 drop_rate: float, slot: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = LocalWindowSelfAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.ffn = CrossFFN(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_rate, slot)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.permute(0, 2, 3, 1)  # (B, H, W, C) tokens
        t = t + self.drop_path(self.attn(self.norm1(t)), 0)
        f = self.ffn(self.norm2(t).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        t = t + self.drop_path(f, 1)
        return t.permute(0, 3, 1, 2)


def _down_separable(cin: int, cout: int, relu: bool) -> nn.Sequential:
    """HRFormer's finer->coarser fuse step: a depthwise 3x3 stride-2 conv,
    BN, a 1x1 conv, BN (and a ReLU on every step but a chain's last)."""
    layers = [Conv2d(cin, cin, 3, 2, 1, groups=cin, bias=False),
              BatchNorm2d(cin), Conv2d(cin, cout, 1, bias=False),
              BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class PoseHRFormer(PoseHighResolutionNet):
    """HRFormer for top-down pose estimation, from MODEL.EXTRA: STAGE1's
    NUM_BLOCKS (Bottlenecks), STAGE2-4's NUM_MODULES, NUM_BRANCHES,
    NUM_BLOCKS, NUM_CHANNELS, NUM_HEADS, WINDOW_SIZES and MLP_RATIOS, and
    DROP_PATH_RATE."""

    def __init__(self, extra: dict, num_joints: int = 17):
        stages = [dict(extra[f"STAGE{si}"]) for si in (2, 3, 4)]
        depths = [s["NUM_MODULES"] * s["NUM_BLOCKS"][0] for s in stages]
        rate = float(extra.get("DROP_PATH_RATE", 0.0))
        # the published `torch.linspace(0, rate, sum(depths))`, in f32
        rates = torch.linspace(0.0, rate, sum(depths), device="cpu").tolist()
        starts = [sum(depths[:k]) for k in range(3)]
        slots = []  # each block's drop rate, in construction order

        def make_module(si, m, scfg, cur, multi_scale_output):
            dpr = rates[starts[si - 2] + m * scfg["NUM_BLOCKS"][0]:]
            branches = []
            for i in range(scfg["NUM_BRANCHES"]):
                blocks = []
                for j in range(scfg["NUM_BLOCKS"][i]):
                    blocks.append(HRFormerBlock(
                        cur[i], scfg["NUM_HEADS"][i],
                        scfg["WINDOW_SIZES"][i], scfg["MLP_RATIOS"][i],
                        dpr[j], 2 * len(slots)))
                    slots.append(dpr[j])
                branches.append(nn.Sequential(*blocks))
            return MultiBranchModule(branches, cur, multi_scale_output,
                                     _down_separable)

        super().__init__(*stages, num_joints=num_joints,
                         final_conv_kernel=int(extra.get(
                             "FINAL_CONV_KERNEL", 1)),
                         stage1_blocks=int(extra["STAGE1"]["NUM_BLOCKS"][0]),
                         make_module=make_module)
        thresholds = [drop_path_threshold(r) for r in slots for _ in (0, 1)]
        self.register_buffer("drop_path_step",
                             torch.zeros((), dtype=torch.int64))
        self.register_buffer("drop_path_threshold",
                             torch.tensor(thresholds, dtype=torch.int64))

    @contextlib.contextmanager
    def _drop_paths(self, batch: int):
        """The blocks' DropPath factors for one train-mode forward, drawn
        from `drop_path_step`, which then advances in place."""
        drops = [m for m in self.modules() if isinstance(m, DropPath)]
        scales = drop_path_scales(self.drop_path_step,
                                  self.drop_path_threshold, batch)
        self.drop_path_step.add_(1)
        for m in drops:
            m.scales = scales
        try:
            yield
        finally:
            for m in drops:
                m.scales = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with self._drop_paths(x.shape[0]):
            return super().forward(x)


def get_pose_net(cfg) -> PoseHRFormer:
    """Registry entry (mmpose `HRFormer` with a `HeatmapHead` of no
    deconvolutions: `final_layer` only)."""
    return PoseHRFormer(cfg.MODEL.EXTRA, num_joints=cfg.MODEL.NUM_JOINTS)
