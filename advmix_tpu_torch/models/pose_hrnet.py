"""HRNet pose network (W32/W48), NCHW.

Port of `advmix_tpu/models/pose_hrnet.py`, unscanned (reference
`lib/models/pose_hrnet.py:101-500`): a stem of two stride-2 3x3 convs, a
4-Bottleneck layer1, three configured stages of `HighResolutionModule`s
(parallel branches with pairwise fusion: 1x1 conv + nearest upsample for
coarser->finer, chains of stride-2 3x3 convs for finer->coarser) and a
final conv on the highest-resolution branch. Module names are the
reference's torch key paths (`layer1.0.conv1`,
`stage3.2.fuse_layers.0.1.0`, `final_layer`). HRFormer
(`pose_hrformer.py`) builds on the same code: `PoseHighResolutionNet`
with its own `make_module`, and `MultiBranchModule` with its own branches
and finer->coarser fuse steps.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, UpsampleNearest, compute_dtype_of, conv
from .pose_resnet import BasicBlock, Bottleneck

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool):
    layers = [conv(cin, cout, kernel, stride, kernel // 2), BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


def _down_conv_bn(cin: int, cout: int, relu: bool) -> nn.Sequential:
    """HRNet's finer->coarser fuse step: a stride-2 3x3 conv and BN (and a
    ReLU on every step but the last of a chain)."""
    return _conv_bn(cin, cout, 3, 2, relu)


def fuse_layers(out_ch, multi_scale_output: bool, down_step):
    """The pairwise fusion of a multi-branch module whose branches give
    `out_ch` channels (None for one branch): into output i, a coarser
    branch j > i through a 1x1 conv, BN and nearest upsampling by 2^(j-i),
    and a finer one j < i through a chain of i - j stride-2
    `down_step(cin, cout, relu)` steps (the last to i's channels, without
    the ReLU). Only output 0 without `multi_scale_output`."""
    n = len(out_ch)
    if n == 1:
        return None
    fuse = []
    for i in range(n if multi_scale_output else 1):
        row = []
        for j in range(n):
            if j == i:
                row.append(None)
            elif j > i:
                row.append(nn.Sequential(
                    conv(out_ch[j], out_ch[i], 1),
                    BatchNorm2d(out_ch[i]),
                    UpsampleNearest(2 ** (j - i)),
                ))
            else:
                row.append(nn.Sequential(*[
                    down_step(out_ch[j],
                              out_ch[i] if k == i - j - 1 else out_ch[j],
                              k != i - j - 1)
                    for k in range(i - j)
                ]))
        fuse.append(nn.ModuleList(row))
    return nn.ModuleList(fuse)


class MultiBranchModule(nn.Module):
    """Parallel branches (`branches[i]` maps branch i's NCHW features to
    `out_ch[i]` channels), then the fusion of `fuse_layers` with a ReLU on
    each sum: HRNet's module, and HRFormer's with its own branches and
    down steps."""

    def __init__(self, branches, out_ch, multi_scale_output: bool,
                 down_step):
        super().__init__()
        self.num_branches = len(branches)
        self.branches = nn.ModuleList(branches)
        self.fuse_layers = fuse_layers(out_ch, multi_scale_output, down_step)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for row in self.fuse_layers:
            acc = None
            for j, layer in enumerate(row):
                v = ys[j] if layer is None else layer(ys[j])
                acc = v if acc is None else acc + v
            fused.append(torch.relu(acc))
        return fused


class HighResolutionModule(MultiBranchModule):
    """One multi-branch module of residual blocks with full pairwise
    fusion."""

    def __init__(self, num_branches: int, block: str, num_blocks,
                 num_inchannels, num_channels,
                 multi_scale_output: bool = True):
        cls = BLOCKS[block]
        out_ch = [c * cls.expansion for c in num_channels]
        branches = []
        for i in range(num_branches):
            needs_ds = num_inchannels[i] != out_ch[i]
            blocks = [cls(num_inchannels[i], num_channels[i], 1, needs_ds)]
            blocks += [cls(out_ch[i], num_channels[i])
                       for _ in range(1, num_blocks[i])]
            branches.append(nn.Sequential(*blocks))
        super().__init__(branches, out_ch, multi_scale_output,
                         _down_conv_bn)


def _transition(pre, cur) -> nn.ModuleList:
    """Grow/reshape branches between stages
    (`lib/models/pose_hrnet.py:333-372`)."""
    layers = []
    for i in range(len(cur)):
        if i < len(pre):
            layers.append(_conv_bn(pre[i], cur[i], 3, 1, relu=True)
                          if cur[i] != pre[i] else None)
        else:
            n_new = i + 1 - len(pre)
            layers.append(nn.Sequential(*[
                _conv_bn(pre[-1], cur[i] if k == n_new - 1 else pre[-1],
                         3, 2, relu=True)
                for k in range(n_new)
            ]))
    return nn.ModuleList(layers)


def hrnet_module(si: int, m: int, scfg: dict, cur,
                 multi_scale_output: bool) -> nn.Module:
    """Module `m` of stage `si` of HRNet: a `HighResolutionModule`."""
    return HighResolutionModule(
        scfg["NUM_BRANCHES"], scfg["BLOCK"], scfg["NUM_BLOCKS"], cur,
        scfg["NUM_CHANNELS"], multi_scale_output=multi_scale_output)


class PoseHighResolutionNet(nn.Module):
    """Full HRNet; stage configs are the reference's MODEL.EXTRA dicts.
    `stage1_blocks` Bottlenecks make layer1 (HRNet 4, HRFormer 2) and
    `make_module(si, m, scfg, cur, multi_scale_output)` builds each stage
    module from the stage's config and its branches' input channels
    `cur` (HRNet's by default); the stem, the transitions, the stages'
    layout (the last module of stage 4 fuses into branch 0 only) and
    `final_layer` are shared."""

    def __init__(self, stage2_cfg: dict, stage3_cfg: dict, stage4_cfg: dict,
                 num_joints: int = 17, final_conv_kernel: int = 1,
                 stage1_blocks: int = 4, make_module=hrnet_module):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, 1)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv(64, 64, 3, 2, 1)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, 1, True),
            *[Bottleneck(256, 64) for _ in range(stage1_blocks - 1)])

        pre = [256]
        for si, scfg in ((2, stage2_cfg), (3, stage3_cfg), (4, stage4_cfg)):
            # a block HRNet does not build (HRFormer's) keeps its width
            exp = BLOCKS[scfg["BLOCK"]].expansion \
                if scfg["BLOCK"] in BLOCKS else 1
            cur = [c * exp for c in scfg["NUM_CHANNELS"]]
            setattr(self, f"transition{si - 1}", _transition(pre, cur))
            n_mod = scfg["NUM_MODULES"]
            setattr(self, f"stage{si}", nn.Sequential(*[
                make_module(si, m, scfg, cur,
                            not (si == 4 and m == n_mod - 1))
                for m in range(n_mod)
            ]))
            pre = cur
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = conv(pre[0], num_joints, final_conv_kernel, 1, pad,
                                bias=True)

    def stem_and_stages(self, x):
        """The highest-resolution branch's features, in the compute
        dtype: everything before `final_layer`."""
        x = x.to(compute_dtype_of(self, self.conv1))
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si in (2, 3, 4):
            trans = getattr(self, f"transition{si - 1}")
            xs = [
                xs[i] if layer is None
                else layer(xs[i] if i < len(xs) else xs[-1])
                for i, layer in enumerate(trans)
            ]
            xs = getattr(self, f"stage{si}")(xs)
        return xs[0]

    def forward(self, x):
        out = self.final_layer(self.stem_and_stages(x))
        return out.to(torch.promote_types(torch.float32, out.dtype))


def get_pose_net(cfg) -> PoseHighResolutionNet:
    """Registry entry (`lib/models/pose_hrnet.py:495`). USE_SCAN and REMAT
    shape only the JAX program and are ignored."""
    extra = cfg.MODEL.EXTRA
    return PoseHighResolutionNet(
        stage2_cfg=dict(extra.STAGE2),
        stage3_cfg=dict(extra.STAGE3),
        stage4_cfg=dict(extra.STAGE4),
        num_joints=cfg.MODEL.NUM_JOINTS,
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
    )
