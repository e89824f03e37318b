"""HigherHRNet bottom-up pose network (W32), NCHW.

Port of `advmix_tpu/models/higher_hrnet.py` (public HigherHRNet spec, Cheng
et al., CVPR 2020): an HRNet trunk giving the 1/4-resolution features, a
1x1 head emitting heatmaps + associative-embedding tagmaps at 1/4, then a
deconv module (ConvTranspose k4 s2 on the concat of the features and the
1/4 predictions, BN, ReLU, NUM_BASIC_BLOCKS BasicBlocks) and a second 1x1
head emitting heatmaps at 1/2.

Module names are those of the official HigherHRNet torch checkpoints, so a
public state dict loads with `load_state_dict(strict=True)`: the trunk's
modules at the top level (`conv1`, `layer1.0.conv1`, `stage4.2...`),
`deconv_layers.<i>.0.{0,1}` for the ConvTranspose2d and its BN,
`deconv_layers.<i>.<j>.0.*` for the BasicBlocks (j >= 1) and
`final_layers.<i>` for the 1x1 heads.

Outputs: a list of two maps in at least f32,
  [ (B, J + T, H/4, W/4)  heatmaps [:, :J] and tags [:, J:],
    (B, J, H/2, W/2)      heatmaps only ],
with T = J under MODEL.TAG_PER_JOINT, else 1. Head 0 is concatenated back
into the deconv module in the compute dtype, as the JAX model does
(`higher_hrnet.py:70-76`).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, conv, conv_transpose
from .pose_hrnet import PoseHighResolutionNet
from .pose_resnet import BasicBlock


class HigherHRNet(PoseHighResolutionNet):
    """The HRNet stem and stages without `final_layer`, plus the heads."""

    def __init__(self, stage2_cfg: dict, stage3_cfg: dict, stage4_cfg: dict,
                 num_joints: int = 17, tag_per_joint: bool = True,
                 num_deconv_layers: int = 1, num_deconv_filters=(32,),
                 cat_output=(True,), num_basic_blocks: int = 4):
        super().__init__(stage2_cfg, stage3_cfg, stage4_cfg, num_joints)
        del self.final_layer
        feat = stage2_cfg["NUM_CHANNELS"][0]
        tag_ch = num_joints if tag_per_joint else 1
        self.num_joints = num_joints
        self.cat_output = tuple(bool(c) for c in cat_output)
        heads = [conv(feat, num_joints + tag_ch, 1, bias=True)]
        deconvs = []
        cin, prev_out = feat, num_joints + tag_ch
        for i in range(num_deconv_layers):
            if self.cat_output[i]:
                cin += prev_out
            filters = num_deconv_filters[i]
            deconvs.append(nn.Sequential(
                nn.Sequential(conv_transpose(cin, filters, 4, 2, 1),
                              BatchNorm2d(filters), nn.ReLU(inplace=True)),
                *[nn.Sequential(BasicBlock(filters, filters))
                  for _ in range(num_basic_blocks)]))
            heads.append(conv(filters, num_joints, 1, bias=True))
            cin, prev_out = filters, num_joints
        self.deconv_layers = nn.ModuleList(deconvs)
        self.final_layers = nn.ModuleList(heads)

    def forward(self, x):
        h = self.stem_and_stages(x)
        dt = h.dtype
        out_dt = torch.promote_types(torch.float32, dt)
        outputs = [self.final_layers[0](h).to(out_dt)]
        for i, deconv in enumerate(self.deconv_layers):
            if self.cat_output[i]:
                h = torch.cat([h, outputs[-1].to(dt)], dim=1)
            h = deconv(h)
            outputs.append(self.final_layers[i + 1](h).to(out_dt))
        return outputs


def get_pose_net(cfg) -> HigherHRNet:
    """Registry entry; reads MODEL.TAG_PER_JOINT and MODEL.EXTRA.DECONV /
    NUM_BASIC_BLOCKS. USE_SCAN and REMAT shape only the JAX program."""
    extra = cfg.MODEL.EXTRA
    deconv = extra.get("DECONV", {})
    return HigherHRNet(
        stage2_cfg=dict(extra.STAGE2),
        stage3_cfg=dict(extra.STAGE3),
        stage4_cfg=dict(extra.STAGE4),
        num_joints=cfg.MODEL.NUM_JOINTS,
        tag_per_joint=cfg.MODEL.TAG_PER_JOINT,
        num_deconv_layers=deconv.get("NUM_DECONVS", 1),
        num_deconv_filters=tuple(deconv.get("NUM_CHANNELS", [32])),
        cat_output=tuple(deconv.get("CAT_OUTPUT", [True])),
        num_basic_blocks=extra.get("NUM_BASIC_BLOCKS", 4),
    )
