"""SimpleBaseline pose network: ResNet trunk + deconv head (NCHW).

Port of `advmix_tpu/models/pose_resnet.py` (reference
`lib/models/pose_resnet.py`: ResNet-18/34/50/101/152 per `resnet_spec`,
k4-s2 deconv layers, 1x1 final conv). `BasicBlock` and `Bottleneck` are
also HRNet's blocks. Input (B, 3, H, W); output (B, J, H/4, W/4) in at
least f32.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, compute_dtype_of, conv, conv_transpose

RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def make_res_layer(block, inplanes: int, planes: int, blocks: int,
                   stride: int = 1) -> nn.Sequential:
    """One ResNet stage; block 0 downsamples when the shape changes."""
    needs_ds = stride != 1 or inplanes != planes * block.expansion
    layers = [block(inplanes, planes, stride, needs_ds)]
    layers += [block(planes * block.expansion, planes)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class PoseResNet(nn.Module):
    """ResNet trunk + deconv head; arguments mirror cfg.MODEL.EXTRA
    (`lib/models/pose_resnet.py:105-134`)."""

    def __init__(self, num_layers: int = 50, num_joints: int = 17,
                 num_deconv_layers: int = 3,
                 num_deconv_filters=(256, 256, 256),
                 num_deconv_kernels=(4, 4, 4), final_conv_kernel: int = 1,
                 deconv_with_bias: bool = False):
        super().__init__()
        kind, layers = RESNET_SPEC[num_layers]
        block = BLOCKS[kind]
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for li, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1):
            setattr(self, f"layer{li}",
                    make_res_layer(block, inplanes, planes, n, stride))
            inplanes = planes * block.expansion

        deconv = []
        for i in range(num_deconv_layers):
            k = num_deconv_kernels[i]
            padding = {4: 1, 3: 1, 2: 0}[k]
            output_padding = {4: 0, 3: 1, 2: 0}[k]
            cout = num_deconv_filters[i]
            deconv += [
                conv_transpose(inplanes, cout, k, 2, padding, output_padding,
                               bias=deconv_with_bias),
                BatchNorm2d(cout),
                nn.ReLU(inplace=True),
            ]
            inplanes = cout
        self.deconv_layers = nn.Sequential(*deconv)
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = conv(inplanes, num_joints, final_conv_kernel, 1,
                                pad, bias=True)

    def forward(self, x):
        x = x.to(compute_dtype_of(self, self.conv1))
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        out = self.final_layer(self.deconv_layers(x))
        return out.to(torch.promote_types(torch.float32, out.dtype))


def get_pose_net(cfg) -> PoseResNet:
    """Registry entry (`lib/models/pose_resnet.py:261`)."""
    extra = cfg.MODEL.EXTRA
    return PoseResNet(
        num_layers=extra.NUM_LAYERS,
        num_joints=cfg.MODEL.NUM_JOINTS,
        num_deconv_layers=extra.NUM_DECONV_LAYERS,
        num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
        num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
        deconv_with_bias=extra.DECONV_WITH_BIAS,
    )
