"""UNet mixing-weight generator (AdvMix "G"), NCHW.

Port of `advmix_tpu/models/unet.py` (reference
`lib/models/Unet_generator.py:13-112`): a skip-connection UNet with
InstanceNorm (no affine), LeakyReLU(0.2) down / ReLU up and k4-s2-p1 convs,
built as UnetGenerator(input_nc=9, output_nc=3, num_downs=6, ngf=64). The
output is 3 per-pixel mixing logits over the K=3 views, softmaxed in the
train step.

The modules are nested and numbered as the reference nests them
(`model.model.0`, `model.model.1.model.1`, ...), so a reference
`UnetGenerator` `.pth` loads with `load_state_dict(strict=True)`. The
reference's in-place LeakyReLU turns each skip into leaky_relu(x) before the
concat; the ReLU that follows every concat makes that equal to
concatenating x itself, which is what the JAX package and this port do.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import InstanceNorm2d, compute_dtype_of, conv, conv_transpose


class UnetSkipConnectionBlock(nn.Module):
    """One level: down conv, the inner block, up conv, and the skip concat
    `[x, up]` (`Unet_generator.py:47-112`). No norm on the outermost and
    the innermost down conv; no norm after the outermost up conv."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int | None,
                 submodule: "UnetSkipConnectionBlock | None",
                 outermost: bool = False, with_tanh: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        # InstanceNorm implies bias=True on every conv (:34-37)
        down = conv(input_nc, inner_nc, 4, 2, 1, bias=True)
        if outermost:
            up = conv_transpose(inner_nc * 2, outer_nc, 4, 2, 1, bias=True)
            layers = [down, submodule, nn.ReLU(), up]
            if with_tanh:
                layers.append(nn.Tanh())
        elif submodule is None:  # innermost
            up = conv_transpose(inner_nc, outer_nc, 4, 2, 1, bias=True)
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up,
                      InstanceNorm2d(outer_nc)]
        else:
            up = conv_transpose(inner_nc * 2, outer_nc, 4, 2, 1, bias=True)
            layers = [nn.LeakyReLU(0.2), down, InstanceNorm2d(inner_nc),
                      submodule, nn.ReLU(), up, InstanceNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 9, output_nc: int = 3,
                 num_downs: int = 6, ngf: int = 64, with_tanh: bool = False):
        super().__init__()
        filters = [ngf * min(2 ** i, 8) for i in range(num_downs)]
        block = UnetSkipConnectionBlock(filters[-2], filters[-1], None, None)
        for i in range(num_downs - 2, 0, -1):
            block = UnetSkipConnectionBlock(filters[i - 1], filters[i], None,
                                            block)
        self.model = UnetSkipConnectionBlock(output_nc, filters[0], input_nc,
                                             block, outermost=True,
                                             with_tanh=with_tanh)
        self.num_downs = num_downs

    def forward(self, x):
        x = x.to(compute_dtype_of(self, self.model.model[0]))
        out = self.model(x)
        return out.to(torch.promote_types(torch.float32, out.dtype))


def get_generator(args=None) -> UnetGenerator:
    """G with the reference CLI defaults (`tools/_init_parse.py:117-131`:
    gen_input_chn=9, downsamples=6), initialized as the JAX package's G
    is: kernels ~ N(0, 0.001) from a seeded generator, biases 0."""
    input_nc = getattr(args, "gen_input_chn", 9) if args else 9
    num_downs = getattr(args, "downsamples", 6) if args else 6
    model = UnetGenerator(input_nc=input_nc, num_downs=num_downs)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.001, generator=gen)
                m.bias.zero_()
    return model
