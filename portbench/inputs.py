"""Seeded inputs and weights, made on the device in a few large calls.

Everything a run feeds the program, and hands the reference alike, comes
from here and from `--seed`: smooth uint8 images (a sum of upsampled noise
octaves, so equalize, JPEG and the blurs see image-like content and not
white noise), person boxes and crop matrices drawn as the COCO train loader
draws them, joints and visibilities, and He-normal weights whose BatchNorm
running statistics come from the batch statistics of seeded images, so that
an eval-mode network (the teacher, the sweep's model) gives well-scaled
heatmaps. The output layers (D's `final_layer`, G's last transposed
convolution) keep their published N(0, 0.001) start: D's heatmaps start
small, as after an ImageNet backbone, and G's logits start near zero, so its
softmax mixes the three views smoothly; a G started at He scale makes its
softmax nearly one-hot, and rounding then flips which view a pixel takes.
Any other parameter (a linear layer, a norm's scale, a position table) is
drawn as ViT and HRFormer start it, so that no weight is left to torch's
default, which the unseeded global RNG would draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream `tag` of run seed `seed`."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), tag])
               .generate_state(1, np.uint64)[0]) >> 1


def device_gen(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def smooth_images(n: int, h: int, w: int, gen: torch.Generator,
                  device, chunk: int = 64) -> torch.Tensor:
    """(n, h, w, 3) uint8 on `device`: three octaves of bicubically
    upsampled Gaussian noise, contrast-stretched per image."""
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        acc = torch.zeros((m, 3, h, w), device=device)
        for cells, amp in ((4, 1.0), (16, 0.5), (64, 0.25)):
            gh = max(2, cells * h // max(h, w))
            gw = max(2, cells * w // max(h, w))
            z = torch.randn((m, 3, gh, gw), generator=gen, device=device)
            acc += amp * F.interpolate(z, size=(h, w), mode="bicubic",
                                       align_corners=False)
        lo = acc.amin(dim=(1, 2, 3), keepdim=True)
        hi = acc.amax(dim=(1, 2, 3), keepdim=True)
        img = (acc - lo) / (hi - lo).clamp(min=1e-6) * 255.0
        out[i:i + m] = img.round().clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def normalized(image_u8: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 -> NCHW f32 normalized as torchvision's Normalize."""
    x = image_u8.to(torch.float32).permute(0, 3, 1, 2)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean * 255.0) / (std * 255.0)


def joints_in_crop(n: int, num_joints: int, image_size, vis_prob: float,
                   rng: np.random.RandomState):
    """Joints uniform over the (w, h) crop, each visible with `vis_prob`."""
    w, h = image_size
    joints = (rng.rand(n, num_joints, 2)
              * np.array([w - 1.0, h - 1.0])).astype(np.float32)
    vis = (rng.rand(n, num_joints) < vis_prob).astype(np.float32)
    return joints, vis


def crop_matrix(center, scale, rot_deg, out_size) -> np.ndarray:
    """The 2x3 source -> crop matrix of a box (`center` px, `scale` in
    units of 200 px, rotation in degrees), as HRNet's get_affine_transform
    builds it from three point pairs."""
    src_w = scale[0] * 200.0
    dst_w, dst_h = out_size
    rad = math.radians(rot_deg)
    sn, cs = math.sin(rad), math.cos(rad)
    src_dir = np.array([-(src_w * -0.5) * sn, src_w * -0.5 * cs])
    dst_dir = np.array([0.0, dst_w * -0.5])
    src = np.stack([center, center + src_dir, np.zeros(2)])
    dst = np.stack([[dst_w * 0.5, dst_h * 0.5],
                    np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir,
                    np.zeros(2)])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src[2] = third(src[0], src[1])
    dst[2] = third(dst[0], dst[1])
    a = np.concatenate([src, np.ones((3, 1))], 1)
    return np.linalg.solve(a, dst).T


def train_boxes(n: int, src_hw, image_size, data_cfg: dict,
                rng: np.random.RandomState) -> np.ndarray:
    """(n, 2, 3) f32 crop matrices for people in a (h, w) source image,
    with the train loader's augmentation draws: scale x clip(N(1, sf)),
    rotation clip(N(0, rf), +-2rf) with probability 0.6, and a horizontal
    flip with probability 0.5 folded into the matrix."""
    h, w = src_hw
    aspect = image_size[0] / image_size[1]
    sf, rf = float(data_cfg["SCALE_FACTOR"]), float(data_cfg["ROT_FACTOR"])
    mats = np.empty((n, 2, 3), np.float32)
    for i in range(n):
        center = np.array([rng.uniform(0.2, 0.8) * w,
                           rng.uniform(0.2, 0.8) * h])
        box_h = rng.uniform(0.3, 0.9) * h
        scale = np.array([box_h * aspect, box_h]) / 200.0 * 1.25
        scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        rot = float(np.clip(rng.randn() * rf, -2 * rf, 2 * rf)) \
            if rng.rand() <= 0.6 else 0.0
        flip = rng.rand() <= 0.5
        if flip:
            center[0] = w - center[0] - 1
        m = crop_matrix(center, scale, rot, image_size)
        if flip:  # the crop of the mirrored image, read from the original
            mirror = np.array([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0],
                               [0.0, 0.0, 1.0]])
            m = m @ mirror
        mats[i] = m
    return mats


def eval_boxes(n: int, image_size, rng: np.random.RandomState):
    """Centers (n, 2) and scales (n, 2) of val boxes in a 640x480 image,
    with the loader's 1.25 margin and aspect ratio."""
    aspect = image_size[0] / image_size[1]
    center = np.stack([rng.uniform(100, 540, n), rng.uniform(100, 380, n)],
                      1).astype(np.float32)
    box_h = rng.uniform(80, 400, n)
    scale = (np.stack([box_h * aspect, box_h], 1) / 200.0
             * 1.25).astype(np.float32)
    return center, scale


OUTPUT_LAYERS = ("final_layer", "model.model.3")
OUTPUT_STD = 0.001


TABLE_STD = 0.02
NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase)


def he_init_(model: nn.Module, gen: torch.Generator,
             rest: torch.Generator | None = None) -> None:
    """He-normal kernels for every convolution but the output layers
    (N(0, 0.001)), drawn in one call; biases 0, BatchNorm scale 1 and
    shift 0. Then every parameter left (`rest_init_`, from `rest`), so that
    none keeps torch's default start, which the global RNG draws."""
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    dev = convs[0][1].weight.device
    flat = torch.randn(sum(m.weight.numel() for _, m in convs),
                       generator=gen, device=dev)
    o = 0
    with torch.no_grad():
        for name, m in convs:
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = OUTPUT_STD if name in OUTPUT_LAYERS \
                else math.sqrt(2.0 / fan_in)
            w.copy_(flat[o:o + w.numel()].view_as(w) * std)
            o += w.numel()
            if m.bias is not None:
                m.bias.zero_()
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
    done = {id(p) for _, m in convs for p in m.parameters(recurse=False)}
    done |= {id(p) for m in model.modules() if isinstance(m, nn.BatchNorm2d)
             for p in m.parameters(recurse=False)}
    rest_init_(model, done, rest)


def rest_init_(model: nn.Module, done: set, gen: torch.Generator | None
               ) -> None:
    """The parameters that `he_init_` did not set (ids not in `done`), as
    ViT and HRFormer start them: linear weights and every other free
    parameter (position tables) truncated N(0, 0.02) at two standard
    deviations, drawn in one call in `named_parameters` order; linear
    biases 0; LayerNorm, GroupNorm and other norms' scales 1 and shifts 0.
    Draws nothing where nothing is left (HRNet, ResNet, the UNet)."""
    fixed = {}  # id -> value
    for m in model.modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, nn.Linear) and own.get("bias") is not None:
            fixed[id(m.bias)] = 0.0
        elif isinstance(m, NORMS):
            fixed.update({id(p): 1.0 if k == "weight" else 0.0
                          for k, p in own.items()})
    drawn = [p for _, p in model.named_parameters()
             if id(p) not in done and id(p) not in fixed]
    with torch.no_grad():
        for p in model.parameters():
            if id(p) not in done and id(p) in fixed:
                p.fill_(fixed[id(p)])
        if not drawn:
            return
        if gen is None:
            raise ValueError("parameters beyond convolutions and BatchNorm "
                             "need a generator of their own")
        flat = torch.empty(sum(p.numel() for p in drawn),
                           device=drawn[0].device)
        nn.init.trunc_normal_(flat, std=TABLE_STD, a=-2 * TABLE_STD,
                              b=2 * TABLE_STD, generator=gen)
        o = 0
        for p in drawn:
            p.copy_(flat[o:o + p.numel()].view_as(p))
            o += p.numel()


def calibrate_bn_(model: nn.Module, images: torch.Tensor) -> None:
    """Running statistics from the batch statistics of `images` (one
    cumulative train-mode pass); a variance under 1e-2 is raised to it, so
    a channel nearly dead on these images gets no gain of 1/sqrt(eps)."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    with torch.no_grad():
        model(images)
        for m in bns:
            m.running_var.clamp_(min=1e-2)
            m.momentum = 0.1
            m.num_batches_tracked.zero_()
    model.eval()

