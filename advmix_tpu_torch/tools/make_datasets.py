"""Corruption dataset renderer (COCO-C / MPII-C).

    python -m advmix_tpu_torch.tools.make_datasets --dataset_root \
        data/coco/val2017 [--out_root data] [--out_file coco-C] \
        [--corruptions gaussian_noise,fog] [--device cpu]

Port of `tools/make_datasets.py` (reference `tools/make_datasets.py`): for
every source image, write `<out_root>/<out_file>/<corruption>/<severity
0-4>/<basename>` for the 19 corruption types at severities 1..5, each render
seeded as the reference seeds np.random.seed(1) before every corrupt call
(:38-45). `render_batch` corrupts a batch on the device at all 5
severities in the exact-render form (`ops/corruptions.py`).

Images are padded (edge-replicate) up to size classes, each dimension
rounded up to a multiple of --bucket_quantum, so that batches stack and the
host constants are made for few shapes. Only corruptions whose output
inside the original region does not depend on the canvas are bucketed:
pointwise ops, iid noises and local convolutions. Those with global
statistics or canvas-sized layers (CANVAS_SENSITIVE) render at each image's
exact resolution unless --bucket_all. The cached constants of a size class
are released when it is done. cv2 and PIL are used only to read and write
the files. It runs on the CUDA device, and raises without one unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from ..ops.corruptions import ALL_CORRUPTIONS, corrupt, release_constants
from ..utils.device import resolve_device

# Output inside the original region depends on the padded canvas for these
# (global statistics / canvas-sized layers / size-derived grids); they run
# at exact source resolution unless --bucket_all.
CANVAS_SENSITIVE = frozenset({
    "contrast", "fog", "frost", "snow", "spatter", "elastic_transform",
    "pixelate", "jpeg_compression", "zoom_blur", "glass_blur",
})


def render_batch(x: torch.Tensor, name: str) -> torch.Tensor:
    """All 5 severities of corruption `name` for the NHWC batch `x` (uint8
    or float in [0, 255]) on its device, in the exact-render form, each
    severity from a generator seeded 1: uint8 (5, B, H, W, 3), clipped and
    truncated as np.uint8 would."""
    x = x.to(torch.float32)
    return torch.stack([
        corrupt(x, name, s, torch.Generator(x.device).manual_seed(1),
                exact_render=True).clamp(0, 255).to(torch.uint8)
        for s in range(1, 6)])


def parse(argv=None):
    p = argparse.ArgumentParser(description="Render a -C corruption tree")
    p.add_argument("--dataset_root", required=True,
                   help="directory of source images")
    p.add_argument("--out_root", default="data")
    p.add_argument("--out_file", default="coco-C",
                   help="output dataset dir name (e.g. coco-C, mpii-C)")
    p.add_argument("--corruptions", default="",
                   help="comma-separated subset (default: all 19)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--limit", type=int, default=0,
                   help="only process the first N images (debug)")
    p.add_argument("--bucket_quantum", type=int, default=160,
                   help="pad each image dimension up to a multiple of this")
    p.add_argument("--bucket_all", action="store_true",
                   help="bucket canvas-sensitive corruptions too (faster, "
                        "deviates from per-image true-resolution rendering)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA device (raises "
                        "without one); 'cpu' renders on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    device = resolve_device(args.device)
    import cv2
    from PIL import Image

    names = args.corruptions.split(",") if args.corruptions else \
        ALL_CORRUPTIONS
    files = sorted(f for f in os.listdir(args.dataset_root)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if args.limit:
        files = files[: args.limit]
    print(f"=> {len(files)} images, {len(names)} corruptions x 5 severities "
          f"on {device}")
    out_base = os.path.join(args.out_root, args.out_file)
    for name in names:
        for severity0 in range(5):
            os.makedirs(os.path.join(out_base, name, str(severity0)),
                        exist_ok=True)

    # header-only reads to assign size classes (no pixel decode)
    dims = {}
    for f in files:
        try:
            with Image.open(os.path.join(args.dataset_root, f)) as im:
                dims[f] = (im.size[1], im.size[0])  # (h, w)
        except OSError:
            print(f"!! failed to read {f}")

    def run_group(group_names, quantum):
        if not group_names:
            return
        q = max(1, quantum)
        buckets = defaultdict(list)
        for f, (h, w) in dims.items():
            buckets[(-(-h // q) * q, -(-w // q) * q)].append(f)
        print(f"=> {len(group_names)} corruptions over {len(buckets)} size "
              f"classes (quantum {q})")
        # per size class, decode one chunk at a time and render every
        # corruption of the group on it
        for (bh, bw), items in buckets.items():
            for start in range(0, len(items), args.batch):
                imgs, sizes = [], []
                for fname in items[start: start + args.batch]:
                    img = cv2.imread(os.path.join(args.dataset_root, fname),
                                     cv2.IMREAD_COLOR)
                    if img is None:
                        print(f"!! failed to read {fname}")
                        continue
                    rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                    h, w = rgb.shape[:2]
                    sizes.append((fname, h, w))
                    # edge-replicate pad up to the size class; cropped below
                    imgs.append(np.pad(rgb, ((0, bh - h), (0, bw - w),
                                             (0, 0)), mode="edge"))
                if not imgs:
                    continue
                pad_n = args.batch - len(imgs) if len(items) > args.batch \
                    else 0
                batch = torch.from_numpy(np.stack(imgs + [imgs[-1]] * pad_n))
                batch = batch.to(device)
                for name in group_names:
                    out5 = render_batch(batch, name).cpu().numpy()
                    for severity0 in range(5):
                        outdir = os.path.join(out_base, name, str(severity0))
                        for (fname, h, w), im in zip(sizes, out5[severity0]):
                            cv2.imwrite(
                                os.path.join(outdir, os.path.basename(fname)),
                                cv2.cvtColor(im[:h, :w], cv2.COLOR_RGB2BGR))
            # the constants of this shape (glass permutations, snow layers,
            # elastic fields) are not used again
            n = release_constants(bh, bw)
            print(f"=> size class ({bh}, {bw}) done ({len(items)} images, "
                  f"{n} constants released)")

    if args.bucket_all:
        run_group(names, args.bucket_quantum)
    else:
        run_group([n for n in names if n not in CANVAS_SENSITIVE],
                  args.bucket_quantum)
        run_group([n for n in names if n in CANVAS_SENSITIVE], 1)
    print(f"=> wrote corruption dataset under {out_base}")


if __name__ == "__main__":
    main()
