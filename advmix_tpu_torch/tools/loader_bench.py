"""Host input-pipeline throughput of the port's real `data/loader.Loader`.

    python -m advmix_tpu_torch.tools.loader_bench [--n 256] [--batch 32] \
        [--threads N] [--bottomup]

Counterpart of `tools/loader_bench.py`. It writes COCO-sized synthetic JPEGs
(427/480/640 x 640/480/612, blurred noise at quality 90) to a temporary
folder and times the Loader (thread pool, prefetch, collate) over them for
one epoch after a warm one, in both host modes:

- "decode_warp": JPEG decode and the per-sample cv2 warp of the crop
  (`BaseJointsDataset.get_sample`, reference
  `lib/dataset/JointsDataset.py:135-195`);
- "decode_only": JPEG decode only, the crop warped on the device
  (`get_raw_sample`, `raw_mode=True, bucket_hw=(640, 640)`).

`--bottomup` times the bottom-up training path instead: a synthetic COCO
train tree of 2-3 people and a crowd polygon per image through
`BottomUpCOCODataset` at 512x512 (decode, ignore-mask rasterization, the
image and mask warps, the mask's collate). Prints one JSON line: img/s,
the thread count and img/s per thread. Host clock, no card involved.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def _make_jpegs(root: str, n: int, seed: int = 0) -> list:
    import cv2

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        h = int(rng.choice([427, 480, 640]))
        w = int(rng.choice([640, 480, 612]))
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        # JPEG-compressible content (pure noise decodes unusually slowly)
        img = cv2.GaussianBlur(img, (0, 0), 3)
        p = os.path.join(root, f"{i:06d}.jpg")
        cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    return paths


def _epoch_rate(loader) -> float:
    """img/s of one epoch after a warm one (page cache, thread pool)."""
    for _ in loader:
        pass
    t0 = time.perf_counter()
    seen = 0
    for b in loader:
        seen += b["_n"]
    return seen / (time.perf_counter() - t0)


def loader_bench(n: int = 256, batch: int = 32, threads=None,
                 image_size=(192, 256)) -> dict:
    """{'decode_warp_img_s', 'decode_only_img_s', 'threads', 'n_images',
    and img/s per thread of each mode}."""
    from ..config import get_default_config
    from ..data import Loader
    from ..data.datasets import SyntheticPoseDataset

    cfg = get_default_config()
    cfg.MODEL.IMAGE_SIZE = list(image_size)
    cfg.MODEL.HEATMAP_SIZE = [image_size[0] // 4, image_size[1] // 4]
    cfg.MODEL.NUM_JOINTS = 17
    cfg.DATASET.DATASET = "synthetic"
    cfg.freeze()

    with tempfile.TemporaryDirectory() as root:
        paths = _make_jpegs(root, n)

        class JpegDataset(SyntheticPoseDataset):
            """Synthetic records whose pixels come from real JPEG files, so
            the bench runs the real decode."""

            def __init__(self):
                super().__init__(cfg, is_train=True, length=n)
                for rec, p in zip(self.records, paths):
                    rec["image"] = p
                    # a person-sized crop
                    rec["center"] = np.array([320.0, 240.0], np.float32)
                    rec["scale"] = np.array([1.2, 1.6], np.float32)

            def _read_image(self, path):
                import cv2

                img = cv2.imread(path, cv2.IMREAD_COLOR)
                return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

        ds = JpegDataset()
        out = {}
        for name, kw in (("decode_warp", {}),
                         ("decode_only", {"raw_mode": True,
                                          "bucket_hw": (640, 640)})):
            loader = Loader(ds, batch, shuffle=False, num_threads=threads,
                            **kw)
            out[f"{name}_img_s"] = _epoch_rate(loader)
        out["threads"] = loader.num_threads
        out["n_images"] = n
        for name in ("decode_warp", "decode_only"):
            out[f"{name}_img_s_per_thread"] = (out[f"{name}_img_s"]
                                               / out["threads"])
        return out


def _write_bottomup_tree(root: str, n: int, rng) -> None:
    """A COCO train tree of `n` JPEGs, 2-3 annotated people and one crowd
    polygon each, so that the ignore-mask path runs."""
    import cv2

    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "train2017"))
    images, anns = [], []
    aid = 1
    for i in range(1, n + 1):
        h = int(rng.choice([427, 480, 640]))
        w = int(rng.choice([640, 480, 612]))
        img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3), np.uint8),
                               (0, 0), 3)
        cv2.imwrite(os.path.join(root, "train2017", "%012d.jpg" % i), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append(dict(id=i, width=w, height=h))
        for _ in range(int(rng.randint(2, 4))):
            kps = []
            for _j in range(17):
                kps += [float(rng.uniform(0, w)), float(rng.uniform(0, h)), 2]
            anns.append(dict(id=aid, image_id=i, category_id=1,
                             keypoints=kps, num_keypoints=17,
                             bbox=[10, 10, w - 20, h - 20],
                             area=float((w - 20) * (h - 20)), iscrowd=0))
            aid += 1
        x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
        poly = [x0, y0, x0 + w / 3, y0, x0 + w / 3, y0 + h / 3, x0,
                y0 + h / 3]
        anns.append(dict(id=aid, image_id=i, category_id=1,
                         keypoints=[0.0] * 51, num_keypoints=0,
                         bbox=[x0, y0, w / 3, h / 3], area=float(w * h / 9),
                         iscrowd=1, segmentation=[poly]))
        aid += 1
    with open(os.path.join(root, "annotations",
                           "person_keypoints_train2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns), f)


def bottomup_loader_bench(n: int = 128, batch: int = 8, threads=None,
                          input_size: int = 512) -> dict:
    """img/s of `BottomUpCOCODataset`'s training samples through the
    Loader (`tools/loader_bench.py:113-200`)."""
    from ..config import get_default_config
    from ..data import Loader
    from ..data.bottomup import BottomUpCOCODataset

    with tempfile.TemporaryDirectory() as root:
        _write_bottomup_tree(root, n, np.random.RandomState(0))
        cfg = get_default_config()
        cfg.DATASET.DATASET = "bottomup_coco"
        cfg.DATASET.ROOT = root
        cfg.DATASET.TRAIN_SET = "train2017"
        cfg.MODEL.NUM_JOINTS = 17
        cfg.MODEL.IMAGE_SIZE = [input_size, input_size]
        cfg.MODEL.HEATMAP_SIZE = [input_size // 4, input_size // 4]
        cfg.freeze()
        ds = BottomUpCOCODataset(cfg, is_train=True)
        if not any(r["ignore_segs"] for r in ds.records):
            raise AssertionError("the tree has no ignore regions: the mask "
                                 "path would not run")
        loader = Loader(ds, batch, shuffle=False, num_threads=threads)
        batches = iter(loader)
        first = next(batches)
        batches.close()  # shuts the loader's thread pool down
        if "mask" not in first:
            raise AssertionError("training batches must carry the mask")
        rate = _epoch_rate(loader)
        return {"bottomup_img_s": rate,
                "bottomup_img_s_per_thread": rate / loader.num_threads,
                "threads": loader.num_threads,
                "n_images": len(ds.records), "input_size": input_size}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--bottomup", action="store_true",
                   help="the 512x512 bottom-up training path (decode, "
                        "ignore-mask rasterization, warps) instead")
    args = p.parse_args(argv)
    if args.bottomup:
        res = bottomup_loader_bench(args.n, max(args.batch // 4, 1),
                                    args.threads or None)
    else:
        res = loader_bench(args.n, args.batch, args.threads or None)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
