"""Batching loader with a thread pool and background prefetch.

Port of `advmix_tpu/data/loader.py`. Samples come from a
thread pool sized to the host's cores (cv2 and numpy release the GIL during
decode and warp), `prefetch + 1` batches are in flight, and batches are
yielded strictly in order as dicts of stacked numpy arrays. Sample i of
epoch e is drawn from `RandomState((seed * 100003 + e + i) % 2**31)`, the
JAX Loader's per-sample stream, and a shuffled epoch's order from
`RandomState(seed + e)`, so both packages yield the same batches for a
seed. The last partial batch is padded by repeating its last sample (or
dropped with `drop_last`), with `_n` holding the real count and `_indices`
the dataset indices.

Over several ranks (`num_shards`, `shard_index`) every rank computes the
same seeded global order and keeps its contiguous `batch_size` rows of each
global batch of `batch_size * num_shards`, the rows a `P("data")` shard of
the JAX mesh holds; `len()` counts global batches. A rank whose slice of
the last global batch is empty repeats that batch's last index with
`_n == 0`, so every rank takes the same number of steps.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


class CachedLoader:
    """Replays a deterministic eval loader's batches from host memory.

    Every epoch's validation prepares the same batches, so all the host's
    work on them (decode, warp, collate) is the same on every pass; after
    the first pass they are served from memory. Only for an unshuffled
    loader whose `set_epoch` is never used. If the batches outgrow
    `max_bytes` the cache is given up mid-build and every pass reads the
    live loader."""

    def __init__(self, loader: "Loader", max_bytes: int = 8 << 30):
        if loader.shuffle:
            raise ValueError("CachedLoader requires a shuffle=False loader")
        self.loader = loader
        self.max_bytes = int(max_bytes)
        self._cache = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        # dataset, batch_size, ... of the wrapped loader
        return getattr(self.loader, name)

    def __iter__(self) -> Iterator[dict]:
        if self._cache is not None:
            # a shallow copy each, so a consumer that adds or overwrites
            # keys cannot spoil later passes
            for b in self._cache:
                yield dict(b)
            return
        acc: list = []
        nbytes = 0
        fits = True
        for b in self.loader:
            if fits:
                nbytes += sum(v.nbytes for v in b.values()
                              if isinstance(v, np.ndarray))
                if nbytes <= self.max_bytes:
                    acc.append(b)
                else:
                    fits, acc = False, []
            yield dict(b)
        if fits:
            self._cache = acc


class Loader:
    """Batches of `dataset`. `raw_mode` yields `get_raw_sample` batches
    (source images padded into `bucket_hw` plus crop matrices) for the
    on-device warp instead of crops warped on the host."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_threads: int | None = None, prefetch: int = 2,
                 raw_mode: bool = False, bucket_hw=(640, 640),
                 num_shards: int = 1, shard_index: int = 0):
        if num_threads is None:
            num_threads = max(2, min(64, os.cpu_count() or 2))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.raw_mode = raw_mode
        self.bucket_hw = tuple(bucket_hw)
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        gbs = self.batch_size * self.num_shards
        if self.drop_last:
            return n // gbs
        return (n + gbs - 1) // gbs

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _assemble(self, samples, bidx, real: int) -> dict:
        samples = samples + [samples[-1]] * (self.batch_size - len(samples))
        batch = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], (np.ndarray, np.generic, float, int)):
                batch[k] = np.stack([np.asarray(v) for v in vals])
            else:
                batch[k] = list(vals)
        batch["_n"] = real
        full = np.asarray(bidx, np.int64)
        batch["_indices"] = np.concatenate(
            [full, np.full(self.batch_size - len(full), full[-1], np.int64)])
        return batch

    def _batches(self) -> list:
        """This rank's (indices, real count) of every global batch."""
        indices = self._indices()
        gbs = self.batch_size * self.num_shards
        out = []
        for start in range(0, len(indices), gbs):
            chunk = indices[start: start + gbs]
            if len(chunk) < gbs and self.drop_last:
                continue
            mine = chunk[self.shard_index * self.batch_size:
                         (self.shard_index + 1) * self.batch_size]
            # an empty slice repeats the global batch's last index, the one
            # the rank holding the partial slice pads with
            out.append((mine, len(mine)) if len(mine) else (chunk[-1:], 0))
        return out

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        base = self.seed * 100003 + self.epoch

        def one(i: int):
            rng = np.random.RandomState((base + int(i)) % (2 ** 31))
            if self.raw_mode:
                return self.dataset.get_raw_sample(int(i), rng,
                                                   self.bucket_hw)
            return self.dataset.get_sample(int(i), rng)

        if self.num_threads <= 1:
            for bidx, real in batches:
                yield self._assemble([one(i) for i in bidx], bidx, real)
            return

        window = max(1, self.prefetch) + 1
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            inflight: deque = deque()
            todo = iter(batches)
            for bidx, real in todo:
                inflight.append(([ex.submit(one, i) for i in bidx], bidx,
                                 real))
                if len(inflight) >= window:
                    break
            while inflight:
                futs, bidx, real = inflight.popleft()
                batch = self._assemble([f.result() for f in futs], bidx,
                                       real)
                nxt = next(todo, None)
                if nxt is not None:
                    inflight.append(([ex.submit(one, i) for i in nxt[0]],
                                     *nxt))
                yield batch
