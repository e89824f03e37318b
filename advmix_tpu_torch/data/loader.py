"""Batching loader with a thread pool and background prefetch.

Port of `advmix_tpu/data/loader.py:Loader` for one process, eval side (no
shuffling; training's options join with the training slice). Samples come
from a thread pool sized to the host's cores (cv2 and numpy release the
GIL during decode and warp), `PREFETCH + 1` batches are in flight, and
batches are yielded strictly in order as dicts of stacked numpy arrays.
The last partial batch is padded by repeating its last sample, with `_n`
holding the real count and `_indices` the dataset indices.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


# batches in flight beyond the one being consumed
PREFETCH = 2


class Loader:
    """Eval batches of `dataset` in dataset order."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_threads = max(2, min(64, os.cpu_count() or 2))

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _assemble(self, samples, bidx) -> dict:
        real = len(samples)
        samples = samples + [samples[-1]] * (self.batch_size - real)
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
            [full, np.full(self.batch_size - real, full[-1], np.int64)])
        return batch

    def __iter__(self) -> Iterator[dict]:
        indices = np.arange(len(self.dataset))
        batches = [indices[s: s + self.batch_size]
                   for s in range(0, len(indices), self.batch_size)]

        def one(i: int):
            # the JAX Loader's per-sample stream at seed 0, epoch 0; the
            # eval branch of get_sample draws nothing from it
            return self.dataset.get_sample(int(i), np.random.RandomState(
                int(i)))

        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            inflight: deque = deque()
            todo = iter(batches)
            for bidx in todo:
                inflight.append(([ex.submit(one, i) for i in bidx], bidx))
                if len(inflight) > PREFETCH:
                    break
            while inflight:
                futs, bidx = inflight.popleft()
                batch = self._assemble([f.result() for f in futs], bidx)
                nxt = next(todo, None)
                if nxt is not None:
                    inflight.append(([ex.submit(one, i) for i in nxt], nxt))
                yield batch
