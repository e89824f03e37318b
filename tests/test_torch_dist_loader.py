"""The port's sharded Loader against the JAX package's: for 1 to 3 shards,
every shard's batches (sample values, `_n`, `_indices`) equal the JAX
Loader's for the same shard, with and without shuffle and drop_last, on
dataset sizes that leave a ragged last global batch (including one that
leaves a shard empty), and the shards together hold each sample once."""

import numpy as np
import pytest

from advmix_tpu.data.loader import Loader as JaxLoader
from advmix_tpu_torch.data import CachedLoader, Loader


class Numbers:
    """Sample i is its index and a draw from the sample's own stream."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def get_sample(self, i, rng):
        return {"image": np.array([i, rng.randint(1 << 30)], np.int64),
                "score": float(i) / 2}


def _batches(loader):
    return [{k: (np.asarray(v) if k != "_n" else v) for k, v in b.items()}
            for b in loader]


@pytest.mark.parametrize("n", [12, 13, 17])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_shards_match_jax_loader(n, num_shards, drop_last, shuffle):
    ds, bs = Numbers(n), 3
    seen = []
    for shard in range(num_shards):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7,
                  num_shards=num_shards, shard_index=shard)
        port = Loader(ds, bs, num_threads=3, **kw)
        port.set_epoch(2)
        ref = JaxLoader(ds, bs, num_threads=1, **kw)
        ref.set_epoch(2)
        got, want = _batches(port), _batches(ref)
        assert len(port) == len(ref) == len(want) == len(got)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"image", "score", "_n", "_indices"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
            seen.extend(g["_indices"][:g["_n"]].tolist())
            # the padding repeats the global batch's last index
            assert (g["_indices"][g["_n"]:] == g["_indices"][-1]).all()
            np.testing.assert_array_equal(g["image"][:, 0], g["_indices"])
    gbs = bs * num_shards
    kept = (n // gbs) * gbs if drop_last else n
    order = Loader(ds, bs, shuffle=shuffle, seed=7)
    order.set_epoch(2)
    assert sorted(seen) == sorted(order._indices()[:kept].tolist())
    assert len(seen) == len(set(seen))


def test_empty_shard_pads_with_n_zero():
    """13 samples, global batches of 3 x 4: the last holds one sample, so
    shards 1-3 step on it with `_n == 0`, all repeating index 12."""
    ds = Numbers(13)
    lasts = [list(Loader(ds, 3, num_shards=4, shard_index=s,
                         num_threads=1))[-1] for s in range(4)]
    assert [b["_n"] for b in lasts] == [1, 0, 0, 0]
    assert all((b["_indices"] == 12).all() for b in lasts)
    assert all(len(Loader(ds, 3, num_shards=4, shard_index=s)) == 2
               for s in range(4))


def test_cached_loader_replays_a_shard():
    ds = Numbers(10)
    live = Loader(ds, 2, num_shards=2, shard_index=1, num_threads=1)
    cached = CachedLoader(Loader(ds, 2, num_shards=2, shard_index=1))
    want = _batches(live)
    for _ in range(2):
        got = _batches(cached)
        assert len(got) == len(want) == len(cached)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
