"""Shared helpers of the corruption parity tests: the JAX package's random
draws, replayed from its key splits, as the port's apply functions take
them; and the comparison of two [0, 255] outputs."""

import jax
import numpy as np
import torch

import advmix_tpu.ops.corruptions as J

SHAPE = (2, 32, 24, 3)  # B, H, W, C: small enough for the eager JAX forms


def image(seed: int = 0, shape=SHAPE) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _plasma_noises(keys, mapsize: int, decay: float):
    """JAX `_plasma_fractal`'s per-level draws for each image key, stacked
    over the batch: level -> 3 tensors (B, n, n)."""
    per_image = []
    for key in keys:
        levels = []
        wibble = 100.0
        for shapes in J.plasma_noise_shapes(mapsize):
            level = []
            for shape in shapes:
                key, k = jax.random.split(key)
                level.append((jax.random.uniform(k, shape) * 2.0 - 1.0)
                             * wibble)
            levels.append(level)
            wibble /= decay
        per_image.append(levels)
    return [tuple(t(np.stack([np.asarray(img[lv][i]) for img in per_image]))
                  for i in range(3)) for lv in range(len(per_image[0]))]


def jax_draws(name: str, x: np.ndarray, severity: int, key) -> dict:
    """The draws `advmix_tpu.ops.corruptions.<name>(x, severity, key)`
    makes, as the keyword arguments of the port's `<name>` apply."""
    b, h, w, _ = x.shape
    if name in ("gaussian_noise", "speckle_noise"):
        return dict(n=t(jax.random.normal(key, x.shape)))
    if name == "shot_noise":
        lam = x / 255.0 * [60, 25, 12, 5, 3][severity - 1]
        return dict(counts=t(jax.random.poisson(key, lam).astype(
            np.float32)))
    if name == "impulse_noise":
        k1, k2 = jax.random.split(key)
        return dict(u=t(jax.random.uniform(k1, x.shape[:3])),
                    salt=t(jax.random.bernoulli(k2, 0.5, x.shape[:3])))
    if name == "glass_blur":
        _, md, iters = J.GLASS_CONSTANTS[severity - 1]
        deltas = []
        for _ in range(iters):
            key, k1 = jax.random.split(key)
            deltas.append(t(jax.random.randint(k1, (b, h, w, 2), -md, md))
                          .long())
        return dict(deltas=deltas)
    if name == "motion_blur":
        return dict(angle_idx=t(jax.random.randint(key, (b,), 0, 16)).long())
    if name == "fog":
        decay = [2, 2, 1.7, 1.5, 1.4][severity - 1]
        return dict(noises=_plasma_noises(jax.random.split(key, b),
                                          J._next_pow2(max(h, w)), decay))
    if name == "frost":
        k1, _ = jax.random.split(key)
        return dict(noises=_plasma_noises(jax.random.split(k1, b),
                                          J._next_pow2(max(h, w)), 1.8))
    if name == "snow":
        k1, k2 = jax.random.split(key)
        return dict(field=t(jax.random.normal(k1, (b, h, w, 1))),
                    angle_idx=t(jax.random.randint(k2, (b,), 0, 8)).long())
    if name == "spatter":
        return dict(field=t(jax.random.normal(key, (b, h, w, 1))))
    if name == "elastic_transform":
        jitter = J.ELASTIC_CONSTANTS[severity - 1][2]
        k1, k2, k3 = jax.random.split(key, 3)
        return dict(
            delta=t(jax.random.uniform(k3, (b, 3, 2), minval=-jitter,
                                       maxval=jitter)),
            noise_dx=t(jax.random.uniform(k1, (b, h, w, 1)) * 2 - 1),
            noise_dy=t(jax.random.uniform(k2, (b, h, w, 1)) * 2 - 1))
    raise KeyError(name)


def agreement(got: torch.Tensor, want) -> tuple:
    """(max |diff| on the [0, 255] scale, share of values that differ by
    more than 1e-3, share of uint8 values after clip and truncation that
    differ)."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    u8 = (np.clip(got, 0, 255).astype(np.uint8)
          != np.clip(want, 0, 255).astype(np.uint8))
    return float(d.max()), float((d > 1e-3).mean()), float(u8.mean())
