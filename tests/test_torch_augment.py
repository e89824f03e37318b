"""The port's 3-view synthesis (`ops/augment.py`) against the JAX package's.

Every primitive is bit-exact in f32 on integer-valued images. The random ops
are compared with the JAX package's own draws replayed: the test splits the
key as `advmix_tpu/ops/augment.py:229-233`, `:276-281` and `:330` do and
hands the values to the port's `apply_*` functions. In bf16 the tolerance is
one uint8 level in normalized units plus one bf16 ulp at the largest
normalized value (1 / (0.224 * 255) + 2**-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.ops import augment as JA
from advmix_tpu_torch.ops import augment as TA

B, H, W = 6, 64, 48  # equalize needs > 255 pixels on the stride-2 grid


def _image(seed=0):
    """Integer-valued f32 NHWC image; one constant channel, which takes
    equalize's `step == 0` branch, and one with two grey levels."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    img[0, :, :, 1] = 7.0
    img[1, :, :, 2] = rng.randint(0, 2, (H, W)) * 255.0
    return img


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.to(torch.float32).numpy().transpose(0, 2, 3, 1)


PRIMITIVES = {
    "invert": (JA.invert, TA.invert),
    "solarize_142": (lambda x: JA.solarize(x, 256 - 4 * 256 / 9),
                     lambda x: TA.solarize(x, 256 - 4 * 256 / 9)),
    "solarize_128": (lambda x: JA.solarize(x, 128.0),
                     lambda x: TA.solarize(x, 128.0)),
    "posterize_5": (lambda x: JA.posterize(x, 5), lambda x: TA.posterize(x, 5)),
    "posterize_8": (lambda x: JA.posterize(x, 8), lambda x: TA.posterize(x, 8)),
    "equalize_stride1": (lambda x: JA.equalize(x, 1),
                         lambda x: TA.equalize(x, 1)),
    "equalize_stride2": (lambda x: JA.equalize(x, 2),
                         lambda x: TA.equalize(x, 2)),
    "smooth": (JA._smooth_filter, TA._smooth_filter),
    "sharpness_1.7": (lambda x: JA.sharpness(x, 1.7),
                      lambda x: TA.sharpness(x, 1.7)),
    "sharpness_0.3": (lambda x: JA.sharpness(x, 0.3),
                      lambda x: TA.sharpness(x, 0.3)),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_bit_exact_f32(name):
    jf, tf = PRIMITIVES[name]
    img = _image()
    want = np.asarray(jf(jnp.asarray(img)))
    got = _nhwc(tf(_nchw(img)))
    if name == "smooth":
        # the one primitive with fractional output: the 9-term sums may
        # round in another order (relative 1e-6 of an f32 epsilon 1.2e-7); sharpness rounds it to
        # integers before use, and is bit-exact
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if name.startswith("equalize"):
        np.testing.assert_array_equal(got[0, :, :, 1], 7.0)  # identity LUT
        assert (got != img).any()


def test_equalize_stride1_is_pil_arithmetic():
    """An independent numpy rendering of PIL's ImageOps.equalize."""
    img = _image(3)
    got = _nhwc(TA.equalize(_nchw(img), 1))
    for b in range(2):
        for c in range(3):
            ch = img[b, :, :, c].astype(np.int64)
            hist = np.bincount(ch.ravel(), minlength=256)
            nz = hist[hist > 0]
            step = (hist.sum() - nz[-1]) // 255 if len(nz) > 1 else 0
            if step == 0:
                want = ch
            else:
                lut = (np.cumsum(hist) - hist + step // 2) // step
                want = np.clip(lut, 0, 255)[ch]
            np.testing.assert_array_equal(got[b, :, :, c], want)


def _jax_autoaugment_draws(key, b):
    k_pol, k_p1, k_p2, k_sign = jax.random.split(key, 4)
    sign = np.where(np.asarray(jax.random.bernoulli(k_sign, 0.5, (b,))),
                    1.0, -1.0).astype(np.float32)
    return dict(
        pol_idx=np.array(jax.random.randint(k_pol, (b,), 0,
                                            len(JA._POLICIES))),
        u1=np.array(jax.random.uniform(k_p1, (b,))),
        u2=np.array(jax.random.uniform(k_p2, (b,))), sign=sign)


def _jax_gridmask_draws(key, b, h, w, prob=0.7):
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    d = np.array(jax.random.randint(k_d, (b,), 2, min(h, w)))
    return dict(
        apply=np.array(jax.random.bernoulli(k_apply, prob, (b,))), d=d,
        st_h=np.array(jax.random.randint(k_sh, (b,), 0, 2 ** 30)) % d,
        st_w=np.array(jax.random.randint(k_sw, (b,), 0, 2 ** 30)) % d)


def _tensors(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", range(6))
def test_autoaugment_replayed_draws_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    img = _image(seed)
    want = np.asarray(JA.autoaugment(jnp.asarray(img), key))
    got = _nhwc(TA.apply_autoaugment(
        _nchw(img), **_tensors(_jax_autoaugment_draws(key, B))))
    np.testing.assert_array_equal(got, want)


def test_autoaugment_every_policy_and_both_coins():
    """All 12 sub-policies with both ops applied, and with both skipped,
    against the JAX variant bank evaluated at the same choices."""
    n = len(TA._POLICIES)
    img = np.random.RandomState(1).randint(0, 256, (n, H, W, 3)).astype(
        np.float32)
    for coin in (0.0, 1.0):  # 0: every op with p > 0 applies; 1: none
        draws = dict(pol_idx=np.arange(n), u1=np.full(n, coin, np.float32),
                     u2=np.full(n, coin, np.float32),
                     sign=np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(
                         np.float32))
        got = _nhwc(TA.apply_autoaugment(_nchw(img), **_tensors(draws)))
        want = jnp.asarray(img)
        sign = jnp.asarray(draws["sign"])[:, None, None, None]
        for stage in (0, 1):
            rows = []
            for i, pol in enumerate(JA._POLICIES):
                p, op, mi = pol[3 * stage: 3 * stage + 3]
                x = want[i: i + 1]
                if coin < p:
                    x = JA._apply_op(x, op, float(JA._RANGES[op][mi]),
                                     sign[i: i + 1], fast=True)
                rows.append(x)
            want = jnp.concatenate(rows)
        np.testing.assert_array_equal(got, np.asarray(want))
        if coin == 1.0:
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("seed", range(4))
def test_gridmask_replayed_draws_bit_exact(seed):
    key = jax.random.PRNGKey(100 + seed)
    img = np.random.RandomState(seed).randn(B, H, W, 3).astype(np.float32)
    want = np.asarray(JA.gridmask(jnp.asarray(img), key))
    got = _nhwc(TA.apply_gridmask(
        _nchw(img), **_tensors(_jax_gridmask_draws(key, B, H, W))))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got != 0).any()


def _replayed_views(key, img, style, jdt, tdt):
    k_aa, k_gm = jax.random.split(key)
    draws = dict(autoaugment=_tensors(_jax_autoaugment_draws(k_aa, B)),
                 gridmask=_tensors(_jax_gridmask_draws(k_gm, B, H, W)))
    want = np.asarray(JA.make_advmix_views(
        jnp.asarray(img), key, style_mask=jnp.asarray(style),
        compute_dtype=jdt, out_dtype=jdt).astype(jnp.float32))
    got = TA.make_advmix_views(_nchw(img), draws=draws,
                               style_mask=torch.from_numpy(style),
                               compute_dtype=tdt, out_dtype=tdt)
    return got, want


@pytest.mark.parametrize("seed", range(3))
def test_make_advmix_views_f32_bit_exact(seed):
    style = np.array([0, 1, 0, 0, 1, 0], np.float32)
    got, want = _replayed_views(jax.random.PRNGKey(seed), _image(seed),
                                style, None, None)
    assert got.shape == (B, 9, H, W) and got.dtype == torch.float32
    got = _nhwc(got)
    np.testing.assert_array_equal(got, want)
    for row in np.flatnonzero(style):  # stylized rows: three clean views
        np.testing.assert_array_equal(got[row, ..., 3:6], got[row, ..., 0:3])
        np.testing.assert_array_equal(got[row, ..., 6:9], got[row, ..., 0:3])
    plain = np.flatnonzero(style == 0)
    assert (got[plain, ..., 6:9] == 0).any()  # masked pixels are exactly 0


@pytest.mark.parametrize("seed", range(3))
def test_make_advmix_views_bf16_within_one_level(seed):
    style = np.zeros(B, np.float32)
    # fractional pixels, as the on-device warp leaves them
    img = _image(seed) * 0.37 + 11.3
    got, want = _replayed_views(jax.random.PRNGKey(seed), img, style,
                                jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=1 / (0.224 * 255) + 2 ** -6)


def test_draws_depend_on_the_seed_only():
    a = TA.draw_advmix_views(64, H, W, torch.Generator().manual_seed(7))
    b = TA.draw_advmix_views(64, H, W, torch.Generator().manual_seed(7))
    c = TA.draw_advmix_views(64, H, W, torch.Generator().manual_seed(8))
    for part in ("autoaugment", "gridmask"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k])
    assert not torch.equal(a["autoaugment"]["u1"], c["autoaugment"]["u1"])
    img = torch.from_numpy(_image()).permute(0, 3, 1, 2)
    v1 = TA.make_advmix_views(img, torch.Generator().manual_seed(3))
    v2 = TA.make_advmix_views(img, torch.Generator().manual_seed(3))
    assert torch.equal(v1, v2)


def test_draw_distributions():
    n = 20000
    g = torch.Generator().manual_seed(0)
    aa = TA.draw_autoaugment(n, g)
    counts = np.bincount(aa["pol_idx"].numpy(), minlength=12)
    assert counts.min() > n / 12 * 0.85 and counts.max() < n / 12 * 1.15
    assert set(aa["sign"].tolist()) == {-1.0, 1.0}
    assert abs(float(aa["sign"].mean())) < 0.03
    for u in (aa["u1"], aa["u2"]):
        assert 0 <= float(u.min()) and float(u.max()) < 1
        assert abs(float(u.mean()) - 0.5) < 0.01
    gm = TA.draw_gridmask(n, H, W, g)
    assert abs(float(gm["apply"].float().mean()) - 0.7) < 0.015
    assert int(gm["d"].min()) == 2 and int(gm["d"].max()) == min(H, W) - 1
    for st in (gm["st_h"], gm["st_w"]):
        assert int(st.min()) == 0 and bool((st < gm["d"]).all())


def test_tables_are_the_jax_packages():
    assert TA._POLICIES == JA._POLICIES
    for op in JA._RANGES:
        np.testing.assert_array_equal(TA._RANGES[op], JA._RANGES[op])
    for stage in (0, 1):
        jv, ji = JA._stage_variants(stage)
        tv, ti = TA._stage_variants(stage)
        assert jv == tv and (ji == ti).all()
