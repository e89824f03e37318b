"""The port's W8A8 quantization (advmix_tpu_torch/ops/quant.py,
ops/int8_conv.py) against the JAX package's `advmix_tpu/ops/quant.py`.

The same seeded numpy weights, images and scales go through both packages
on the CPU (scales and int8 kernels carried across by `scales_from_jax` /
`prequantized_from_jax`, weights by `models/convert.py`):

- the quantizers: codes and scales bit-equal;
- one convolution against JAX `_quantized_conv` (called eagerly): int8
  codes, int32 sums and f32 output bit-equal, for 3x3 stride 1 and 2, 1x1,
  with and without bias, and the stem's depth 27; the card's im2col +
  `torch._int_mm` route, run here on the CPU, gives the same sums;
- calibration (abs-max and percentile, with the subsampling stride): the
  same set of paths after mapping, scales within rtol 1e-6;
- PoseResNet-18 at 64x64 and a tiny HRNet in f32 against JAX
  `make_quantized_apply`: heatmaps within 1e-5 of their range, at most
  0.1% of the activation codes one step apart (the two f32 forwards sum in
  other orders, so a value at a rounding tie could land either side);
- prequantized equals on the fly; an int8 weight without a scale raises;
  the warnings for zero and unmatched paths;
- the int8 teacher inside two AdvMix iterations, float64 on both sides
  (the recipe of tests/test_quant.py:263), within 1e-9.
"""

import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import enable_x64, lax

from advmix_tpu.config import get_default_config as jax_default_config
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu.ops import quant as jq
from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict
from advmix_tpu_torch.models.layers import Conv2d, set_compute_dtype
from advmix_tpu_torch.ops import quant
from advmix_tpu_torch.ops.int8_conv import im2col_nhwc, int8_conv2d, \
    int_mm_padded, weight_matrix

from torch_port_util import TINY_EXTRA, random_variables, unflatten

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# quantizers and one convolution
# ---------------------------------------------------------------------------

def test_quantizers_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 3, 32, 48) * rng.uniform(0.01, 2, 48)).astype(
        np.float32)  # HWIO, per-channel ranges far apart
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
    wq, s = quant.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(wq_j),
                                  wq.permute(2, 3, 1, 0).numpy())
    np.testing.assert_array_equal(np.asarray(s_j), s.numpy())
    x = (rng.randn(4, 9, 7, 5) * 3).astype(np.float32)
    for scale in (0.0123456789, 3.0 / 127, 1e-3):
        np.testing.assert_array_equal(
            np.asarray(jq.quantize_activation(jnp.asarray(x), scale)),
            quant.quantize_activation(torch.from_numpy(x), scale).numpy())
    # a bf16 input is quantized from its f32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(jq.quantize_activation(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), 0.01)),
        quant.quantize_activation(xb, 0.01).numpy())


CONVS = {  # kernel, stride, padding, cin, cout, bias
    "3x3_s1": (3, 1, 1, 16, 32, False),
    "3x3_s1_bias": (3, 1, 1, 16, 32, True),
    "3x3_s2": (3, 2, 1, 16, 24, False),
    "3x3_s2_bias": (3, 2, 1, 16, 24, True),
    "1x1": (1, 1, 0, 32, 16, False),
    "1x1_bias": (1, 1, 0, 32, 16, True),
    "stem_k27": (3, 2, 1, 3, 64, False),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_quant_conv_bit_equal_to_jax(name):
    k, s, p, cin, cout, bias = CONVS[name]
    rng = np.random.RandomState(len(name))
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    x = rng.randn(2, 13, 10, cin).astype(np.float32)
    scale = float(np.abs(x).max()) / 127 * 1.2

    conv_j = nn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                     use_bias=bias)
    params = {"kernel": jnp.asarray(w)}
    if bias:
        params["bias"] = jnp.asarray(b)
    bound = conv_j.bind({"params": params})
    y_j = np.asarray(jq._quantized_conv(bound, jnp.asarray(x), scale))
    wq_j, _ = jq.quantize_weight(jnp.asarray(w))
    xq_j = jq.quantize_activation(jnp.asarray(x), scale)
    acc_j = np.asarray(lax.conv_general_dilated(
        xq_j, wq_j, (s, s), ((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))

    conv = Conv2d(cin, cout, k, s, p, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    qconv = quant.QuantConv2d(conv, scale)
    xt = _nchw(x)
    xq = quant.quantize_activation(xt, scale)
    wq, _ = quant.quantize_weight(conv.weight)
    acc = int8_conv2d(xq, wq, [s, s], [p, p])
    y = qconv(xt)

    np.testing.assert_array_equal(np.asarray(xq_j), _nhwc(xq))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc_j, acc.numpy())
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y_j, _nhwc(y))
    # the card's route (im2col of the codes + torch._int_mm, padded to its
    # shape rules), run on the CPU, sums the same
    cols = im2col_nhwc(xq, k, k, [s, s], [p, p])
    assert cols.dtype == torch.int8 and cols.shape[1] == k * k * cin
    mm = int_mm_padded(cols, weight_matrix(wq))
    np.testing.assert_array_equal(mm.reshape(acc.shape).numpy(), acc_j)


def test_int_mm_padding_rules():
    """Rows, depth and width are padded to what torch._int_mm takes on
    CUDA, and the result sliced back: a 5-row, depth-27, width-12
    product."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (5, 27), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (27, 12), generator=g, dtype=torch.int8)
    got = int_mm_padded(a, b)
    assert got.shape == (5, 12) and got.dtype == torch.int32
    assert torch.equal(got, (a.long() @ b.long()).int())


def test_int8_conv2d_exports_with_a_symbolic_batch():
    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", torch.ones(8, 3, 3, 3,
                                                 dtype=torch.int8))

        def forward(self, x):
            return int8_conv2d(x, self.w, [2, 2], [1, 1])

    x = torch.ones(2, 3, 9, 7, dtype=torch.int8)
    ep = torch.export.export(One(), (x,), dynamic_shapes=(
        {0: torch.export.Dim("b", min=1, max=64)},))
    out = ep.module()(torch.ones(5, 3, 9, 7, dtype=torch.int8))
    assert out.shape == (5, 5, 4, 8) and out.dtype == torch.int32
    assert int(out[0, 2, 2, 0]) == 27  # an interior 3x3x3 window of ones


# ---------------------------------------------------------------------------
# models: calibration and the quantized forward
# ---------------------------------------------------------------------------

J = 6


def _cfg(default, family):
    cfg = default()
    cfg.defrost()
    cfg.MODEL.NUM_JOINTS = J
    cfg.MODEL.INIT_WEIGHTS = False
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    if family == "resnet":
        cfg.MODEL.NAME = "pose_resnet"
        cfg.MODEL.EXTRA.NUM_LAYERS = 18
        cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
        cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
        cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
        cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
        cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    else:
        cfg.MODEL.NAME = "pose_hrnet"
        cfg.MODEL.EXTRA = {k: (dict(v) if isinstance(v, dict) else v)
                           for k, v in TINY_EXTRA.items()}
    cfg.freeze()
    return cfg


class Pair:
    """One family in both packages with the same seeded f32 weights."""

    def __init__(self, family, seed=3):
        self.family = family
        self.jm = jax_get_pose_net(_cfg(jax_default_config, family),
                                   dtype=jnp.float32)
        tree = jax.eval_shape(lambda: self.jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
        self.flat = random_variables({"/".join(k): v
                                      for k, v in flat.items()}, seed)
        self.vs = unflatten(self.flat)
        self.model = get_pose_net(_cfg(get_default_config, family))
        self.model.load_state_dict(jax_to_torch_state_dict(self.flat,
                                                           self.model))
        self.model.eval()
        rng = np.random.RandomState(seed + 100)
        self.calib = [rng.randn(2, 64, 64, 3).astype(np.float32)
                      for _ in range(2)]
        self.x = rng.randn(2, 64, 64, 3).astype(np.float32)

    def jax_scales(self, **kw):
        return jq.calibrate_act_scales(
            self.jm, self.vs, [jnp.asarray(c) for c in self.calib], **kw)

    def port_scales(self, **kw):
        return quant.calibrate_act_scales(
            self.model, [_nchw(c) for c in self.calib], **kw)


@pytest.fixture(scope="module", params=["resnet", "hrnet"])
def pair(request):
    return Pair(request.param)


@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_calibration_matches_jax(pair, method):
    """PoseResNet-18 in f32; the tiny HRNet in float64 on both sides, since
    its two f32 forwards drift ~1e-6 apart through ~100 BatchNorms (the
    ranges are still taken in f32, as both packages take them)."""
    kw = dict(method=method, margin=1.2)
    if method == "percentile":
        kw["percentile"] = 99.0
    if pair.family == "resnet":
        want = quant.scales_from_jax(pair.jax_scales(**kw), pair.model)
        got = pair.port_scales(**kw)
    else:
        with enable_x64(True):
            jm = pair.jm.clone(dtype=jnp.float64)
            vs = jax.tree.map(lambda a: np.asarray(a, np.float64), pair.vs)
            want = quant.scales_from_jax(jq.calibrate_act_scales(
                jm, vs, [jnp.asarray(c, jnp.float64) for c in pair.calib],
                **kw), pair.model)
        model = pair.model.double()
        try:
            got = quant.calibrate_act_scales(
                model, [_nchw(c).double() for c in pair.calib], **kw)
        finally:
            pair.model.float()
    assert set(got) == set(want) and len(got) > 10
    assert set(got) == set(quant.conv_paths(pair.model))
    assert not any("final_layer" in p for p in got)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-6, err_msg=p)


def test_percentile_subsamples_the_nhwc_flattening():
    """3 * 2^20 values: both packages keep every (size >> 20) = 3rd value
    of the NHWC flattening, channel 0's alone here, so the percentiles
    agree; the NCHW flattening would mix the channels."""
    class JOne(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.Conv(4, (1, 1), name="c1")(x)

    x = (np.random.RandomState(4).standard_cauchy((1, 1024, 1024, 3))
         ).astype(np.float32) * np.array([1, 10, 100], np.float32)
    jm = JOne()
    vs = jm.init(jax.random.PRNGKey(0), x[:, :8, :8])
    want = jq.calibrate_act_scales(jm, vs, [jnp.asarray(x)],
                                   method="percentile", percentile=99.0)
    conv = Conv2d(3, 4, 1, bias=True)
    got = quant.calibrate_act_scales(torch.nn.Sequential(conv), [_nchw(x)],
                                     method="percentile", percentile=99.0)
    np.testing.assert_allclose(got["0"], want["c1"], rtol=1e-6)
    flat = np.abs(_nchw(x).numpy().reshape(-1))[::(x.size >> 20)]
    assert np.percentile(flat, 99.0) / 127 > 10 * want["c1"]


def _codes_jax(pair, scales):
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Conv) and context.method_name == "__call__":
            path = jq._path_of(mod)
            if path in scales:
                seen[path.rsplit("/", 1)[-1]] = np.asarray(
                    jq.quantize_activation(args[0], scales[path]))
        return next_fun(*args, **kwargs)

    q_apply = jq.make_quantized_apply(pair.jm, scales)
    with nn.intercept_methods(interceptor):
        out = q_apply(pair.vs, jnp.asarray(pair.x), train=False)
    return np.asarray(out), seen


def test_quantized_models_match_jax(pair):
    from advmix_tpu_torch.models.convert import flax_module_name

    jscales = pair.jax_scales()
    scales = quant.scales_from_jax(jscales, pair.model)
    want, codes_j = _codes_jax(pair, jscales)
    q = quant.quantize_model(pair.model, scales)
    assert q.quantized_paths == set(scales)
    codes = {}
    for name in q.quantized_paths:
        mod = q.get_submodule(name)
        mod.register_forward_pre_hook(
            lambda m, a, n=name: codes.__setitem__(
                flax_module_name(n),
                _nhwc(quant.quantize_activation(a[0], m.act_scale))))
    with torch.no_grad():
        got = _nhwc(q(_nchw(pair.x)))
    ref = np.asarray(pair.jm.apply(pair.vs, jnp.asarray(pair.x),
                                   train=False))
    rng = float(ref.max() - ref.min())
    assert np.isfinite(got).all() and got.shape == want.shape
    err = float(np.abs(got - want).max()) / rng
    assert err < 1e-5, err
    assert set(codes) == set(codes_j)
    n = sum(c.size for c in codes.values())
    diff = [np.abs(codes[k].astype(int) - codes_j[k].astype(int))
            for k in codes]
    assert max(int(d.max()) for d in diff) <= 1
    share = sum(int((d > 0).sum()) for d in diff) / n
    assert share <= 1e-3, share
    # and int8 really moved the output off the f32 forward
    assert float(np.abs(want - ref).max()) > 10 * float(
        np.abs(got - want).max())


def test_quantize_model_keeps_the_compute_dtype_and_refuses_bf16_weights():
    p = Pair("resnet")
    scales = p.port_scales()
    set_compute_dtype(p.model, torch.bfloat16, trainable=True)
    q = quant.quantize_model(p.model, scales)
    assert q.compute_dtype == torch.bfloat16
    assert q.final_layer.weight.dtype == torch.bfloat16  # skipped, cast
    assert q.conv1.weight.dtype == torch.float32  # quantized from f32
    with torch.no_grad():
        out = q(_nchw(p.x))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert not any(t.requires_grad for t in q.parameters())
    frozen = set_compute_dtype(p.model, torch.bfloat16)
    with pytest.raises(ValueError, match="f32 weights"):
        quant.quantize_model(frozen, scales)


def test_prequantized_equals_on_the_fly_and_jax_kernels():
    p = Pair("resnet")
    jscales = p.jax_scales()
    scales = quant.scales_from_jax(jscales, p.model)
    x = _nchw(p.x)
    with torch.no_grad():
        ref = quant.quantize_model(p.model, scales)(x)
        pre, w_scales = quant.prequantize_params(p.model, scales)
        out = pre(x)
    assert torch.equal(out, ref)
    assert set(w_scales) == set(scales)
    assert pre.conv1.weight.dtype == torch.int8
    assert pre.final_layer.weight.dtype == torch.float32  # skipped
    assert p.model.conv1.weight.dtype == torch.float32  # source untouched
    # the JAX package's int8 kernels and scales land in the same buffers
    qparams, jw = jq.prequantize_params(p.vs["params"], jscales)
    flat = {"params/" + "/".join(k): np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(qparams).items()}
    flat.update({k: v for k, v in p.flat.items()
                 if k.startswith("batch_stats/")})
    state, ws = quant.prequantized_from_jax(flat, jw, p.model)
    assert set(ws) == set(w_scales)
    own = pre.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert state[k].dtype == v.dtype, k
        assert torch.equal(state[k], v), k
    # a prequantized copy loaded with them runs the same forward
    again, _ = quant.prequantize_params(p.model, scales)
    again.load_state_dict(state)
    with torch.no_grad():
        assert torch.equal(again(x), ref)


def test_int8_weight_without_scale_raises():
    conv = Conv2d(3, 8, 3, 1, 1)
    wq, scale = quant.quantize_weight(conv.weight)
    conv.weight = torch.nn.Parameter(wq, requires_grad=False)
    with pytest.raises(ValueError, match="weight scale"):
        quant.QuantConv2d(conv, 0.1)
    net = torch.nn.Sequential(conv)
    with pytest.raises(ValueError, match="weight scale"):
        quant.quantize_model(net, {"0": 0.1})
    q = quant.quantize_model(net, {"0": 0.1}, w_scales={"0": scale})
    assert torch.equal(q[0].weight, wq) and torch.equal(q[0].w_scale, scale)


def test_warnings_for_zero_and_unmatched_paths():
    p = Pair("resnet")
    with pytest.warns(UserWarning, match="ZERO convs"):
        q = quant.quantize_model(p.model, {"no.such.conv": 0.1})
    assert q.quantized_paths == set()
    scales = p.port_scales()
    scales["renamed.conv"] = 0.1
    with pytest.warns(UserWarning, match="1 calibrated path"):
        q = quant.quantize_model(p.model, scales)
    assert len(q.quantized_paths) == len(scales) - 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        del scales["renamed.conv"]
        quant.quantize_model(p.model, scales)
    # a fallback scale covers the convs without one; skip stays substring
    q = quant.quantize_model(p.model, {}, fallback_scale=0.05,
                             skip=("final_layer", "layer4"))
    assert q.quantized_paths == {n for n in quant.conv_paths(p.model)
                                 if "layer4" not in n}


def test_int8_teacher_from_config_calib_images():
    """The constructor `tools/bench.py` uses: calibrated on normalized
    images, the teacher tracks D's float forward within int8 rounding (a
    mean |difference| under 1% of the output's range; 0.25% here), D
    itself is untouched, and neither images nor a loader raises (as
    tests/test_quant.py:382-385 has it for the JAX function)."""
    p = Pair("resnet")
    x = _nchw(p.x)
    teacher, scales = quant.int8_teacher_from_config(
        torch.float32, p.model, device=torch.device("cpu"),
        calib_images=[_nchw(c) for c in p.calib])
    assert scales == pytest.approx(p.port_scales())
    assert isinstance(p.model.conv1, torch.nn.Conv2d)
    with torch.no_grad():
        ref = p.model(x)
        err = float((teacher(x) - ref).abs().mean())
    assert 0 < err < 0.01 * float(ref.max() - ref.min()), err
    with pytest.raises(ValueError, match="calib_images"):
        quant.int8_teacher_from_config(torch.float32, p.model,
                                       device=torch.device("cpu"))


def test_higher_hrnet_final_layers_are_skipped():
    from advmix_tpu_torch.models.higher_hrnet import HigherHRNet

    extra = {k: v for k, v in TINY_EXTRA.items() if k.startswith("STAGE")}
    model = HigherHRNet(stage2_cfg=extra["STAGE2"],
                        stage3_cfg=extra["STAGE3"],
                        stage4_cfg=extra["STAGE4"], num_joints=17,
                        tag_per_joint=True, num_deconv_filters=(4,),
                        num_basic_blocks=1)
    paths = quant.conv_paths(model)
    convs = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert sorted(set(convs) - set(paths)) == ["final_layers.0",
                                                "final_layers.1"]


# ---------------------------------------------------------------------------
# the int8 teacher in the AdvMix step
# ---------------------------------------------------------------------------

def test_int8_teacher_in_advmix_step_matches_jax_f64():
    """The recipe of tests/test_quant.py:263 on the tiny HRNet in float64:
    the teacher's scales calibrated on the clean view, its forward W8A8
    (codes and rescale in f32, as both packages compute them), two AdvMix
    iterations against the JAX step with `make_int8_teacher_apply`.

    The port's int8 teacher equals the JAX function applied eagerly to
    1e-12 of the output's range. Inside the jitted JAX step XLA rounds the
    teacher's f32 rescale otherwise (its weight scales are absmax * (1 /
    127), and the rescale and bias may fuse): its KD target sits up to
    ~4e-8 of the range from the eager one, which moves D by ~6e-8. So D, G
    and the losses are held within 2e-7, and the same step with the float
    teacher lands more than 100x farther from the JAX int8 step."""
    import optax

    from advmix_tpu.engine.state import AdvMixState as JState
    from advmix_tpu.engine.steps import make_advmix_step as jax_step
    from advmix_tpu.parallel import get_mesh
    from advmix_tpu_torch.engine.state import AdvMixState, make_teacher
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models.convert import torch_to_jax_leaves

    import test_torch_train_steps as ts

    with enable_x64(True):
        setup = ts.Setup("hrnet", np.float64)
        vt = unflatten(setup.flat_t)
        clean = setup.batches[0]["views"][:, :3].transpose(0, 2, 3, 1)
        jscales = jq.calibrate_act_scales(setup.jd, vt, [jnp.asarray(clean)])
        assert len(jscales) > 10
        t_apply = jq.make_int8_teacher_apply(setup.jd, jscales)
        t_eager = np.asarray(t_apply(vt, jnp.asarray(clean)))

        vd, pg = unflatten(setup.flat_d), unflatten(setup.flat_g)["params"]
        tx_d, tx_g = optax.sgd(ts.LR_D), optax.sgd(ts.LR_G)
        jstate = JState(
            params_d=vd["params"], batch_stats_d=vd["batch_stats"],
            opt_state_d=tx_d.init(vd["params"]), params_g=pg,
            opt_state_g=tx_g.init(pg), params_t=vt["params"],
            batch_stats_t=vt["batch_stats"], step=jnp.zeros((), jnp.int32))
        step_j = jax_step(setup.jd, setup.jg, tx_d, tx_g, setup.jcfg,
                          get_mesh(1), alpha=ts.ALPHA,
                          adv_loss_weight=ts.ADV_W, num_views=3,
                          teacher_apply=t_apply)
        want_m = []
        for batch in setup.batches:
            jstate, m = step_j(jstate, ts._to_jax(batch))
            want_m.append({k: float(v) for k, v in m.items()})
        want_d = ts._jax_leaves(jstate.params_d, "params")
        want_d.update(ts._jax_leaves(jstate.batch_stats_d, "batch_stats"))
        want_g = ts._jax_leaves(jstate.params_g, "params")

    t_model = setup.port_d(setup.flat_t)
    scales = quant.scales_from_jax(jscales, t_model)
    # calibrating the port's teacher on the same view gives the same scales
    own = quant.calibrate_act_scales(t_model, [_nchw(clean)])
    assert set(own) == set(scales)
    for k in scales:
        np.testing.assert_allclose(own[k], scales[k], rtol=1e-6)
    teacher = quant.make_int8_teacher(t_model, scales)
    assert teacher.compute_dtype == torch.float64
    with torch.no_grad():
        t_out = _nhwc(teacher(_nchw(clean)))
        f_out = _nhwc(t_model.eval()(_nchw(clean)))
    rng = float(np.ptp(t_eager))
    assert float(np.abs(t_out - t_eager).max()) <= 1e-12 * rng
    assert float(np.abs(f_out - t_eager).max()) > 1e-3 * rng  # int8 moved it

    def run(t):
        d, g = setup.port_d(setup.flat_d), setup.port_g()
        state = AdvMixState(d, torch.optim.SGD(d.parameters(), lr=ts.LR_D),
                            g, torch.optim.SGD(g.parameters(), lr=ts.LR_G), t)
        step = make_advmix_step(state, setup.cfg, alpha=ts.ALPHA,
                                adv_loss_weight=ts.ADV_W)
        m = [{k: float(v) for k, v in step(ts._to_torch(b)).items()}
             for b in setup.batches]
        return torch_to_jax_leaves(d), torch_to_jax_leaves(g), m

    got_d, got_g, got_m = run(teacher)
    gap = max(ts._max_diff(got_d, want_d), ts._max_diff(got_g, want_g))
    assert gap < 2e-7, gap
    for got, ref in zip(got_m, want_m):
        for k in ref:
            assert abs(got[k] - ref[k]) < 2e-7, (k, got[k], ref[k])
    float_d, _, _ = run(make_teacher(t_model, torch.float64))
    assert ts._max_diff(float_d, want_d) > 100 * gap
