"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests need a CUDA device and nvcc; without a card they skip. The
file imports nothing of JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips `tests/conftest.py`, which imports jax.) The inputs
are `chip_smoke.py`'s, at the eval path's shapes and at shapes that cross
the kernels' tile, vector and alignment edges.

Tolerances: decode is bit-equal (the same comparisons, the same f32 adds
of 0.25), at COCO's and MPII's shapes; soft-argmax (plain PyTorch) within
1e-3 heatmap px of the CPU. OKS: rtol 1e-5, atol 1e-6, since CUDA's `expf` and torch's `exp`
may differ in the last bit. Keep lists: equal. Corruptions (plain PyTorch on
the card, no hand kernel): the card and the CPU at most 1 uint8 level apart
on at most 0.5% of values. The bottom-up infer (plain PyTorch, no hand
kernel) in float64: the card equals the CPU to 1e-12 of the range.
"""

import numpy as np
import pytest
import torch

from advmix_tpu_torch.native import greedy_from_matrix
from advmix_tpu_torch.ops.cuda.decode_kernel import (decode_heatmaps,
                                                     decode_heatmaps_plain,
                                                     decode_route)
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                  oks_matrix_batched,
                                                  oks_matrix_batched_plain)
from advmix_tpu_torch.ops.cuda.timing import (decode_by, oks_baseline,
                                              oks_by_micro)
from advmix_tpu_torch.ops.nms import oks_nms_np
from chip_smoke import card_vs_cpu, decode_inputs, flat_kpts, oks_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_matches_plain(cuda, post_process):
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


def shifted_view(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a contiguous view one element into a fresh buffer:
    4-byte aligned, neither 8 nor 16."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view_as(t)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,shift,route", [
    ((3, 5, 17, 13), False, "scalar"),   # H*W % 4 != 0
    ((2, 17, 64, 48), True, "scalar"),   # a 4-byte aligned view
    ((2, 17, 64, 48), False, "vector"),
    ((3, 5, 16, 12), False, "vector"),   # 15 maps: not whole blocks of 4
    ((1, 1, 2, 2), False, "vector")])    # one 16-byte value per map
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_routes_match_plain(cuda, shape, shift, route,
                                        post_process):
    rng = np.random.RandomState(sum(shape))
    hm = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    hm[0, 0] = torch.round(hm[0, 0] * 2) / 2  # exact ties
    if shift:
        hm = shifted_view(hm)
    assert decode_route(shape[2], shape[3], hm.data_ptr()) == route
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["scalar", "vector"])
def test_cuda_decode_designs_match_plain(cuda, design):
    """Either route, forced on the aligned eval-path maps, computes the
    same function."""
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    for post_process in (True, False):
        ck, mk = decode_by(design, hm, post_process)
        cp, mp = decode_heatmaps_plain(hm, post_process)
        assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["scalar", "vector"])
def test_cuda_decode_at_mpii_shape_matches_plain(cuda, design):
    """MPII's eval batch (128, 16, 64, 64): either route, bit for bit."""
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(1), 128, 16,
                                        64, 64)).to(cuda)
    for post_process in (True, False):
        ck, mk = decode_by(design, hm, post_process)
        cp, mp = decode_heatmaps_plain(hm, post_process)
        assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 17, 64, 48), (128, 16, 64, 64)])
def test_cuda_soft_argmax_matches_cpu(cuda, shape):
    """TEST.SOFT_ARGMAX's decode (plain PyTorch, no hand kernel): the card's
    coordinates within 1e-3 heatmap px of the CPU's (the softmax and the
    sums of 3,072 or 4,096 terms are ordered differently)."""
    from advmix_tpu_torch.ops.heatmap import soft_argmax
    from chip_smoke import peaked_maps

    hm = torch.from_numpy(peaked_maps(np.random.RandomState(2), *shape))
    pc, mc = soft_argmax(hm.to(cuda))
    pr, mr = soft_argmax(hm)
    assert float((pc.cpu() - pr).abs().max()) <= 1e-3
    near = ((pr - pr.floor() - 0.5).abs() < 1e-3).any(-1)
    assert not ((mc.cpu() != mr)[..., 0] & ~near).any()


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [
    (64, 2), (64, 15), (64, 16), (64, 17), (64, 33), (64, 128), (47, 32),
    (1, 2), (1, 33), (1, 128), (1, 130), (1, 300)])
def test_cuda_oks_matches_plain(cuda, m, p):
    """M=1 goes through the single-image wrapper (N=130 and 300 cross tile
    edges). The matrix is symmetric to the bit, every micro-tile size
    gives the same bits, and the keep lists of the greedy scan over the
    kernel's matrices equal the numpy OKS-NMS oracle."""
    kpts, scores, areas = oks_inputs(np.random.RandomState(m + p), m, p)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    wrapper = oks_matrix if m == 1 else oks_matrix_batched
    before = wrapper.launches
    got = oks_matrix(kt[0], at[0])[None] if m == 1 else oks_matrix_batched(
        kt, at)
    assert wrapper.launches == before + 1
    want = oks_matrix_batched_plain(kt, at)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, got.transpose(1, 2))
    for micro in (1, 2, 4):
        assert torch.equal(oks_by_micro(kt, at, micro), got)
    torch.testing.assert_close(oks_baseline(kt, at), want, rtol=1e-5,
                               atol=1e-6)
    sims = got.cpu().numpy()
    for i in range(min(m, 4)):
        keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32), 0.9)
        assert keep == oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                                  scores[i], areas[i], 0.9)


@pytest.mark.gpu
def test_cuda_oks_takes_a_4_byte_aligned_view(cuda):
    """The kernel loads (x, y) as one 8-byte value; the wrapper realigns a
    view that is not 8-byte aligned."""
    kpts, _, areas = oks_inputs(np.random.RandomState(5), 3, 33)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    assert torch.equal(oks_matrix_batched(shifted_view(kt), shifted_view(at)),
                       oks_matrix_batched(kt, at))


# ---------------------------------------------------------------------------
# AdvMix training on the card (no hand kernel: torch and cuDNN ops)
# ---------------------------------------------------------------------------

def _tiny_train_cfg():
    from advmix_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 6
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
    cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.TRAIN.OPTIMIZER = "adam"
    return cfg


@pytest.mark.gpu
def test_cuda_views_equal_cpu_views(cuda):
    """The 3-view synthesis on the card is the CPU's to the bit in f32 for
    integer-valued crops: integer histograms, exact LUTs, masks."""
    from advmix_tpu_torch.ops.augment import (draw_advmix_views,
                                              make_advmix_views)

    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 3, 64, 48)).astype(np.float32))
    draws = draw_advmix_views(8, 64, 48, torch.Generator().manual_seed(1))
    want = make_advmix_views(img, draws=draws)
    on_card = {part: {k: v.to(cuda) for k, v in d.items()}
               for part, d in draws.items()}
    got = make_advmix_views(img.to(cuda), draws=on_card)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-6)
    seeded = make_advmix_views(img.to(cuda),
                               torch.Generator().manual_seed(1))
    assert torch.equal(seeded, got)  # the draws do not depend on the device


@pytest.mark.gpu
def test_cuda_warp_affine_equals_cpu(cuda):
    from advmix_tpu_torch.ops.transforms import (get_affine_transform,
                                                 warp_affine)

    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randint(0, 256, (4, 200, 240, 3)).astype(
        np.uint8))
    mats = torch.from_numpy(np.stack([get_affine_transform(
        rng.uniform(60, 140, 2), rng.uniform(0.4, 1.2) * np.ones(2),
        rng.uniform(-40, 40), (48, 64)) for _ in range(4)]).astype(
            np.float32))
    want = warp_affine(img, mats, (48, 64))
    got = warp_affine(img.to(cuda), mats.to(cuda), (48, 64)).cpu()
    # f32 coordinates; the card may contract a*x + b*y + c into FMAs
    torch.testing.assert_close(got, want, rtol=0, atol=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_advmix_step_invariants(cuda, dtype):
    """Two AdvMix iterations on the card: f32 master weights, two BN
    updates per iteration, an untouched teacher, finite losses of the
    right signs."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net
    from advmix_tpu_torch.models.unet import UnetGenerator

    cfg = _tiny_train_cfg()
    state = create_advmix_state(cfg, get_pose_net(cfg),
                                UnetGenerator(ngf=8), cuda, dtype)
    teacher0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    d0 = [p.detach().clone() for p in state.model_d.parameters()]
    step = make_advmix_step(state, cfg, alpha=0.3, adv_loss_weight=0.7)
    rng = np.random.RandomState(3)
    for _ in range(2):
        batch = dict(
            views=torch.from_numpy(rng.randn(4, 9, 64, 64).astype(
                np.float32)).to(cuda, dtype),
            target=torch.from_numpy(rng.rand(4, 6, 16, 16).astype(
                np.float32)).to(cuda),
            target_weight=torch.ones(4, 6, device=cuda))
        m = {k: float(v) for k, v in step(batch).items()}
        assert np.isfinite(m["loss_d"]) and m["loss_d"] > 0 > m["loss_g"]
        w = step.last_mix_weights
        assert w.dtype == torch.float32
        torch.testing.assert_close(w.sum(1), torch.ones_like(w[:, 0]))
    assert all(p.dtype == torch.float32 for p in state.model_d.parameters())
    assert all(p.dtype == torch.float32 for p in state.model_g.parameters())
    assert any(not torch.equal(a, b) for a, b in
               zip(d0, state.model_d.parameters()))
    assert int(state.model_d.bn1.num_batches_tracked) == 4
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, teacher0[k])


@pytest.mark.gpu
def test_cuda_f32_advmix_step_matches_cpu(cuda):
    """One f32 SGD AdvMix step of PoseResNet-18 on the card against the CPU
    (TF32 off): every parameter within 2e-2 of its tensor's largest
    update."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.models.unet import UnetGenerator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_train_cfg()
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    rng = np.random.RandomState(4)
    batch = dict(
        views=torch.from_numpy(rng.randn(4, 9, 64, 64).astype(np.float32)),
        target=torch.from_numpy(rng.rand(4, 6, 16, 16).astype(np.float32)),
        target_weight=torch.ones(4, 6))
    after = []
    for dev in (torch.device("cpu"), cuda):
        model = get_pose_net(cfg)
        he_reinit_convs(model, torch.Generator().manual_seed(0))
        g = UnetGenerator(ngf=8)
        he_reinit_convs(g, torch.Generator().manual_seed(1))
        with torch.no_grad():  # the constructor drew them unseeded
            for name, p in g.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
        start = [p.detach().clone() for p in model.parameters()]
        state = create_advmix_state(cfg, model, g, dev, torch.float32)
        make_advmix_step(state, cfg, 0.3, 0.7)(
            {k: v.to(dev) for k, v in batch.items()})
        after.append([p.detach().cpu() for p in state.model_d.parameters()])
    for p0, a, b in zip(start, *after):
        moved = float((a - p0).abs().max())
        assert moved > 0
        assert float((a - b).abs().max()) <= 2e-2 * moved


# one severity per corruption form that draws nothing at random: the 8
# key-free types and the exact-render forms (spatter 4 is the mud arm, 2
# the water arm, which needs cv2)
KEY_FREE = ["defocus_blur", "zoom_blur", "brightness", "contrast", "pixelate",
            "jpeg_compression", "gaussian_blur", "saturate"]
CORRUPTION_CASES = ([(n, 3, False) for n in KEY_FREE]
                    + [(n, 3, True) for n in ("glass_blur", "motion_blur",
                                              "snow", "elastic_transform")]
                    + [("spatter", 4, True), ("spatter", 2, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,severity,exact", CORRUPTION_CASES)
def test_cuda_corruption_matches_cpu(cuda, name, severity, exact):
    """The card against the CPU on 4 seeded 256x192 crops, with cuDNN TF32
    allowed around the call (the module turns it off for its own convs),
    in uint8 after clip and truncation: at most 1 level apart on at most
    0.5% of values."""
    if name == "spatter" and severity <= 3:
        pytest.importorskip("cv2", reason="the exact water arm needs cv2")
    x = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (4, 256, 192, 3)).astype(np.float32))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        level, share = card_vs_cpu(x, cuda, name, severity, exact)
    assert level <= 1 and share <= 0.005, (level, share)


@pytest.mark.gpu
@pytest.mark.parametrize("name", KEY_FREE + [
    "gaussian_noise", "shot_noise", "impulse_noise", "speckle_noise",
    "glass_blur", "motion_blur", "snow", "frost", "fog", "elastic_transform",
    "spatter"])
def test_cuda_traced_corruption_in_range(cuda, name):
    """The generator-driven form on the card: shape, finite, [0, 255], and
    two seeds differ where the form draws at random."""
    from advmix_tpu_torch.ops.corruptions import DRAWS, corrupt

    x = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (4, 256, 192, 3)).astype(np.float32)).to(cuda)
    a, b = (corrupt(x, name, 3, torch.Generator(cuda).manual_seed(s))
            for s in (1, 2))
    for out in (a, b):
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert float(out.min()) >= 0 and float(out.max()) <= 255
    assert torch.equal(a, b) != (name in DRAWS)


@pytest.mark.gpu
@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.0, 2.0)])
def test_cuda_bottomup_infer_float64_matches_cpu(cuda, scales):
    """HigherHRNet-W32 at full width (seeded weights, BN calibrated) and a
    256x256 input: the bottom-up infer in float64 (flip test, the given
    TEST.SCALE_FACTOR) on the card equals the CPU's to 1e-12 of the range,
    heatmaps, tags and the peaks above 0.1, which sit at the same pixels."""
    from advmix_tpu_torch.config import get_default_config
    from chip_smoke import HIGHER_CFG, bottomup_infer_card_vs_cpu, \
        random_model

    cfg = get_default_config()
    cfg.merge_from_file(HIGHER_CFG)
    cfg.MODEL.IMAGE_SIZE = [256, 256]
    cfg.MODEL.HEATMAP_SIZE = [64, 64]
    cfg.TEST.SCALE_FACTOR = list(scales)
    cfg.freeze()
    model = random_model(cfg, torch.device("cpu"))
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 256, 256, 3))
    pairs = [[2 * i + 1, 2 * i + 2] for i in range(8)]
    r = bottomup_infer_card_vs_cpu(model, cfg, x, pairs, cuda)
    assert r["shape"] == (1, 17, 128, 128)
    assert r["heat"] < 1e-12 and r["tags"] < 1e-12, r
    assert r["n_above"] > 0 and r["same_pixels"] and r["peak_val"] < 1e-12, r
