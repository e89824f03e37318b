"""The port's serving path on the CPU: `tools/export.py` (torch.export of
the inference function), `tools/serve.py` (PoseServer and its HTTP
protocol) and `tools/serving_bench.py`'s workloads.

- exports of PoseResNet-18 64x64 (experiments/synthetic/res18_64x64_smoke.
  yaml) at a fixed batch of 4 and batch-polymorphic (batch 0), each loaded
  back and run, the polymorphic one at batch 7 too;
- `PoseServer.predict` equals the port's eval step (`make_eval_step(...)
  .forward` + decode) bit for bit, and the JAX package's `build_infer_fn`
  on the same weights: scores within 1e-5 of the heatmaps' range, and the
  decoded coordinates equal on at least 99% of the joints (the two f32
  forwards sum in other orders, so a near-tie between two pixels can go
  either way), every coordinate within one heatmap pixel;
- a partial batch is padded with its last row and sliced back; an
  oversized batch is refused; a program exported for another device is
  refused; the server loads with the port's model code blocked;
- GET /healthz and POST /predict over HTTP on port 0, the JAX server's
  wire format (.npy in, .npy or .npz out);
- the bottom-up export (a narrowed HigherHRNet) returns the named arrays of
  `bottomup_infer_fn`, equal to it, also at batch 7 from a polymorphic
  program;
- `--int8`: the prequantized program is served and equals the quantized
  model's eval step; `--int8` on a bottom-up config is refused.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.engine.steps import bottomup_infer_fn, make_eval_step
from advmix_tpu_torch.models import get_pose_net, load_model_file
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict
from advmix_tpu_torch.ops.cuda.decode_kernel import decode_heatmaps
from advmix_tpu_torch.tools import export as export_tool
from advmix_tpu_torch.tools import serve as serve_tool
from advmix_tpu_torch.tools import serve_check
from advmix_tpu_torch.tools import serving_bench

from test_torch_bottomup_steps import _write_yaml, coco_tree  # noqa: F401
from test_torch_higher_hrnet import seeded_higher
from torch_port_util import random_variables, unflatten

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
CPU = torch.device("cpu")


def _jax_export_module():
    """The JAX package's tools/export.py (it imports `_parse` from its own
    directory)."""
    tools = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_export", os.path.join(tools, "export.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded He-normal weights of the smoke model in both packages: the
    flat JAX variables and the port's `.pth` of them."""
    jcfg = jax_load_config(SMOKE)
    jm = jax_get_pose_net(jcfg, dtype=jnp.float32)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    flat = random_variables({"/".join(k): v for k, v in flat.items()}, 7)
    model = get_pose_net(load_config(SMOKE))
    model.load_state_dict(jax_to_torch_state_dict(flat, model))
    path = str(tmp_path_factory.mktemp("w") / "d.pth")
    torch.save(model.state_dict(), path)
    return dict(jcfg=jcfg, jm=jm, flat=flat, path=path)


def _export(out_dir, cfg_path, *flags, cwd=None):
    old = os.getcwd()
    os.chdir(cwd or os.path.dirname(out_dir))
    try:
        return export_tool.main(["--cfg", cfg_path, "--device", "cpu",
                                 "--out", out_dir, *flags])
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def exports(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("exports")
    out = {}
    for name, flags in (("b4", ["--batch", "4"]), ("b0", ["--batch", "0"]),
                        ("int8", ["--batch", "4", "--int8"])):
        out[name] = _export(str(root / name), SMOKE, *flags, "TEST.MODEL_FILE",
                            weights["path"], "DATASET.SYNTH_LENGTH", "32")
    return out


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 64, 64, 3).astype(np.float32)


def _eval_step_preds(model, images):
    """The port's eval step on `images`: forward + decode, (B, J, 3)."""
    cfg = load_config(SMOKE)
    step = make_eval_step(model, cfg, [[i, i + 1] for i in range(0, 8, 2)])
    with torch.no_grad():
        coords, maxvals = decode_heatmaps(
            step.forward(torch.from_numpy(images)), True)
    return torch.cat([coords, maxvals], -1).numpy()


def test_export_writes_program_weights_and_meta(exports):
    for name, batch in (("b4", 4), ("b0", 0), ("int8", 4)):
        e = exports[name]
        assert os.path.isfile(e["path"]) and os.path.isfile(e["final_state"])
        assert e["meta"]["batch"] == batch and e["meta"]["device"] == "cpu"
        assert e["meta"]["image_hw"] == [64, 64]
        assert e["meta"]["int8"] == (name == "int8")
    # a symbolic leading dimension only in the polymorphic program
    shape0 = exports["b0"]["program"].graph_signature.user_inputs
    assert shape0
    # the archive does not carry the example batch it was traced on
    assert os.path.getsize(exports["b4"]["path"]) < 1.1 * os.path.getsize(
        exports["b0"]["path"])
    # the int8 artifact stores its quantized weights int8, and its
    # activation scales beside them
    scales_path = os.path.join(exports["int8"]["out_dir"],
                               export_tool.INT8_SCALES)
    with open(scales_path) as f:
        assert json.load(f) == exports["int8"]["act_scales"]
    assert len(exports["int8"]["act_scales"]) == 20
    sd = torch.load(exports["int8"]["final_state"])
    assert sd["conv1.weight"].dtype == torch.int8
    assert sd["conv1.w_scale"].dtype == torch.float32
    assert sd["final_layer.weight"].dtype == torch.float32


def test_server_equals_eval_step_bit_for_bit(weights, exports):
    model = get_pose_net(load_config(SMOKE))
    load_model_file(model, weights["path"])
    model.eval()
    x = _images(4)
    want = _eval_step_preds(model, x)
    for name in ("b4", "b0"):
        server = serve_tool.PoseServer(os.path.dirname(exports[name]["path"]),
                                       "cpu")
        got = server.predict(x)
        assert got.dtype == np.float32 and got.shape == (4, 8, 3)
        np.testing.assert_array_equal(got, want)
    # the polymorphic program at batch 7, and the eval step run on the
    # server's device thread
    x7 = _images(7, seed=1)
    np.testing.assert_array_equal(server.predict(x7),
                                  _eval_step_preds(model, x7))
    np.testing.assert_array_equal(server.call(_eval_step_preds, model, x7),
                                  server.predict(x7))
    server.close()


@pytest.mark.parametrize("process", [(False, False), (True, False),
                                     (True, True)])
def test_server_owns_its_cudnn_flags(exports, process):
    """Each device call allows only cuDNN's deterministic plans, whatever
    the process set, and keeps the process's `benchmark` (autotuning then
    picks among deterministic plans); the process's flags are back after
    the call."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = process
    try:
        server = serve_tool.PoseServer(
            os.path.dirname(exports["b0"]["path"]), "cpu")
        assert server.call(lambda: (cudnn.benchmark, cudnn.deterministic)
                           ) == (process[0], True)
        assert (cudnn.benchmark, cudnn.deterministic) == process
        server.close()
    finally:
        cudnn.benchmark, cudnn.deterministic = before


def test_serve_check_times_and_probes_a_cpu_server(exports):
    """tools/serve_check's parts on a CPU server: every timed predict has
    the first's bits; the repeat probe finds no two answers on the CPU and
    puts the process's cuDNN flags back."""
    server = serve_tool.PoseServer(
        os.path.dirname(exports["b0"]["path"]), "cpu")
    t = serve_check.time_predict(server, 3, 2)
    assert t["same"] and len(t["ms"]) == 2 and t["best_ms"] > 0
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    assert serve_check.repeat_probe(server, 2) == {"thread": [],
                                                   "server": []}
    assert (cudnn.benchmark, cudnn.deterministic) == before
    server.close()


def test_server_matches_jax_build_infer_fn(weights, exports):
    jexp = _jax_export_module()
    jcfg = weights["jcfg"]
    infer = jexp.build_infer_fn(weights["jm"], jcfg,
                                [[i, i + 1] for i in range(0, 8, 2)])
    vs = unflatten(weights["flat"])
    x = _images(4, seed=2)
    want = np.asarray(jax.jit(infer)(vs["params"], vs["batch_stats"],
                                     jnp.asarray(x)))
    server = serve_tool.PoseServer(os.path.dirname(exports["b4"]["path"]),
                                   "cpu")
    got = server.predict(x)
    assert got.shape == want.shape
    score_rng = float(want[..., 2].max() - want[..., 2].min())
    assert np.abs(got[..., 2] - want[..., 2]).max() <= 1e-5 * score_rng
    same = (got[..., :2] == want[..., :2]).all(-1)
    assert same.mean() >= 0.99, same.mean()
    assert np.abs(got[..., :2] - want[..., :2]).max() <= 1.0


def test_partial_batch_is_padded_and_oversized_refused(exports):
    server = serve_tool.PoseServer(os.path.dirname(exports["b4"]["path"]),
                                   "cpu")
    x = _images(3, seed=3)
    padded = np.concatenate([x, x[-1:]], axis=0)
    np.testing.assert_array_equal(server.predict(x),
                                  server.predict(padded)[:3])
    with pytest.raises(ValueError, match="exceeds the program's size 4"):
        server.predict(_images(5))
    with pytest.raises(ValueError, match=r"expected \(B, 64, 64, 3\)"):
        server.predict(np.zeros((2, 32, 64, 3), np.float32))


def test_server_refuses_a_program_of_another_device(exports, tmp_path):
    src = os.path.dirname(exports["b4"]["path"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_tool.PoseServer(src)  # the card by default
    # a program recorded as exported on the card is not served on the CPU
    extra = {"meta.json": ""}
    ep = torch.export.load(exports["b4"]["path"], extra_files=extra)
    meta = dict(json.loads(extra["meta.json"]), device="cuda")
    torch.export.save(ep, str(tmp_path / "pose_infer.pt2"),
                      extra_files={"meta.json": json.dumps(meta)})
    with pytest.raises(ValueError, match="exported on cuda"):
        serve_tool.PoseServer(str(tmp_path), "cpu")


def test_server_loads_without_model_code(exports):
    code = f"""
import sys
BLOCKED = ("advmix_tpu_torch.models", "advmix_tpu_torch.engine",
           "advmix_tpu_torch.tools.export", "jax", "advmix_tpu.")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(BLOCKED):
            raise ImportError("blocked import of " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from advmix_tpu_torch.tools.serve import PoseServer
s = PoseServer({os.path.dirname(exports['int8']['path'])!r}, "cpu")
print(s.predict(np.zeros((2, 64, 64, 3), np.float32)).shape)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT,
                                   CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "(2, 8, 3)"


def test_http_healthz_and_predict(exports):
    server = serve_tool.PoseServer(os.path.dirname(exports["b0"]["path"]),
                                   "cpu")
    httpd = serve_tool.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        info = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert info == {"status": "ok", "batch": "polymorphic",
                        "image_hw": [64, 64], "n_params": server.n_params,
                        "outputs": "preds"}
        x = _images(3, seed=4)
        buf = io.BytesIO()
        np.save(buf, x)
        body = urllib.request.urlopen(urllib.request.Request(
            base + "/predict", data=buf.getvalue())).read()
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      server.predict(x))
        buf = io.BytesIO()
        np.save(buf, np.zeros((1, 8, 8, 3), np.float32))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=buf.getvalue()))
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nothing")
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_int8_export_serves_the_quantized_model(exports):
    server = serve_tool.PoseServer(os.path.dirname(exports["int8"]["path"]),
                                   "cpu")
    x = _images(4, seed=5)
    got = server.predict(x)
    want = _eval_step_preds(exports["int8"]["model"], x)
    np.testing.assert_array_equal(got, want)
    assert len(exports["int8"]["model"].quantized_paths) == 20


def test_bottomup_export_named_outputs(coco_tree, tmp_path):  # noqa: F811
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    model, _ = seeded_higher(seed=4, joints=17)
    torch.save(model.state_dict(), tmp_path / "start.pth")
    with pytest.raises(ValueError, match="top-down models only"):
        _export(str(tmp_path / "bu8"), cfg_path, "--int8", cwd=str(tmp_path))
    e = _export(str(tmp_path / "bu0"), cfg_path, "--batch", "0",
                "TEST.MODEL_FILE", str(tmp_path / "start.pth"),
                cwd=str(tmp_path))
    assert e["meta"]["outputs"] == list(export_tool.BOTTOMUP_OUTPUTS)
    server = serve_tool.PoseServer(str(tmp_path / "bu0"), "cpu")
    assert server.output_names == sorted(export_tool.BOTTOMUP_OUTPUTS)
    cfg = load_config(cfg_path)
    size = cfg.MODEL.IMAGE_SIZE[0]
    x = np.random.RandomState(6).randn(7, size, size, 3).astype(np.float32)
    got = server.predict(x)
    from advmix_tpu_torch.data.bottomup import BottomUpCOCODataset

    infer = bottomup_infer_fn(model.eval(), cfg,
                              BottomUpCOCODataset.flip_pairs)
    heat, tags, peaks = infer(torch.from_numpy(x))
    want = {"heat": heat, "tags": tags, "peak_x": peaks["x"],
            "peak_y": peaks["y"], "peak_val": peaks["val"],
            "peak_tag": peaks["tag"]}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape[0] == 7, k
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("arm", serving_bench.ARMS)
def test_serving_bench_workloads(arm):
    cfg = load_config(SMOKE)
    step, batch = serving_bench.make_serving_workload(cfg, arm, 4, CPU,
                                                      torch.float32)
    preds, maxvals, _ = step(batch)
    assert preds.shape == (4, 8, 2) and torch.isfinite(preds).all()
    with pytest.raises(RuntimeError, match="CUDA device only"):
        serving_bench.time_serving(cfg, arm, 4, 1, CPU, torch.float32)
