"""Serving runtime of an exported program: the deployment end of
`tools/export.py`.

    python -m advmix_tpu_torch.tools.serve --export_dir <dir> \
        [--port 8389] [--host 127.0.0.1] [--device cpu]

Port of `tools/serve.py`. `PoseServer` loads `pose_infer.pt2`
(`torch.export.load`) with no model code: only the registrations of the
port's two custom ops (`ops/cuda/decode_kernel.py`, `ops/int8_conv.py`).
The weights travel inside the program. A threaded HTTP server answers the
JAX server's protocol, so its clients work unchanged:

  GET  /healthz   -> JSON {status, batch, image_hw, n_params, outputs}
  POST /predict   -> body: .npy float32 (B, H, W, 3) normalized images;
                     response: .npy float32 (B, J, 3) [x, y in heatmap
                     coordinates, score] for a top-down program, or an
                     .npz of the named arrays (heat, tags, peak_*) for a
                     bottom-up one, which `evaluation/grouping.py` groups

A fixed-batch program (export --batch N) pads a partial batch to its size
by repeating the last row and slices the result; a batch-polymorphic one
(--batch 0) runs at the request's size. The device calls run one at a
time on one thread of the server's own, whatever HTTP thread asked, and
allow only cuDNN's deterministic plans, whatever the process set: with
`cudnn.benchmark` on (the YAMLs' CUDNN.BENCHMARK, which `tools/export.py`
applies to its process), autotuning can pick a plan for a transposed
convolution that sums with atomics, and one request then gets two
answers. Autotuning stays as the process set it, and picks among the
deterministic plans. PyTorch keeps cuDNN's plans per thread, so the one
thread also keeps each batch size's plans from one call to the next.
`call` runs other work on that thread under the same flag, to compare
with the served results bit for bit. It runs on the card unless told
`--device cpu`, and refuses a program exported for another device instead
of falling back.
"""

from __future__ import annotations

import io
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.cuda import decode_kernel  # noqa: F401  (registers the op)
from ..ops import int8_conv  # noqa: F401  (registers the op)
from ..utils.device import resolve_device

PROGRAM = "pose_infer.pt2"
META = "meta.json"


class PoseServer:
    """A loaded export; thread-safe `predict`."""

    def __init__(self, export_dir: str, device: str | None = None):
        self.device = resolve_device(device)
        extra = {META: ""}
        program = torch.export.load(os.path.join(export_dir, PROGRAM),
                                    extra_files=extra)
        meta = json.loads(extra[META])
        if meta["device"] != self.device.type:
            raise ValueError(
                f"{export_dir}/{PROGRAM} was exported on {meta['device']}, "
                f"and this server runs on {self.device.type}: export again "
                "on the serving device")
        self.meta = meta
        self.module = program.module()
        self.n_params = int(sum(v.numel()
                                for v in program.state_dict.values()))
        self.image_hw = tuple(int(v) for v in meta["image_hw"])
        self.batch = int(meta["batch"])  # 0: polymorphic
        # one worker: the device calls are serialized on one thread
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pose-device")
        # warm-up: the first call loads the kernels
        out = self.predict(np.zeros((self.batch or 1, *self.image_hw, 3),
                                    np.float32))
        self.output_names = sorted(out) if isinstance(out, dict) else None

    def predict(self, images):
        h, w = self.image_hw
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != (h, w, 3):
            raise ValueError(f"expected (B, {h}, {w}, 3) float32, got "
                             f"{images.shape}")
        n = images.shape[0]
        x = np.asarray(images, np.float32)
        if self.batch:
            if n > self.batch:
                raise ValueError(
                    f"batch {n} exceeds the program's size {self.batch}; "
                    "export with --batch 0 for a polymorphic program")
            if n < self.batch:
                pad = np.repeat(x[-1:], self.batch - n, axis=0)
                x = np.concatenate([x, pad], axis=0)
        return self.call(self._run, x, n)

    def call(self, fn, *args):
        """fn(*args) on the server's device thread, where every predict
        runs, with only cuDNN's deterministic plans allowed."""
        return self._device_thread.submit(self._deterministic, fn,
                                          *args).result()

    @staticmethod
    def _deterministic(fn, *args):
        # the flag is the process's: set for this call, put back after
        # (`cudnn.flags()` would also reset the process's benchmark limit
        # and fp32 precision to their defaults for the call)
        cudnn = torch.backends.cudnn
        before, cudnn.deterministic = cudnn.deterministic, True
        try:
            return fn(*args)
        finally:
            cudnn.deterministic = before

    @torch.no_grad()
    def _run(self, x, n):
        out = self.module(torch.from_numpy(x).to(self.device))
        if isinstance(out, dict):
            return {k: v[:n].cpu().numpy() for k, v in out.items()}
        return out[:n].cpu().numpy()

    def close(self):
        """Stop the device thread."""
        self._device_thread.shutdown(wait=True)


def make_handler(server: PoseServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # no per-request stderr lines
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            info = {
                "status": "ok",
                "batch": server.batch or "polymorphic",
                "image_hw": list(server.image_hw),
                "n_params": server.n_params,
                "outputs": server.output_names or "preds",
            }
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                preds = server.predict(arr)
                buf = io.BytesIO()
                if isinstance(preds, dict):  # bottom-up: named arrays
                    np.savez(buf, **preds)
                else:
                    np.save(buf, preds, allow_pickle=False)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:  # the reason goes back to the client
                self._send(400, str(e).encode(), "text/plain")

    return Handler


def make_http_server(server: PoseServer, host: str = "127.0.0.1",
                     port: int = 8389):
    """A `ThreadingHTTPServer` answering for `server` (port 0 picks a free
    one: `.server_port`)."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer((host, port), make_handler(server))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--port", type=int, default=8389,
                    help="0 picks a free port (printed on stdout)")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the CUDA device (raises "
                         "without one); 'cpu' serves on the CPU")
    args = ap.parse_args(argv)
    server = PoseServer(args.export_dir, args.device)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving pose program on http://{args.host}:{httpd.server_port} "
          f"(batch {server.batch or 'polymorphic'}, image "
          f"{server.image_hw[1]}x{server.image_hw[0]}, "
          f"{server.n_params / 1e6:.1f}M params, {server.device})",
          flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
