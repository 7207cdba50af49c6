"""Inference server: FLAME parameters in, generated faces out.

Port of :mod:`gif_tpu.serve`.  One process owns the generator and serves
HTTP requests with transparent micro-batching: requests are queued, packed
into the sampler's fixed batch (partial batches are padded), run on the
GPU by a single batcher thread, and answered as PNG bytes.

API (JSON in, image/png out):

  POST /generate   {"flame": [236 floats] | null, "identity": int,
                    "seed": int}        -> PNG
  GET  /healthz                          -> {"status": "ok", ...}

Run:

  python -m gif_tpu_torch.serve --run_id 8 --converted_params g.pt --port 8000

``--device cpu`` runs the plain PyTorch path; the default is the GPU, and
without one the server refuses to start.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Pending:
    __slots__ = ("flame", "identity", "event", "result", "error")

    def __init__(self, flame, identity):
        self.flame = flame
        self.identity = identity
        self.event = threading.Event()
        self.result = None
        self.error = None


class GifServer:
    """Owns the sampler and the micro-batching loop."""

    def __init__(self, cfg, res, g_state, batch_size=8, max_wait_ms=50.0, device=None):
        from gif_tpu_torch.eval.sampling import FlameSampler

        self.cfg = cfg
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.sampler = FlameSampler(cfg, res, g_state, batch_size=batch_size, device=device)
        self.queue: queue.Queue = queue.Queue()
        self.requests_served = 0
        # Host-clock seconds and sizes of the last device batches (a
        # batch's render + generator + readback), bounded for long runs.
        self.batch_seconds: collections.deque = collections.deque(maxlen=4096)
        self.batch_sizes: collections.deque = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._batcher, daemon=True)
        self._thread.start()

    # -- request side -----------------------------------------------------
    def generate(self, flame: np.ndarray | None, identity: int, seed: int = 0):
        """Blocking: returns a (S, S, 3) uint8 image."""
        if flame is None:
            from gif_tpu_torch.eval.sampling import random_flame_params

            flame = random_flame_params(np.random.default_rng(seed), 1)[0]
        flame = np.asarray(flame, np.float32).reshape(-1)
        if flame.shape[0] != 236:
            raise ValueError(f"flame must have 236 dims, got {flame.shape[0]}")
        vocab = self.cfg.embedding_vocab_size
        if not 0 <= int(identity) < vocab:
            raise ValueError(f"identity must be in [0, {vocab}), got {identity}")
        if self._stop.is_set():
            raise RuntimeError("server is shutting down")
        p = _Pending(flame, int(identity))
        self.queue.put(p)
        # Re-check after the enqueue: stop() may have drained the queue
        # between the check above and the put.
        if self._stop.is_set() and not p.event.is_set():
            p.error = RuntimeError("server is shutting down")
            p.event.set()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    # -- device side ------------------------------------------------------
    def _batcher(self):
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=left))
                except queue.Empty:
                    break
            n = len(batch)
            flame = np.stack([p.flame for p in batch])
            idx = np.asarray([p.identity for p in batch], np.int64)
            try:
                t0 = time.perf_counter()
                images, _ = self.sampler.sample(flame, idx)
                self.batch_seconds.append(time.perf_counter() - t0)
                self.batch_sizes.append(n)
                imgs_u8 = ((np.clip(images[:n], -1, 1) + 1) * 127.5).astype(np.uint8)
                for p, img in zip(batch, imgs_u8):
                    p.result = img
                    p.event.set()
                self.requests_served += n
            except Exception as e:  # surface device errors to all waiters
                for p in batch:
                    p.error = e
                    p.event.set()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        # Fail anything still queued so no caller blocks forever.
        while True:
            try:
                p = self.queue.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("server is shutting down")
            p.event.set()


def make_handler(server: GifServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(
                {
                    "status": "ok",
                    "batch_size": server.batch_size,
                    "requests_served": server.requests_served,
                }
            ).encode()
            self._send(200, "application/json", body)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                img = server.generate(
                    req.get("flame"), req.get("identity", 0), req.get("seed", 0)
                )
                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="PNG")
                self._send(200, "image/png", buf.getvalue())
            except Exception as e:  # noqa: BLE001
                # Caller errors are 400; device/internal failures are 500.
                msg = json.dumps({"error": str(e)}).encode()
                self._send(400 if isinstance(e, ValueError) else 500, "application/json", msg)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_id", type=int, default=8)
    p.add_argument("--converted_params", type=str, default=None,
                   help="generator state_dict from gif_tpu_torch.tools.convert_params "
                        "(default: seeded random init)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flame_resources", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=50.0)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--vocab", type=int, default=69158)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.eval.sampling import load_generator_params
    from gif_tpu_torch.flame.resources import load_flame_resources
    from gif_tpu_torch.train.config import get_config

    device = resolve_device(args.device)  # refuse before loading anything
    cfg = get_config(args.run_id, embedding_vocab_size=args.vocab)
    res = load_flame_resources(args.flame_resources)
    g_state = load_generator_params(cfg, converted_params=args.converted_params, seed=args.seed)
    server = GifServer(cfg, res, g_state, args.batch_size, args.max_wait_ms, device=device)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(server))
    print(f"serving on :{args.port} (batch {args.batch_size}, {server.sampler.device})")
    try:
        httpd.serve_forever()
    finally:
        server.stop()


if __name__ == "__main__":
    main()
