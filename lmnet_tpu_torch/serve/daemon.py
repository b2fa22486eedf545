"""Online serving daemon: load a deploy artifact (``serve/export.py``) and
serve segmentation requests over HTTP with dynamic batching.

Counterpart of ``lmnet_tpu/serve/daemon.py``, with its semantics. It is
the process a clinic or an imaging pipeline talks to when it sends one to
four images at a time and wants masks back: a long-lived process that owns
the deploy graph and turns many small concurrent requests into a few large
device batches.

Design:
  * one worker thread owns the device: requests queue up, the worker
    drains up to ``max_batch`` images (waiting at most ``max_wait_ms``
    after the first), concatenates, and runs ONE device call under
    ``torch.inference_mode()`` (entered in the worker thread: the mode is
    thread-local);
  * batches are zero-padded up to a power-of-two bucket, as in JAX, so the
    device sees at most log2(max_batch) + 1 batch shapes;
  * the argmax runs on the device; only the (n, H, W) int32 masks come
    back to the host.

Transport is stdlib ``http.server`` (ThreadingHTTPServer): POST a
``.npy``-serialized float32 (N, H, W, 3) body to ``/predict`` and get a
``.npy`` int32 (N, H, W) mask back; ``GET /healthz`` reports the stats.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


@dataclass
class _Request:
    x: np.ndarray  # (n, H, W, 3) float32
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Queue + one worker thread that batches requests into device calls.

    ``fn`` maps a (B, H, W, 3) tensor of ``dtype`` on ``device`` to
    (B, H, W, C) logits: a loaded export artifact or a ``deploy_forward``
    closure. The batcher owns the argmax and the padding; callers get back
    int32 (n, H, W) masks.
    """

    def __init__(
        self,
        fn,
        img_size: int,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
    ):
        self.fn = fn
        self.img_size = int(img_size)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.dtype = dtype
        self.device = torch.device(device)
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self.stats = {"requests": 0, "images": 0, "batches": 0, "padded": 0}
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ------------------------------------------------------
    def submit(self, x: np.ndarray) -> Future:
        """Enqueue (n, H, W, 3) or (H, W, 3) float images; the future gives
        the (n, H, W) int32 masks."""
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4 or x.shape[1:] != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (n,{self.img_size},{self.img_size},3), got {x.shape}")
        if not 1 <= x.shape[0] <= self.max_batch:
            raise ValueError(f"a request of {x.shape[0]} images; take 1 to {self.max_batch}")
        req = _Request(x)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["images"] += x.shape[0]
        self._queue.put(req)
        return req.future

    def predict(self, x: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        return self.submit(x).result(timeout=timeout)

    def stop(self):
        self._queue.put(None)
        self._worker.join(timeout=30)

    # -- worker side ------------------------------------------------------
    def _drain(self) -> list[_Request] | None:
        """Block for the first request, then collect more until the batch is
        full or ``max_wait_s`` has passed. None = shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        batch, n = [first], first.x.shape[0]
        deadline = time.monotonic() + self.max_wait_s
        while n < self.max_batch:
            rest = deadline - time.monotonic()
            if rest <= 0:
                break
            try:
                nxt = self._queue.get(timeout=rest)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post shutdown for the outer loop
                break
            if n + nxt.x.shape[0] > self.max_batch:
                self._queue.put(nxt)  # does not fit; left for the next batch
                break
            batch.append(nxt)
            n += nxt.x.shape[0]
        return batch

    def _predict(self, x: np.ndarray) -> np.ndarray:
        """int32 argmax masks of ``fn`` on the padded host batch ``x``."""
        xd = torch.from_numpy(x).to(self.device, self.dtype)
        return self.fn(xd).argmax(dim=-1).to(torch.int32).cpu().numpy()

    def _run(self):
        with torch.inference_mode():
            while True:
                batch = self._drain()
                if batch is None:
                    return
                try:
                    x = np.concatenate([r.x for r in batch], axis=0)
                    n = x.shape[0]
                    b = _bucket(n, self.max_batch)
                    if b > n:
                        x = np.concatenate([x, np.zeros((b - n, *x.shape[1:]), x.dtype)])
                    masks = self._predict(x)[:n]
                    with self._lock:
                        self.stats["batches"] += 1
                        self.stats["padded"] += b - n
                    off = 0
                    for r in batch:
                        k = r.x.shape[0]
                        r.future.set_result(masks[off:off + k])
                        off += k
                except Exception as e:  # a device error reaches every caller
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)


# -- HTTP layer -----------------------------------------------------------

def make_server(batcher: DynamicBatcher, host: str = "127.0.0.1", port: int = 0):
    """ThreadingHTTPServer wrapping ``batcher``; the caller runs
    ``serve_forever()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; the stats live in /healthz
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                with batcher._lock:
                    body = json.dumps({"ok": True, **batcher.stats}).encode()
                self._reply(200, body, "application/json")
            else:
                self._reply(404, b"{}", "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, b"{}", "application/json")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                arr = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
                mask = batcher.predict(arr)
                out = io.BytesIO()
                np.save(out, mask)
                self._reply(200, out.getvalue(), "application/x-npy")
            except Exception as e:  # a bad request answers 400; the daemon stays up
                body = json.dumps({"ok": False, "error": str(e)}).encode()
                self._reply(400, body, "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description="LM-Net artifact serving daemon (PyTorch/CUDA port)")
    p.add_argument("--artifact", required=True,
                   help="torch.export artifact from `lmnet_tpu_torch.cli.train --export`")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default the card; 'cpu' to serve on "
                        "the CPU)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; pass --device cpu "
                         "to serve on the CPU")

    from lmnet_tpu_torch.serve.export import input_dtype, load_deploy_file

    fn = load_deploy_file(args.artifact, device=args.device)
    batcher = DynamicBatcher(fn, img_size=args.img_size, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms, dtype=input_dtype(fn),
                             device=args.device)
    # warm the one-image bucket so that the first caller does not pay for it
    batcher.predict(np.zeros((1, args.img_size, args.img_size, 3), np.float32), timeout=1800.0)
    srv = make_server(batcher, args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(device={args.device}, max_batch={args.max_batch})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        batcher.stop()


if __name__ == "__main__":
    main()
