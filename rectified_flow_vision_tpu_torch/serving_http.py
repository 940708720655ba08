"""HTTP serving front end for :class:`serving.SamplerService`.

Counterpart of the JAX package's ``serving_http.py``, on the standard
library only:

* ``POST /generate`` ``{"n": 4, "num_steps": 4, "format": "npy"|"png"}``
  -> npy bytes ([n, C, H, W] float32 in [-1, 1]) or a base64-PNG list;
* ``GET /healthz`` -> readiness and the configured step counts;
* ``GET /metrics`` -> request / image / batch counters and batch latency
  (text/plain, Prometheus-style, the same ``rfv_*`` names).

Concurrent requests are **micro-batched**: one batcher thread coalesces
every request waiting for the same ``num_steps`` (after a ``max_wait_ms``
window) into one ``SamplerService.generate`` call at the service's fixed
batch shape, then slices the images back per request; step counts are
served first come, first served, and a failed call raises in every waiter.
A conditional model's request carries its prompt's encoder outputs
(``Batcher.submit(..., cond=)``: one row by name for its ``n`` images), and
the call gets every request's rows, each repeated ``n`` times. The JSON
front end carries no encoder outputs: a model that needs them answers
``POST /generate`` with 400.

``Batcher.stats`` counts, always on, every key present from construction:
``requests``, ``images``, ``batches``, ``latency_sum_s``, ``latency_max_s``
(served calls and their seconds, as ``/metrics`` reports them);
``queued_requests`` and ``queue_wait_sum_s`` (from ``submit``'s enqueue to
the take of the request's group: the coalescing sleep and the wait behind a
running call); ``woken_requests`` and ``wake_sum_s`` (from a request's
``done.set()`` to its sender running again). After each served call the
service's own ``stats``, where it keeps them (``SamplerService``: its calls'
host, device-wait and copy seconds and padded rows), are copied in, so one
copy of ``Batcher.stats`` holds both layers' counters. Each sum moves with
its count in one update under the batcher's lock, so a copy of the dict
sees both or neither; ``snapshot()`` takes one under the lock. The span
``rfv.batcher.call`` (``utils.profiling.annotate``) covers one group's call,
its slicing and its wake-ups.

Threads: the HTTP handlers run one thread per connection and only queue
requests; the batcher thread is the only caller of the service after
``make_server``. It owns the service's seeded noise generator (which
``generate`` advances) and issues every launch on its own current CUDA
stream (the default stream: torch's current stream is per thread). Do not
call the service from another thread while the batcher runs.

Run (on the card unless ``--device cpu``):
    python -m rectified_flow_vision_tpu_torch.serving_http \
        --checkpoint checkpoints/rectified_flow_k1_final.npz --port 8000
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from collections import defaultdict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger
from rectified_flow_vision_tpu_torch.utils.profiling import annotate

log = get_logger("flow_vision.serving.http")


class _Request:
    __slots__ = ("n", "num_steps", "cond", "done", "result", "error", "queued_at", "done_at")

    def __init__(self, n: int, num_steps: int, cond=None):
        self.n = n
        self.num_steps = num_steps
        self.cond = cond
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.queued_at = 0.0  # perf_counter at the enqueue, and at done.set()
        self.done_at = 0.0

    def finish(self) -> None:
        self.done_at = time.perf_counter()
        self.done.set()


_COUNTERS = {
    "requests": 0, "images": 0, "batches": 0, "latency_sum_s": 0.0, "latency_max_s": 0.0,
    "queued_requests": 0, "queue_wait_sum_s": 0.0, "woken_requests": 0, "wake_sum_s": 0.0,
}


class Batcher:
    """Coalesces concurrent generate() requests into fixed-batch calls.

    One background thread drains the queue; all requests pending for the
    same ``num_steps`` are served by a single ``SamplerService.generate``
    call (ceil to the service batch) and sliced back per request.
    ``max_wait_ms`` bounds the extra latency a lone request pays waiting
    for riders.
    """

    def __init__(self, service, *, max_wait_ms: float = 5.0):
        self.service = service
        self.max_wait_ms = max_wait_ms
        self._queues: Dict[int, Deque[_Request]] = defaultdict(deque)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._service_stats = getattr(service, "stats", {})
        self.stats = {**_COUNTERS, **self._service_stats}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, n: int, num_steps: int, timeout: float = 300.0, *, cond=None):
        """``n`` images at ``num_steps``; a conditional model's request
        carries ``cond``, one prompt's rows by name (the model's
        ``cond_shapes``), used for all ``n`` images."""
        if num_steps not in self.service.step_counts:
            raise ValueError(
                f"num_steps={num_steps} not precompiled; configured: "
                f"{tuple(self.service.step_counts)}"
            )
        if n < 1:
            raise ValueError("n must be >= 1")
        from rectified_flow_vision_tpu_torch.serving import check_cond

        check_cond(self.service.cond_shapes, 1,
                   None if cond is None else {k: c[None] for k, c in cond.items()})
        req = _Request(n, num_steps, cond)
        with self._lock:
            req.queued_at = time.perf_counter()
            self._queues[num_steps].append(req)
        self._wake.set()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        self._count(woken_requests=1, wake_sum_s=time.perf_counter() - req.done_at)
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def snapshot(self) -> Dict[str, float]:
        """A copy of ``stats`` taken under the lock."""
        with self._lock:
            return dict(self.stats)

    def _count(self, **deltas) -> None:
        """Add ``deltas`` to the counters in one dict update, under the lock."""
        with self._lock:
            self._add(deltas)

    def _add(self, deltas) -> None:
        s = self.stats
        s.update({k: s[k] + v for k, v in deltas.items()})

    # ---- batcher loop ------------------------------------------------------

    def _take_group(self) -> List[_Request]:
        """Pop every queued request for one num_steps (FIFO across steps)."""
        with self._lock:
            for steps, q in self._queues.items():
                if q:
                    group = list(q)
                    q.clear()
                    now = time.perf_counter()
                    self._add({"queued_requests": len(group),
                               "queue_wait_sum_s": sum(now - r.queued_at for r in group)})
                    return group
        return []

    def _run(self):
        while not self._stop:
            self._wake.wait()
            self._wake.clear()
            # brief coalescing window so near-simultaneous requests share
            # a batch instead of each paying a full sampler dispatch
            time.sleep(self.max_wait_ms / 1e3)
            while True:
                group = self._take_group()
                if not group:
                    break
                with annotate("rfv.batcher.call"):
                    self._serve(group)

    def _serve(self, group: List[_Request]):
        t0 = time.perf_counter()
        total = sum(r.n for r in group)
        steps = group[0].num_steps
        try:
            images = self.service.generate(total, num_steps=steps, cond=_rows(group))
        except Exception as e:  # surface to every waiter
            for r in group:
                r.error = e
                r.finish()
            return
        dt = time.perf_counter() - t0
        off = 0
        for r in group:
            r.result = images[off:off + r.n]
            off += r.n
            r.finish()
        with self._lock:
            self._add({"requests": len(group), "images": total, "batches": 1,
                       "latency_sum_s": dt})
            self.stats.update(self._service_stats,
                              latency_max_s=max(self.stats["latency_max_s"], dt))


def _rows(group: List[_Request]) -> Optional[Dict[str, "torch.Tensor"]]:
    """The group's conditioning, one row an image: each request's prompt
    repeated for its ``n`` images, requests in order; None without prompts."""
    import torch

    if group[0].cond is None:
        return None

    def rows(r: _Request, k: str) -> "torch.Tensor":
        c = torch.as_tensor(r.cond[k])
        return c.expand(r.n, *c.shape)

    if len(group) == 1:  # a view: the service copies only the rows it stages
        return {k: rows(group[0], k) for k in group[0].cond}
    return {k: torch.cat([rows(r, k) for r in group]) for k in group[0].cond}


def _encode_png_list(images: np.ndarray) -> List[str]:
    """[n, C, H, W] in [-1, 1] → base64 PNG strings."""
    from PIL import Image

    out = []
    arr = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    for img in arr:
        buf = io.BytesIO()
        Image.fromarray(np.transpose(img, (1, 2, 0))).save(buf, format="PNG")
        out.append(base64.b64encode(buf.getvalue()).decode("ascii"))
    return out


def make_server(
    service, host: str = "127.0.0.1", port: int = 8000,
    *, max_wait_ms: float = 5.0,
) -> Tuple[ThreadingHTTPServer, Batcher]:
    """Build (but don't start) the HTTP server around a SamplerService."""
    batcher = Batcher(service, max_wait_ms=max_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger
            log.debug("http: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                m = service.model
                self._json(200, {
                    "status": "ok",
                    "step_counts": list(service.step_counts),
                    "batch_size": service.batch_size,
                    "image_size": m.image_size,
                    "latent": service._decode is not None,
                })
            elif self.path == "/metrics":
                s = batcher.snapshot()
                lines = [
                    f"rfv_requests_total {s['requests']}",
                    f"rfv_images_total {s['images']}",
                    f"rfv_batches_total {s['batches']}",
                    f"rfv_batch_latency_seconds_sum {s['latency_sum_s']:.6f}",
                    f"rfv_batch_latency_seconds_max {s['latency_max_s']:.6f}",
                ]
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                n = int(payload.get("n", 1))
                steps = int(
                    payload.get("num_steps", service.step_counts[0])
                )
                fmt = payload.get("format", "npy")
                images = batcher.submit(n, steps)
            except (ValueError, TimeoutError) as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # pragma: no cover - defensive
                log.exception("generate failed")
                self._json(500, {"error": str(e)})
                return
            if fmt == "png":
                self._json(200, {"images_png_b64": _encode_png_list(images)})
            else:
                buf = io.BytesIO()
                np.save(buf, images)
                self._send(200, buf.getvalue(), "application/octet-stream")

    server = ThreadingHTTPServer((host, port), Handler)
    return server, batcher


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from rectified_flow_vision_tpu_torch.serving import SamplerService

    parser = argparse.ArgumentParser(description="Flow sampler HTTP service (PyTorch / CUDA)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--vae", default=None, metavar="VAE_NPZ")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--steps", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--method", default="euler",
                        choices=["euler", "midpoint", "heun"])
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    svc = SamplerService.from_checkpoint(
        args.checkpoint, vae_path=args.vae, device=args.device,
        step_counts=tuple(args.steps), batch_size=args.batch_size,
        method=args.method,
    )
    server, batcher = make_server(
        svc, args.host, args.port, max_wait_ms=args.max_wait_ms
    )
    log.info("serving on http://%s:%d (steps=%s, batch=%d, device %s)",
             args.host, server.server_address[1], args.steps, args.batch_size, svc.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
