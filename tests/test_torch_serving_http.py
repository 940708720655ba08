"""The port's HTTP front end (``serving_http``) on the CPU.

Mirrors ``tests/test_serving_http.py``'s eight cases (the API contract,
micro-batching, metrics) on a tiny CPU service, and holds the contract
against the JAX package's server: the same ``/healthz`` keys and values and
the same ``/metrics`` counter names for the same model configuration. Then:
an error of the sampler reaches every waiter of its batch, step counts are
served first come first served, and ``main`` builds a service on the device
it is given and serves until interrupted.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu_torch import serving_http as H
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.serving import SamplerService

TINY = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
            sample_dtype="float32", seed=0)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_service(step_counts=(1,), batch_size=4):
    model = BaseFlowModel(device="cpu", **TINY)
    return SamplerService(model, step_counts=step_counts, batch_size=batch_size, warmup=True)


def _serve(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    httpd, batcher = H.make_server(_tiny_service(step_counts=(1, 2)), "127.0.0.1", 0,
                                   max_wait_ms=2.0)
    yield _serve(httpd)
    httpd.shutdown()
    batcher.shutdown()
    httpd.server_close()


def _post(base, payload, timeout=120):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    return urllib.request.urlopen(req, timeout=timeout)


class TestHTTPAPI:
    def test_healthz(self, server):
        with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok"
        assert body["step_counts"] == [1, 2]
        assert body["image_size"] == 8

    def test_generate_npy(self, server):
        with _post(server, {"n": 3, "num_steps": 1}) as r:
            assert r.headers["Content-Type"] == "application/octet-stream"
            arr = np.load(io.BytesIO(r.read()))
        assert arr.shape == (3, 3, 8, 8)
        assert np.isfinite(arr).all() and arr.min() >= -1.0 and arr.max() <= 1.0

    def test_generate_png(self, server):
        from PIL import Image

        with _post(server, {"n": 2, "num_steps": 1, "format": "png"}) as r:
            body = json.loads(r.read())
        assert len(body["images_png_b64"]) == 2
        img = Image.open(io.BytesIO(base64.b64decode(body["images_png_b64"][0])))
        assert img.size == (8, 8) and img.mode == "RGB"

    def test_bad_steps_is_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, {"n": 1, "num_steps": 7})
        assert ei.value.code == 400

    def test_unknown_path_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server + "/nope", timeout=30)
        assert ei.value.code == 404

    def test_metrics_endpoint(self, server):
        _post(server, {"n": 1, "num_steps": 1}).read()
        with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "rfv_requests_total" in text
        assert "rfv_images_total" in text


class TestBatcher:
    def test_concurrent_requests_coalesce(self):
        """Simultaneous requests for the same num_steps share sampler calls:
        fewer batches than requests, every caller gets its own slice."""
        batcher = H.Batcher(_tiny_service(step_counts=(1,), batch_size=8), max_wait_ms=30.0)
        results, errs = {}, []

        def worker(i):
            try:
                results[i] = batcher.submit(2, 1)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        batcher.shutdown()
        assert not errs
        assert len(results) == 4
        for arr in results.values():
            assert arr.shape == (2, 3, 8, 8)
        flat = [arr.tobytes() for arr in results.values()]
        assert len(set(flat)) == len(flat)  # the noise stream advances per image
        assert batcher.stats["requests"] == 4
        assert batcher.stats["images"] == 8
        assert batcher.stats["batches"] <= 3  # coalesced (not 4)

    def test_unconfigured_steps_raise(self):
        batcher = H.Batcher(_tiny_service(step_counts=(1,)))
        with pytest.raises(ValueError):
            batcher.submit(1, 99)
        with pytest.raises(ValueError):
            batcher.submit(0, 1)
        batcher.shutdown()

    def test_sampler_error_reaches_every_waiter(self):
        class Failing:
            step_counts = (1,)
            cond_shapes = None

            def generate(self, n, num_steps, cond=None):
                raise RuntimeError("sampler down")

        batcher = H.Batcher(Failing(), max_wait_ms=30.0)
        errs = []

        def worker():
            try:
                batcher.submit(1, 1, timeout=60)
            except RuntimeError as e:
                errs.append(str(e))

        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        batcher.shutdown()
        assert errs == ["sampler down"] * 3
        assert batcher.stats["batches"] == 0

    def test_step_counts_are_served_first_come_first_served(self):
        """Requests queued for 2 steps before others for 1 step are served
        first; each step count is one sampler call."""
        calls = []

        class Recording:
            step_counts = (1, 2)
            cond_shapes = None

            def generate(self, n, num_steps, cond=None):
                calls.append((n, num_steps))
                return np.zeros((n, 3, 8, 8), np.float32)

        batcher = H.Batcher(Recording(), max_wait_ms=1000.0)
        threads = [threading.Thread(target=batcher.submit, args=(1, s))
                   for s in (2, 2, 1, 1, 1)]
        for i, t in enumerate(threads):
            t.start()
            while sum(map(len, batcher._queues.values())) <= i:  # queued in this order
                time.sleep(0.001)
        for t in threads:
            t.join(timeout=60)
        batcher.shutdown()
        assert calls == [(2, 2), (3, 1)]


def test_healthz_and_metrics_are_the_jax_servers(server):
    """The same configuration served by both packages answers /healthz with
    the same body and /metrics with the same counter names."""
    from rectified_flow_vision_tpu import serving as JS
    from rectified_flow_vision_tpu import serving_http as JH
    from rectified_flow_vision_tpu.models import BaseFlowModel as JBase

    jsvc = JS.SamplerService(JBase(**TINY), step_counts=(1, 2), batch_size=4, warmup=False)
    jhttpd, jbatcher = JH.make_server(jsvc, "127.0.0.1", 0)
    jbase = _serve(jhttpd)
    try:
        bodies = []
        for base in (server, jbase):
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                names = [line.split()[0] for line in r.read().decode().splitlines()]
            bodies.append((health, names))
    finally:
        jhttpd.shutdown()
        jbatcher.shutdown()
        jhttpd.server_close()
    assert bodies[0] == bodies[1]


def test_main_serves_a_checkpoint_on_the_device_it_is_given(tmp_path, monkeypatch):
    """``main(argv)`` loads the checkpoint onto ``--device``, builds the
    server on the given host and port and serves until interrupted, then
    shuts the batcher down."""
    ckpt = tmp_path / "flow.npz"
    BaseFlowModel(device="cpu", **TINY).save(str(ckpt))
    seen = {}

    def serve_forever(self):
        seen["address"] = self.server_address
        raise KeyboardInterrupt

    shutdowns, orig_shutdown = [], H.Batcher.shutdown

    def shutdown(self):
        shutdowns.append(self.service.device)
        orig_shutdown(self)

    monkeypatch.setattr(H.ThreadingHTTPServer, "serve_forever", serve_forever)
    monkeypatch.setattr(H.Batcher, "shutdown", shutdown)
    H.main(["--checkpoint", str(ckpt), "--device", "cpu", "--port", "0", "--steps", "1",
            "--batch-size", "2"])
    assert seen["address"][0] == "127.0.0.1"
    assert [d.type for d in shutdowns] == ["cpu"]
