"""Open-loop serving through the program's in-process batcher.

Set-up builds the configuration's flow model (and ConvVAE on the latent
path) with the benchmark's weights, a ``SamplerService`` at the traffic's
batch, seeded from the run's seed, and the ``serving_http.Batcher`` that the
HTTP front end uses, and sends one request through it. The window is a
schedule of requests due at fixed times, sent whether or not earlier ones
have returned, as independent users send them: ``rate_per_s`` requests a
second with exponential gaps, each of ``n`` images, log-uniform over the
integers of ``sizes.log_uniform``. Every seed gets the same set of gaps and
the same set of sizes (quantiles of the two laws), each in its own order, so
the work of a window does not depend on the seed. A pool of ``senders``
threads sends each request at its time and waits in ``Batcher.submit``;
latency runs from the time a request was due, so a late sender counts
against the system. Every call the batcher makes into the service is
recorded by the harness (wall-clock start, the launch counters moved, the
batcher's counters) and its output kept.

Correctness: each returned request is found in the output of one service
call made while it waited, no two requests share an image, and a sample of
requests drawn from the seed, the largest among them, is computed again by
the reference in float32 from the same noise, replayed from the service's
seed (``reference.flow``). The number compared is the worst image's relative
error, ||served - reference|| / ||reference||.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rfbench import core, seeds, tracing, weights
from rfbench.reference import flow
from rfbench.reference.numerics import Numerics, exact_fp32

SUBMIT_TIMEOUT_S = 120.0


def schedule(traffic: dict, seconds: float, seed: int, purpose: str = "window") -> tuple:
    """(due times from 0, request sizes) of ``rate_per_s * seconds`` requests:
    the quantiles of an exponential gap of mean 1 / rate and of the
    log-uniform size, the same for every seed, each shuffled by it."""
    count = max(1, round(traffic["rate_per_s"] * seconds))
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / traffic["rate_per_s"]
    lo, hi = traffic["sizes"]["log_uniform"]
    sizes = np.floor(np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))).astype(np.int64)
    rng = np.random.default_rng(seeds.derive(seed, purpose))
    rng.shuffle(gaps)
    rng.shuffle(sizes)
    return np.cumsum(gaps), sizes


class _Recorder:
    """Stands in front of ``SamplerService.generate`` and records each call;
    profiles calls when asked, on the batcher's own thread, where the
    program's host operations and launches are."""

    def __init__(self, service, device: torch.device) -> None:
        self.calls: List[dict] = []
        self.batcher = None
        self.device = device
        self._generate = service.generate
        self._plan: Optional[dict] = None
        service.generate = self.generate

    def profile(self, calls: int, host: bool, timeout: float) -> Optional[tracing.Summary]:
        """Profile the next ``calls`` whole calls (and the one after, whose
        start closes the window); ``None`` if they do not come in time."""
        plan = {"calls": calls, "host": host, "done": threading.Event(), "prof": None}
        self._plan = plan
        if not plan["done"].wait(timeout):
            self._plan = None
            return None
        return plan["prof"].summary([c["w0"] for c in self.calls])

    def generate(self, n, num_steps=None, **kw):
        plan = self._plan
        if plan is not None and plan["prof"] is None:
            plan["prof"] = tracing.Profiler(self.device, plan["host"]).__enter__()
            plan["first"] = len(self.calls)
        rec = {"images": int(n), "steps": num_steps, "launches_before": core.launch_counts(),
               "batcher": dict(self.batcher.stats) if self.batcher is not None else {}}
        rec["w0"], rec["t0"] = time.time_ns(), time.perf_counter()
        out = self._generate(n, num_steps=num_steps, **kw)
        rec["t1"] = time.perf_counter()  # the output is on the host: the call is over
        rec["launches"] = core.launch_delta(rec.pop("launches_before"), core.launch_counts())
        rec["out"] = out
        self.calls.append(rec)
        if plan is not None and len(self.calls) >= plan["first"] + plan["calls"] + 1:
            plan["prof"].__exit__(None, None, None)
            self._plan = None
            plan["done"].set()
        return out


class Run:
    def __init__(self, cell: core.Cell, seed: int, device: torch.device) -> None:
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.service_seed = seeds.derive(seed, "service")
        self.requests: List[dict] = []

    # ---- program -----------------------------------------------------------

    def setup(self) -> None:
        from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE
        from rectified_flow_vision_tpu_torch.serving import SamplerService
        from rectified_flow_vision_tpu_torch.serving_http import Batcher

        mark = core.phase_marker(self)
        mark("import_program")
        w = weights.make(self.cfg, self.seed, self.device)
        mark("weights")
        model = BaseFlowModel(**self.cfg["model"], device=self.device)
        model.velocity_net.load_state_dict(w["velocity_net"], strict=True)
        vae = None
        if self.cfg.get("vae"):
            vae = ConvVAE(**self.cfg["vae"], device=self.device)
            vae.load_state_dict(w["vae"], strict=True)
        del w
        mark("models")
        self.service = SamplerService(
            model, step_counts=(self.tr["num_steps"],), batch_size=self.tr["service_batch"],
            seed=self.service_seed, vae=vae)
        mark("service_warmup")
        self.recorder = _Recorder(self.service, self.device)
        self.batcher = Batcher(self.service, max_wait_ms=self.tr["max_wait_ms"])
        self.recorder.batcher = self.batcher
        self.batcher.submit(1, self.tr["num_steps"])
        _sync(self.device)
        mark("first_request")

    def window(self, seconds: float, traced: bool) -> dict:
        """The measured window; with ``traced`` the schedule goes on after it
        while ``trace_calls`` whole batcher calls are profiled, the device
        alone, then one call with the host."""
        due, sizes = schedule(self.tr, seconds, self.seed)
        count = len(due)
        if traced:
            tracing.init()
            more_due, more_sizes = schedule(self.tr, 2 * seconds, self.seed, "trace")
            due = np.concatenate([due, due[-1] + more_due])
            sizes = np.concatenate([sizes, more_sizes])
        steps, lock, stop = self.tr["num_steps"], threading.Lock(), threading.Event()
        state = {"next": 0}
        records: List[Optional[dict]] = [None] * len(due)
        start = time.perf_counter() + 0.05

        def sender() -> None:
            while True:
                with lock:
                    i = state["next"]
                    state["next"] += 1
                # sleep to the request's time, or until the traced slice ends
                if i >= len(due) or stop.wait(max(0.0, start + due[i] - time.perf_counter())):
                    return
                rec = {"n": int(sizes[i]), "due": start + due[i], "t0": time.perf_counter(),
                       "result": None, "error": None}
                try:
                    rec["result"] = self.batcher.submit(rec["n"], steps, timeout=SUBMIT_TIMEOUT_S)
                except Exception as e:  # a failed request counts as failed, the run goes on
                    rec["error"] = repr(e)
                rec["t1"] = time.perf_counter()
                records[i] = rec

        threads = [threading.Thread(target=sender, daemon=True) for _ in range(self.tr["senders"])]
        for t in threads:
            t.start()
        summary = None
        if traced:
            time.sleep(max(0.0, start + due[count - 1] - time.perf_counter()))
            summary = self.recorder.profile(self.tr["trace_calls"], False, 2 * seconds)
            host = self.recorder.profile(1, True, seconds)
            if summary is not None and host is not None:
                summary.idle_gaps = host.idle_gaps
            stop.set()
        for t in threads:
            t.join(3 * seconds + SUBMIT_TIMEOUT_S + 60)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a sender thread did not end")
        self.requests = [r for r in records if r is not None]
        due_in_window = records[:count]
        ok = [r for r in due_in_window if r is not None and r["error"] is None]
        last = max((r["t1"] for r in ok), default=start + seconds)
        lat = np.array([r["t1"] - r["due"] for r in ok]) * 1e3
        window = [c for c in self.recorder.calls if start <= c["t0"] and c["t1"] <= last]
        b = self.tr["service_batch"]
        out = {
            "info": {"requests": count, "calls": len(window),
                     "sender_late_max_ms": 1e3 * max((r["t0"] - r["due"] for r in ok), default=0.0),
                     "images_per_call": float(np.mean([c["images"] for c in window] or [0])),
                     "batches_per_call": float(np.mean([-(-c["images"] // b) for c in window] or [0])),
                     # below the knee this is the offered rate read back: no metric
                     "returned_img_per_s": sum(r["n"] for r in ok) / (last - start)},
            "attempted": len(self.requests),
            "failed": len(self.requests) - len([r for r in self.requests if r["error"] is None])
                      + sum(r is None for r in due_in_window),
            "end_to_end": {
                # every request due in the window, from its due time to its return
                "serve_p95_ms": float(np.percentile(lat, 95)) if len(lat) else math.inf,
            },
        }
        if traced:
            def rec(c: dict) -> dict:
                return {"images": c["images"], "launches": c["launches"],
                        "batcher": c["batcher"], "seconds": c["t1"] - c["t0"]}

            out["observed"] = core.Observed(
                self.cfg, self.tr, summary, [rec(c) for c in self.recorder.calls], 0,
                rate=out["info"]["returned_img_per_s"], timed=[rec(c) for c in window])
        return out

    def free(self) -> None:
        """Stop the batcher and drop the program's state (outputs stay)."""
        self.batcher.shutdown()
        self.recorder._generate = self.recorder.batcher = None
        del self.batcher, self.service
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness ---------------------------------------------------------

    def _locate(self) -> tuple:
        """(placed, lost): each returned request's (call, offset), and the
        number of requests that no call's output holds, or that share images."""
        calls = self.recorder.calls
        probes: Dict[int, Dict[bytes, int]] = {}

        def index(c: int) -> Dict[bytes, int]:
            if c not in probes:
                rows = calls[c]["out"].reshape(calls[c]["images"], -1)
                pick = np.linspace(0, rows.shape[1] - 1, 64).astype(np.int64)
                probes[c] = {r.tobytes(): i for i, r in enumerate(rows[:, pick])}
            return probes[c]

        placed, lost, used = [], 0, set()
        starts = np.array([c["t0"] for c in calls])
        for r in self.requests:
            if r["error"] is not None:
                continue
            res = r["result"]
            hit = None
            flat = res.reshape(r["n"], -1)
            pick = np.linspace(0, flat.shape[1] - 1, 64).astype(np.int64)
            key = flat[0, pick].tobytes()
            for c in np.nonzero((starts >= r["t0"]) & (starts <= r["t1"]))[0]:
                off = index(int(c)).get(key)
                out = calls[c]["out"]
                if off is not None and off + r["n"] <= len(out) and np.array_equal(
                        out[off:off + r["n"]], res):
                    hit = (int(c), off)
                    break
            rows = set() if hit is None else {(hit[0], hit[1] + i) for i in range(r["n"])}
            if hit is None or rows & used:
                lost += 1
                continue
            used |= rows
            placed.append((r, hit))
        return placed, lost

    def _sample(self, placed: list) -> list:
        rng = np.random.default_rng(seeds.derive(self.seed, "check"))
        order = sorted(range(len(placed)), key=lambda i: -placed[i][0]["n"])[:1]
        rest = [i for i in rng.permutation(len(placed)) if i not in order]
        chosen, images = [], 0
        for i in order + rest:
            if images >= self.tr["check_images"]:
                break
            chosen.append(placed[i])
            images += placed[i][0]["n"]
        return chosen

    def _noise(self, chosen: list) -> torch.Tensor:
        """The noise rows of the chosen requests, replayed from the service's
        seed: every call draws one batch per ``service_batch`` rows it
        serves, in call order."""
        b = self.tr["service_batch"]
        first_batch = np.cumsum([0] + [-(-c["images"] // b) for c in self.recorder.calls])
        want: Dict[int, List[tuple]] = {}
        k = 0
        for r, (c, off) in chosen:
            for i in range(r["n"]):
                row = off + i
                want.setdefault(int(first_batch[c] + row // b), []).append((k, row % b))
                k += 1
        shape = (b, self.cfg["model"]["image_size"], self.cfg["model"]["image_size"],
                 self.cfg["model"]["in_channels"])
        gen = torch.Generator(device=self.device).manual_seed(self.service_seed)
        rows: List[Optional[torch.Tensor]] = [None] * k
        for batch in range(max(want) + 1):
            z = torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)
            for dst, src in want.get(batch, ()):
                rows[dst] = z[src]
        return torch.stack(rows)

    def check(self) -> dict:
        """Correctness numbers, each (value, limit); ``self.evidence`` keeps
        the noise, the served images and the reference's for a control."""
        placed, lost = self._locate()
        if not placed:
            return {"answers_lost": (float(lost), self.cell.limits["answers_lost"]),
                    "img_rel_rms": (math.inf, self.cell.limits["img_rel_rms"])}
        chosen = self._sample(placed)
        noise = self._noise(chosen)
        served = torch.from_numpy(np.concatenate([r["result"] for r, _ in chosen]))
        self.evidence = {"noise": noise, "served": served}
        with exact_fp32():
            self.mods = flow.build(self.cfg, weights.make(self.cfg, self.seed, self.device),
                                   self.device)
            ref = self.evidence["reference"] = self.images(Numerics())
        return {"answers_lost": (float(lost), self.cell.limits["answers_lost"]),
                "img_rel_rms": (rel_error(served, ref), self.cell.limits["img_rel_rms"])}

    def images(self, num: Numerics) -> torch.Tensor:
        """The reference's images (NCHW, on the host) for the kept noise rows."""
        out = flow.serve(self.mods, self.evidence["noise"], self.tr["num_steps"], num, self.tr["check_block"])
        return out.permute(0, 3, 1, 2).cpu()


def rel_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst image's ||got - ref|| / ||ref||."""
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    return float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
