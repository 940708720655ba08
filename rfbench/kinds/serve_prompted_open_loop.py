"""Open-loop serving of a prompted (text-to-image) model through the
program's in-process batcher: ``serve_open_loop`` with a prompt a request.

Everything ``serve_open_loop`` does (the schedule, the senders, the recorder,
the noise replay, the check's placement of each answer) is reused from it;
this kind adds the prompts, and offers every seed the same order of
arrivals. Each request carries one prompt's encoder outputs, drawn N(0, 1)
on the host from the run's seed and the prompt's index (``txt``
[context_tokens, context_in_dim], ``vec`` [vec_in_dim]), and sends them with
``Batcher.submit(..., cond=)``; all prompts a run can send are drawn before
its window starts. Senders take prompts in the order they
submit, and the prompt each answer was made from is kept by the answer.

Arrivals: ``serve_open_loop.schedule`` drawn with ``SCHEDULE_SEED`` for every
run, so every seed is offered the same gaps in the same order (the run's seed
still draws the prompts, the weights, the noise and the checked sample). At
batch 1, a call an image, the tail of a window's ~50 requests is set by how
the gaps fall: where they are reshuffled by each seed, the p95 of six seeds
spreads 20-30% whatever the program does; on one order it follows the
program's call time.

Weights: ``weights.make``, then every QK-RMSNorm scale leaf (``*_norm.scale``)
set to 1 + 0.05 z, as ``weights.make`` sets a GroupNorm scale (its rule for a
vector, 0.05 z, would shrink every logit twenty-fold and flatten every
softmax, so that neither RoPE nor the text could be seen). The model takes
those tensors as its parameters (``BaseFlowModel(weights=)``), so set-up never
holds two fp32 copies of the network.

Correctness: as ``serve_open_loop``, with the reference (``reference.flux``)
given each checked image's own prompt. ``faults`` computes the reference with
two requests' prompts swapped and with RoPE left out, against the sound
reference, for the limit's calibration.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from rfbench import core, seeds, weights
from rfbench.kinds import serve_open_loop as base
from rfbench.reference import flow, flux
from rfbench.reference.numerics import Numerics, exact_fp32

SCHEDULE_SEED = 0  # the one order of arrivals, for every run's seed


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``weights.make`` with the QK-RMSNorm scales at 1 + 0.05 z."""
    w = weights.make(cfg, seed, device)
    for name, p in w["velocity_net"].items():
        if name.endswith("_norm.scale"):
            p.add_(1.0)
    return w


def prompt(cfg: dict, seed: int, index) -> Dict[str, torch.Tensor]:
    """Prompt ``index`` of a run: its encoder outputs, N(0, 1), on the host."""
    m = cfg["model"]
    gen = torch.Generator().manual_seed(seeds.derive(seed, f"prompt:{index}"))
    return {"txt": torch.randn((m["context_tokens"], m["context_in_dim"]), generator=gen),
            "vec": torch.randn((m["vec_in_dim"],), generator=gen)}


class _Prompting:
    """The batcher as the senders see it: each ``submit`` takes the next
    prompt and sends it with the request; the answer keeps its index."""

    def __init__(self, batcher, prompts: List[Dict[str, torch.Tensor]]) -> None:
        self.batcher, self.prompts = batcher, prompts
        self.of: Dict[int, int] = {}  # id(answer) -> prompt index
        self._next, self._lock = 0, threading.Lock()

    def submit(self, n: int, num_steps: int, timeout: float = 300.0):
        with self._lock:
            k = self._next
            self._next += 1
        out = self.batcher.submit(n, num_steps, timeout=timeout, cond=self.prompts[k])
        self.of[id(out)] = k
        return out

    def shutdown(self) -> None:
        self.batcher.shutdown()


class Run(base.Run):
    def setup(self) -> None:
        from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE
        from rectified_flow_vision_tpu_torch.serving import SamplerService
        from rectified_flow_vision_tpu_torch.serving_http import Batcher

        mark = core.phase_marker(self)
        mark("import_program")
        w = make_weights(self.cfg, self.seed, self.device)
        mark("weights")
        # the drawn weights become the model's own: one fp32 copy on the card
        model = BaseFlowModel(**self.cfg["model"], device=self.device, weights=w["velocity_net"])
        vae = ConvVAE(**self.cfg["vae"], device=self.device)
        vae.load_state_dict(w["vae"], strict=True)
        del w
        mark("models")
        self.service = SamplerService(
            model, step_counts=(self.tr["num_steps"],), batch_size=self.tr["service_batch"],
            seed=self.service_seed, vae=vae)
        mark("service_warmup")
        self.recorder = base._Recorder(self.service, self.device)
        batcher = Batcher(self.service, max_wait_ms=self.tr["max_wait_ms"])
        self.recorder.batcher = batcher
        self.batcher = _Prompting(batcher, [prompt(self.cfg, self.seed, "setup")])
        self.batcher.submit(1, self.tr["num_steps"])
        base._sync(self.device)
        mark("first_request")

    def window(self, seconds: float, traced: bool) -> dict:
        """``serve_open_loop``'s window on the schedule of ``SCHEDULE_SEED``,
        every prompt it can send drawn first from the run's seed."""
        count = len(base.schedule(self.tr, seconds, SCHEDULE_SEED)[0])
        if traced:
            count += len(base.schedule(self.tr, 2 * seconds, SCHEDULE_SEED, "trace")[0])
        self.first_prompt = len(self.batcher.prompts)
        self.batcher.prompts += [prompt(self.cfg, self.seed, k) for k in range(count)]
        # the base window draws its schedule from ``self.seed`` and from nothing else
        seed, self.seed = self.seed, SCHEDULE_SEED
        try:
            return super().window(seconds, traced)
        finally:
            self.seed = seed

    def free(self) -> None:
        self.prompt_of = dict(self.batcher.of)
        super().free()

    def _prompts(self, chosen: list, swap: bool = False) -> Dict[str, torch.Tensor]:
        """The checked images' prompts, one row an image, on the device;
        ``swap`` exchanges the first two requests' prompts."""
        ks = [self.prompt_of[id(r["result"])] - self.first_prompt for r, _ in chosen]
        if swap:
            ks[0], ks[1] = ks[1], ks[0]
        rows = [prompt(self.cfg, self.seed, k) for k, (r, _) in zip(ks, chosen)
                for _ in range(r["n"])]
        return {key: torch.stack([p[key] for p in rows]).to(self.device) for key in rows[0]}

    def check(self) -> dict:
        placed, lost = self._locate()
        limits = self.cell.limits
        if not placed:
            return {"answers_lost": (float(lost), limits["answers_lost"]),
                    "img_rel_rms": (float("inf"), limits["img_rel_rms"])}
        self.chosen = chosen = self._sample(placed)
        served = torch.from_numpy(np.concatenate([r["result"] for r, _ in chosen]))
        self.evidence = {"noise": self._noise(chosen), "served": served,
                         "prompts": self._prompts(chosen)}
        with exact_fp32():
            self.mods = flow.build(self.cfg, make_weights(self.cfg, self.seed, self.device),
                                   self.device)
            ref = self.evidence["reference"] = self.images(Numerics())
        return {"answers_lost": (float(lost), limits["answers_lost"]),
                "img_rel_rms": (base.rel_error(served, ref), limits["img_rel_rms"])}

    def images(self, num: Numerics, prompts: Optional[dict] = None,
               rope: bool = True) -> torch.Tensor:
        """The reference's images (NCHW, on the host) for the kept noise rows
        and their prompts (or ``prompts``)."""
        p = prompts or self.evidence["prompts"]
        out = flux.serve(self.mods, self.evidence["noise"], p["txt"], p["vec"],
                         self.tr["num_steps"], num, self.tr["check_block"], rope)
        return out.permute(0, 3, 1, 2).cpu()

    def faults(self) -> Dict[str, float]:
        """Planted faults' readings against the sound reference: two
        requests' prompts swapped, RoPE left out."""
        ref = self.evidence["reference"]
        with exact_fp32():
            swapped = self.images(Numerics(), self._prompts(self.chosen, swap=True))
            bare = self.images(Numerics(), rope=False)
        return {"swapped_prompts": base.rel_error(swapped, ref),
                "no_rope": base.rel_error(bare, ref)}
