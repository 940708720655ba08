"""Training through the program's ``make_train_epoch``.

Set-up builds the flow model in the traffic's compute dtype on float32
masters with the benchmark's weights, ``make_optimizer`` (clip, AdamW at the
per-epoch cosine rate), the EMA and one ``train_epoch`` function, a corpus on
the device made from the seed (``tanh`` of a normal draw for images, a
normal draw for latents), and a generator on the device seeded from the run's
seed. It then drives that same object through its first ``check_steps``
steps, one call of one step each, on rows that all differ, reading the
optimizer's first moment after step 1 (the gradient it got, clipped: m1 =
0.1 g) and the parameters and EMA after the last; these steps also warm up
every shape. In the window it calls ``train_epoch`` with ``steps_per_call``
steps on a fresh permutation of the corpus, reads the losses after each call,
and stops after the call that ends past ``--seconds``.

Correctness: the reference follows the same steps from the same weights,
batches and replayed random draws in float32, and the program is held to it
by the step losses, the first gradient, the parameters' change and the EMA's
change: for each leaf the gap between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median leaf,
taken at the worst leaf; and the first gradient's difference from the
reference's at the worst leaf, ||g - g_ref|| over the same norm. The loss
compared is the first step's. Leaves whose reference gradient is below a
thousandth of the median leaf's, and in the changes the elements whose
reference gradient is below a thousandth of the median leaf's RMS, move by
round-off alone and are left out.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from rfbench import core, seeds, tracing, weights
from rfbench.reference import flow
from rfbench.reference.numerics import Numerics, exact_fp32

BETA1 = 0.9
NEGLIGIBLE = 1e-3


def corpus(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    m = config["model"]
    shape = (traffic["batch"] * traffic["corpus_batches"], m["image_size"], m["image_size"],
             m["in_channels"])
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "corpus"))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.tanh(x) if traffic["corpus"] == "tanh_normal" else x


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keep)


class Run:
    def __init__(self, cell: core.Cell, seed: int, device: torch.device) -> None:
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.rng = np.random.default_rng(seeds.derive(seed, "rows"))
        n = self.tr["batch"] * self.tr["corpus_batches"]
        self.first_rows = self.rng.permutation(n)[: self.tr["check_steps"] * self.tr["batch"]]

    def opt_params(self) -> dict:
        t = self.tr
        return {"lr": t["lr"], "epochs": t["epochs"], "steps_per_epoch": t["corpus_batches"],
                "weight_decay": t["weight_decay"], "ema_decay": t["ema_decay"]}

    # ---- program -----------------------------------------------------------

    def setup(self) -> None:
        from rectified_flow_vision_tpu_torch.models.base_flow import (
            BaseFlowModel, init_ema, make_optimizer, make_train_epoch)

        t = self.tr
        mark = core.phase_marker(self)
        mark("import_program")
        w = weights.make(self.cfg, self.seed, self.device)
        mark("weights")
        self.model = BaseFlowModel(**self.cfg["model"], compute_dtype=t["compute_dtype"],
                                   device=self.device)
        self.model.velocity_net.load_state_dict(w["velocity_net"], strict=True)
        del w
        mark("models")
        self.opt = make_optimizer(self.model, t["lr"], t["epochs"], t["corpus_batches"])
        self.ema = init_ema(self.model)
        self.epoch = make_train_epoch(self.model, self.opt, coupled=False, ema=self.ema,
                                      ema_decay=t["ema_decay"])
        self.corpus = corpus(self.cfg, t, self.seed, self.device)
        mark("optimizer_corpus")
        self.gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "train"))
        named = dict(self.model.velocity_net.named_parameters())
        rows = torch.as_tensor(self.first_rows, device=self.device).view(-1, 1, t["batch"])
        self.prog: Dict[str, object] = {"losses": []}
        for i, perm in enumerate(rows):
            self.prog["losses"].append(float(self.epoch(self.corpus, perm, self.gen).cpu()[0]))
            if i == 0:
                # a parameter the optimizer never stepped has no moment: no gradient
                state = self.opt.adamw.state
                self.prog["grad"] = {
                    k: (state[p]["exp_avg"] / (1 - BETA1)).cpu() if "exp_avg" in state.get(p, {})
                    else torch.zeros(p.shape) for k, p in named.items()}
        # copies: the window goes on updating both in place
        self.prog["params"] = {k: p.detach().to("cpu", copy=True) for k, p in named.items()}
        self.prog["ema"] = {k[len("velocity_net."):]: e.to("cpu", copy=True)
                            for k, e in self.ema.items()}
        mark("check_steps")

    def window(self, seconds: float, traced: bool) -> dict:
        t = self.tr
        n, k, b = t["batch"] * t["corpus_batches"], t["steps_per_call"], t["batch"]
        calls: List[dict] = []
        failed = 0

        def call() -> None:
            nonlocal failed
            perm = torch.as_tensor(self.rng.permutation(n)[: k * b].reshape(k, b), device=self.device)
            before, w0 = core.launch_counts(), time.time_ns()
            losses = self.epoch(self.corpus, perm, self.gen).cpu()
            failed += int((~torch.isfinite(losses)).sum())
            calls.append({"steps": k, "images": k * b, "w0": w0,
                          "launches": core.launch_delta(before, core.launch_counts())})

        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            call()
        elapsed = time.perf_counter() - start
        steps = sum(c["steps"] for c in calls)
        out = {"attempted": steps, "failed": failed,
               "end_to_end": {"train_img_per_s": steps * b / elapsed}}
        if traced:  # the device alone over trace_calls calls, then one with the host
            summary = None
            for host, n_calls in ((False, t["trace_calls"]), (True, 1)):
                with tracing.Profiler(self.device, host) as prof:
                    for _ in range(n_calls + 1):
                        call()
                part = prof.summary([c["w0"] for c in calls])
                if part is not None and summary is not None:
                    summary.idle_gaps = part.idle_gaps
                elif not host:
                    summary = part
            out["observed"] = core.Observed(self.cfg, t, summary, calls, 0,
                                            rate=out["end_to_end"]["train_img_per_s"])
        return out

    def free(self) -> None:
        del self.model, self.opt, self.ema, self.epoch, self.corpus
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness ---------------------------------------------------------

    def reference(self, num: Numerics, use_rows=None) -> dict:
        """The reference's readings of the same steps (``use_rows``: the loss
        over the first rows of each batch only, a planted fault)."""
        w = weights.make(self.cfg, self.seed, self.device)
        self.p0 = {k: v.cpu() for k, v in w["velocity_net"].items()}
        x1 = corpus(self.cfg, self.tr, self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "train"))
        rows = list(torch.as_tensor(self.first_rows, device=self.device).view(-1, self.tr["batch"]))
        with exact_fp32():
            mods = flow.build(self.cfg, w, self.device)
            res = flow.train(mods, x1, rows, gen, self.opt_params(), num, self.tr["check_block"],
                             use_rows=use_rows)
        return {"losses": res["losses"], "grad": {k: v.cpu() for k, v in res["grad"].items()},
                "params": {k: v.cpu() for k, v in res["params"].items()},
                "ema": {k: v.cpu() for k, v in res["ema"].items()}}

    def readings(self, got: dict, ref: dict) -> Dict[str, float]:
        norms = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
        med = float(np.median(list(norms.values())))
        keep = [k for k, v in norms.items() if v >= NEGLIGIBLE * med]
        # elements too: a key's bias is a slice of the qkv bias, and its
        # gradient is round-off that Adam turns into a step of any size
        rms = float(np.median([float(ref["grad"][k].pow(2).mean().sqrt()) for k in keep]))
        moved = {k: ref["grad"][k].abs() >= NEGLIGIBLE * rms for k in keep}
        delta = lambda d: {k: (d[k] - self.p0[k])[moved[k]] for k in keep}  # noqa: E731
        med_norm = float(np.median([norms[k] for k in keep]))
        return {
            # the first step's: later steps' losses follow updates that Adam's
            # sign-like first step makes from round-off, and swing by seed
            "loss_gap": abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": leaf_gap(got["grad"], ref["grad"], keep),
            # the norms cannot see a gradient of the wrong rows: the worst
            # leaf's difference can
            "grad_diff": max(float((got["grad"][k] - ref["grad"][k]).double().norm())
                             / max(norms[k], med_norm) for k in keep),
            "step_gap": leaf_gap(delta(got["params"]), delta(ref["params"]), keep),
            "ema_gap": leaf_gap(delta(got["ema"]), delta(ref["ema"]), keep),
        }

    def check(self) -> dict:
        self.ref = self.reference(Numerics())
        values = self.readings(self.prog, self.ref)
        return {k: (v, self.cell.limits.get(k)) for k, v in values.items()}
