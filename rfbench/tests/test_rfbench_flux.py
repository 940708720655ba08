"""The prompted serving cell (``kinds/serve_prompted_open_loop.py``, the
FLUX configuration) at a tiny size on the CPU, past the harness's look for a
card: the reference is the program's function with prompts; a sound run is
correct; the fp8 control (beside the sound reading, and in the program's
place through ``run.run_cell``), an answer altered where it is produced, a
zero velocity, two requests' prompts swapped and RoPE left out are not; the new
readers on made-up records. (``conftest.tiny`` knows the manifest's first
backbones only, so this file makes its own tiny cell.)"""

import copy
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from conftest import ROOT
from rfbench import core, run, weights
from rfbench.kinds import serve_prompted_open_loop as K
from rfbench.reference import flow, flux
from rfbench.reference.numerics import Numerics

CELL = "flux1-schnell-4d8s.serve.1024px-s4"
CPU = torch.device("cpu")
TINY_MODEL = dict(image_size=8, in_channels=4, hidden_size=64, num_heads=4, depth=1,
                  depth_single_blocks=2, context_in_dim=32, context_tokens=8, vec_in_dim=24,
                  axes_dim=[4, 6, 6])
TINY_VAE = dict(image_size=32, latent_channels=4, base_channels=16, downsample=4)
TINY_TRAFFIC = dict(rate_per_s=6, senders=8, check_images=4, check_block=2, trace_calls=2)
SEED = 2**33 + 19


def tiny() -> core.Cell:
    cell = core.cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TINY_MODEL)
    cell.config["vae"].update(TINY_VAE)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def _run(cell, traced=False):
    return run.run_cell(cell, SEED, 1.0, traced, CPU, time.perf_counter())


def test_the_configuration_is_flux_schnell_cut_in_depth_only():
    cfg = core.cell(CELL).config
    pub, m = cfg["published"], cfg["model"]
    for key in ("hidden_size", "num_heads", "mlp_ratio", "context_in_dim", "vec_in_dim",
                "axes_dim", "theta", "qkv_bias"):
        assert m[key] == pub[key], key
    assert m["in_channels"] * m["patch_size"] ** 2 == pub["in_channels"]
    assert (m["depth"], m["depth_single_blocks"]) == (4, 8) and cfg["reduced"] == [
        "depth", "depth_single_blocks"]
    assert m["context_tokens"] == pub["max_sequence_length"]
    assert m["image_size"] * cfg["vae"]["downsample"] == pub["width"] == cfg["vae"]["image_size"]
    mods = flow.skeleton(cfg)
    assert sum(p.numel() for p in mods["velocity_net"].parameters()) == cfg["parameters"]
    assert flux.flash_calls(m, 1) == [(1, 4352, 24, 128)] * 12
    sites = flux.qk_norm_rope_sites(m, 1)
    assert len(sites) == 16 and sites[:2] == [(1, 256, 3072, 128), (1, 4096, 3072, 128)]


def test_the_reference_is_the_programs_function_with_prompts():
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cfg = tiny().config
    w = K.make_weights(cfg, 3, CPU)
    scales = [v for k, v in w["velocity_net"].items() if k.endswith("_norm.scale")]
    assert scales and all(float((s - 1).abs().max()) < 0.3 for s in scales)
    model = BaseFlowModel(**dict(cfg["model"], sample_dtype="float32"), device=CPU)
    model.velocity_net.load_state_dict(w["velocity_net"])
    ref = flow.build(cfg, w, CPU)["velocity_net"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 8, 4), generator=g)
    t = torch.tensor([0.25, 0.75])
    p = [K.prompt(cfg, 5, k) for k in range(2)]
    cond = {k: torch.stack([q[k] for q in p]) for k in p[0]}
    with torch.no_grad():
        got = model.velocity_net(x, t, dtype=torch.float32, cond=cond)
        want = ref.velocity(x, t, Numerics(), cond["txt"], cond["vec"])
        bare = ref.velocity(x, t, Numerics(), cond["txt"], cond["vec"], rope=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert want.abs().mean() > 0.05
    assert float((bare - want).norm() / want.norm()) > 0.01


def test_a_sound_run_is_correct_and_the_faults_are_not():
    cell = tiny()
    captured = {}
    check = K.Run.check

    def keep(self):
        out = check(self)
        captured["run"] = self
        return out

    K.Run.check = keep
    try:
        res = _run(cell)
    finally:
        K.Run.check = check
    assert res["correct"], res["checks"]
    r = captured["run"]
    limit = cell.limits["img_rel_rms"]
    faults = r.faults()
    assert faults["swapped_prompts"] > limit and faults["no_rope"] > limit, faults
    from rfbench.kinds import serve_open_loop as base
    from rfbench.reference.numerics import exact_fp32

    with exact_fp32():
        fp8 = r.images(Numerics(fp8=True))
    assert base.rel_error(fp8, r.evidence["reference"]) > limit


def test_the_control_is_not_correct_through_the_harness(monkeypatch):
    """The fp8 control in the program's place, as ``test_rfbench_control``
    puts it for the other serving cells: each batch the service makes is the
    fp8 reference's images from that batch's noise and prompts (the rows the
    service bound to its sampler). The harness's own comparison
    (``run.run_cell``) finds it not correct."""
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    from rfbench.reference.numerics import exact_fp32

    cell, mods = tiny(), {}

    def fp8_run(self, sampler, noise):
        if not mods:
            mods.update(flow.build(cell.config, K.make_weights(cell.config, SEED, noise.device),
                                   noise.device))
        cond = sampler.keywords["cond"]
        with exact_fp32():
            return flux.serve(mods, noise, cond["txt"], cond["vec"], cell.traffic["num_steps"],
                              Numerics(fp8=True), cell.traffic["check_block"])

    monkeypatch.setattr(SamplerService, "_run", fp8_run)
    res = _run(cell)
    assert res["attempted"] > 0 and res["failed"] == 0, res
    got = res["checks"]["img_rel_rms"]
    assert not res["correct"] and got["value"] > got["limit"], res["checks"]


def test_every_seed_is_offered_one_order_of_arrivals(monkeypatch):
    """The window's schedule (and the count of prompts drawn for it) comes
    from ``SCHEDULE_SEED`` whatever the run's seed; the run's seed is back in
    place for the check, which draws its sample, weights and prompts from it."""
    from rfbench.kinds import serve_open_loop as base

    drawn, schedule = [], base.schedule
    monkeypatch.setattr(base, "schedule", lambda tr, s, seed, *a: drawn.append(seed) or
                        schedule(tr, s, seed, *a))
    check, seen = K.Run.check, []
    monkeypatch.setattr(K.Run, "check", lambda self: seen.append(self.seed) or check(self))
    res = _run(tiny(), traced=True)
    assert res["correct"], res["checks"]
    assert len(drawn) == 4 and set(drawn) == {K.SCHEDULE_SEED} != {SEED}, drawn
    assert seen == [SEED]


def _zero_velocity(monkeypatch):
    from rectified_flow_vision_tpu_torch.models.flux import Flux

    forward = Flux.forward
    monkeypatch.setattr(Flux, "forward", lambda self, *a, **k: 0 * forward(self, *a, **k))


def _altered_answer(monkeypatch):
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    produce = SamplerService._run
    monkeypatch.setattr(SamplerService, "_run", lambda self, *a: produce(self, *a) + 0.1)


def _one_prompt_for_all(monkeypatch):
    submit = K._Prompting.submit

    def same(self, n, num_steps, timeout=300.0):
        self.prompts = [self.prompts[0]] * len(self.prompts)
        return submit(self, n, num_steps, timeout)

    monkeypatch.setattr(K._Prompting, "submit", same)


@pytest.mark.parametrize("fault", [_zero_velocity, _altered_answer, _one_prompt_for_all])
def test_a_broken_prompted_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run(tiny())
    assert not res["correct"], res["checks"]


def test_the_readers_of_the_new_metrics():
    first = {"generate_calls": 4, "cond_sum_s": 0.002}
    last = {"generate_calls": 8, "cond_sum_s": 0.006}

    class Records:
        timed = [{"images": 1, "batcher": first}, {"images": 1, "batcher": last}]

    read = core.metric_reader("cond_ms.serve")
    assert read(Records()) == pytest.approx(1.0)
    Records.timed = [{"batcher": {"generate_calls": 4}}, {"batcher": {"generate_calls": 8}}]
    assert read(Records()) is None  # a program without the counter

    class Summary:
        def __init__(self, kernels):
            self.kernels = kernels

        def kernel_seconds(self, pattern):
            import re

            hits = [d for n, d in self.kernels if re.search(pattern, n)]
            return len(hits), sum(hits)

    cell = core.cell(CELL)

    class Traced:
        config, traffic = cell.config, cell.traffic

        def __init__(self, kernels, launches):
            self.summary, self._l = Summary(kernels), launches

        def launches(self, k):
            return self._l.get(k, 0)

    qkr = core.metric_reader("qk_norm_rope_roofline")
    sites = flux.qk_norm_rope_sites(cell.config["model"], 1)
    least = qkr.__globals__["least_s"](sites)
    # 16 launches of one forward, their bytes at 3.35 TB/s, over twice that time: 50%
    got = qkr(Traced([("qk_norm_rope_kernel<bf16, 16>", 2 * least)], {"qk_norm_rope": 16}))
    assert got == pytest.approx(50.0)
    assert qkr(Traced([], {"qk_norm_rope": 16})) is None
    flash = core.metric_reader("joint_flash_fwd_roofline")
    one = 4.0 * 24 * 4352**2 * 128 / 989e12
    assert flash(Traced([("flash_fwd_wgmma_kernel<128>", 12 * one)], {"flash_attention": 12})) \
        == pytest.approx(100.0)


def test_a_cpu_rehearsal_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "rfbench" / "tests")!r}]
        import torch
        torch.set_num_threads(2)
        from test_rfbench_flux import tiny
        from rfbench import run
        res = run.run_cell(tiny(), 2**33 + 3, 1.0, True, torch.device("cpu"), time.perf_counter())
        assert res["attempted"] > 0, res
        print(run.forbidden_modules(), "rectified_flow_vision_tpu_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
