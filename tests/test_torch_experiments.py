"""The port's pipeline stages and CLI on the CPU, held against the JAX package.

* ``build_model``: the JAX package's parameter count and parameter tree for
  every config;
* the benchmark's pure judges (``judge_quality_claim``,
  ``conclusion_lines_for``, ``guard_untrained_overwrite``): the JAX
  package's outputs on the same rows, exactly;
* end to end at the tiny pixel size of ``tests/test_experiments_e2e.py``:
  ``train_base.main`` -> ``train_rectified.main`` -> ``benchmark.main``
  write that test's artifact set, and the port's ``base_flow_final.npz``
  loads in the JAX ``BaseFlowModel`` to the same 2-step samples (fp32,
  within 1e-4). The latent pipeline and the CLI are in
  ``tests/test_torch_cli.py``.

The two packages draw different random numbers, so the pipelines are held by
structure (rows, columns, artifacts, finite values), not by value. Every path
is under ``tmp_path``; ``repo_root`` is pointed there for the held-out
references the benchmark writes under ``data/``.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from rectified_flow_vision_tpu import config as JC
from rectified_flow_vision_tpu.experiments import benchmark as JB
from rectified_flow_vision_tpu.experiments import train_base as JTB
from rectified_flow_vision_tpu_torch import config as TC
from rectified_flow_vision_tpu_torch.experiments import benchmark as TB
from rectified_flow_vision_tpu_torch.experiments import train_base as TTB
from rectified_flow_vision_tpu_torch.experiments import train_rectified as TTR
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
PIXEL_ARTIFACTS = [
    "benchmark_results.csv", "benchmark_report.txt", "speed_comparison.png",
    "base_samples_1steps.png", "rect_samples_4steps.png", "quality_results.csv",
    "quality_vs_speed.png", "trajectory_comparison.png",
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes at once, and eight spinning OpenMP threads in each
    slow every one of them down many times over."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat_shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in ckpt.flatten_tree(tree).items()}


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_build_model_matches_the_jax_package(path):
    import jax

    jm = JTB.build_model(JC.load_config(path))
    tm = TTB.build_model(TC.load_config(path), device="cpu")
    assert tm.num_parameters() == jm.num_parameters()
    assert (tm.image_size, tm.in_channels, tm.backbone) == (jm.image_size, jm.in_channels,
                                                            jm.backbone)
    jparams = jax.tree_util.tree_map(np.asarray, jm.params)
    assert _flat_shapes(tm.params) == _flat_shapes(jparams)
    if tm.backbone == "unet":
        from rectified_flow_vision_tpu_torch.utils.pt_import import params_to_state_dict

        sd = params_to_state_dict(jparams, list(tm.velocity_net.channel_mult),
                                  tm.velocity_net.num_res_blocks)
        assert set(sd) == set(tm.state_dict())
    assert tm.device.type == "cpu"


def test_default_mesh_is_none_on_one_device_and_raises_for_more():
    cfg = TC.Config()
    assert TTB.default_mesh(cfg, "cpu") is None
    cfg.parallel.model_axis = 2
    with pytest.raises(NotImplementedError, match="A9"):
        TTB.default_mesh(cfg, "cpu")


def _q(steps, model, fid, ssim, lo=None, hi=None, prec=0.05):
    row = {"num_steps": steps, "model": model, "fid_deep": fid, "fid_simple": 10 * fid,
           "ssim_mean": ssim, "lpips_to_ref": prec, "n_eval": 1000}
    if lo is not None:
        row.update(fid_deep_lo=lo, fid_deep_hi=hi, lpips_to_ref_lo=prec - 0.001,
                   lpips_to_ref_hi=prec + 0.001)
    return row


def _t(steps, ms):
    return {"num_steps": steps, "time_per_image": ms / 1000, "images_per_second": 1000 / ms}


TIMING = ([_t(s, 0.1 * s) for s in (1, 2, 4, 8, 64, 100)],
          [_t(s, 0.1 * s) for s in (1, 2, 4, 8, 64, 100)])
QUALITY_CASES = {
    "supported": [_q(1, "rectified", 11.0, 0.5), _q(4, "rectified", 9.0, 0.6),
                  _q(4, "base", 30.0, 0.3), _q(100, "base", 10.0, 0.61)],
    "ssim_only": [_q(2, "rectified", 20.0, 0.60), _q(100, "base", 10.0, 0.61)],
    "refuted": [_q(4, "rectified", 20.0, 0.3), _q(100, "base", 10.0, 0.61)],
    "degraded_anchor": [_q(4, "rectified", 12.0, 0.5, 11, 13, prec=0.04),
                        _q(8, "base", 11.0, 0.5, 10.5, 11.5, prec=0.06),
                        _q(100, "base", 30.0, 0.5, 29, 31, prec=0.07)],
    "disagreement": [_q(4, "rectified", 9.0, 0.5, 8.5, 9.5, prec=0.09),
                     _q(100, "base", 12.0, 0.5, 11.5, 12.5, prec=0.05)],
    "no_fid_deep": [_q(4, "rectified", float("nan"), 0.5), _q(100, "base", float("nan"), 0.5)],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(QUALITY_CASES))
def test_judges_and_conclusions_equal_the_jax_package(case):
    rows = QUALITY_CASES[case]
    assert TB.judge_quality_claim(rows) == JB.judge_quality_claim(rows)
    got = TB.conclusion_lines_for(rows, *TIMING)
    assert got == JB.conclusion_lines_for(rows, *TIMING)
    assert got  # every case concludes something


def test_guard_untrained_overwrite_equals_the_jax_package(tmp_path):
    for guard in (TB.guard_untrained_overwrite, JB.guard_untrained_overwrite):
        guard(["base"], tmp_path, allow=False)  # nothing to overwrite
    (tmp_path / "quality_results.csv").write_text("x\n")
    msgs = []
    for guard in (TB.guard_untrained_overwrite, JB.guard_untrained_overwrite):
        guard([], tmp_path, allow=False)
        guard(["base"], tmp_path, allow=True)
        with pytest.raises(SystemExit, match="Refusing to overwrite") as err:
            guard(["base", "rectified"], tmp_path, allow=False)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def tiny_cfg(root: Path, latent: bool = False) -> TC.Config:
    """The configs of tests/test_experiments_e2e.py, under ``root``."""
    cfg = TC.Config()
    cfg.data.image_size = 16
    cfg.data.num_mock_images = 12
    cfg.data.data_dir = str(root / "data")
    cfg.model.channels = 16
    cfg.model.channel_mult = [1, 2]
    cfg.model.num_res_blocks = 1
    cfg.model.sample_dtype = "float32"
    cfg.training_base.epochs = 1 if latent else 2
    cfg.training_base.batch_size = 6
    cfg.training_base.save_every = 1
    cfg.training_base.num_timesteps = 40  # teacher steps = 4
    cfg.training_rectified.epochs = 1
    cfg.training_rectified.batch_size = 6
    cfg.training_rectified.num_reflow_iterations = 1
    cfg.benchmark.num_samples = 4
    cfg.benchmark.steps_to_test = [1, 2]
    cfg.benchmark.num_runs = 1
    cfg.paths.checkpoints = str(root / "ckpt")
    cfg.paths.results = str(root / "results")
    if latent:
        cfg.model.latent = True
        cfg.model.latent_channels = 4
        cfg.model.latent_downsample = 4
        cfg.model.vae_epochs = 2
    return cfg


@pytest.fixture(scope="module")
def pixel_run(tmp_path_factory):
    """The three stages, one after the other, on the tiny pixel config."""
    root = tmp_path_factory.mktemp("torch_e2e")
    cfg = tiny_cfg(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "repo_root", lambda: root)
        base = TTB.main(cfg, device="cpu")
        rect = TTR.main(cfg, device="cpu")
        rows = TB.main(cfg, device="cpu")
    return cfg, base, rect, rows


def test_pixel_stage1_train_base(pixel_run):
    cfg, base, _, _ = pixel_run
    ck = Path(cfg.paths.checkpoints)
    assert base.num_parameters() > 0 and base.device.type == "cpu"
    assert (ck / "base_flow_final.npz").exists()
    assert (ck / "base_flow_epoch1.npz").exists()
    losses = np.load(ck / "base_flow_losses.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()


def test_pixel_stage2_train_rectified(pixel_run):
    cfg, _, rect, _ = pixel_run
    ck = Path(cfg.paths.checkpoints)
    assert (ck / "rectified_flow_k1_final.npz").exists()
    assert np.isfinite(np.load(ck / "rectified_flow_k1_losses.npy")).all()
    assert rect.reflow_iteration == 0  # the single-reflow k1 model


def test_pixel_stage3_benchmark(pixel_run):
    cfg, _, _, rows = pixel_run
    assert [r["num_steps"] for r in rows] == [1, 2]
    assert all(r["base_time_ms"] > 0 and r["rect_time_ms"] > 0 for r in rows)
    results = Path(cfg.paths.results)
    for f in PIXEL_ARTIFACTS:
        assert (results / f).exists(), f
    speed = pd.read_csv(results / "benchmark_results.csv")
    assert list(speed.columns) == TB.SPEED_COLUMNS + TB.LATENCY_COLUMNS
    np.testing.assert_allclose(speed["base_time_ms"], [r["base_time_ms"] for r in rows])
    q = pd.read_csv(results / "quality_results.csv")
    assert list(q.columns) == TB.QUALITY_COLUMNS
    assert list(zip(q["num_steps"], q["model"])) == [
        (s, m) for s in (1, 2, 4, 8) for m in ("base", "rectified")] + [(64, "base")]
    assert np.isfinite(q["fid_deep"]).all() and q["ssim_mean"].between(-1, 1).all()
    assert np.isfinite(q[["lpips", "lpips_to_ref", "lpips_recall", "fid_simple"]]).all().all()
    assert "MEASURED QUALITY CONCLUSIONS" in (results / "benchmark_report.txt").read_text()
    # the held-out references went under the test's root, not the repo's
    assert len(list((results.parent / "data" / "eval_16").glob("*.png"))) == 32


def test_port_checkpoint_loads_in_the_jax_package(pixel_run):
    """The port's base checkpoint in JAX's BaseFlowModel: the same 2-step
    samples from the same noise, fp32, within 1e-4."""
    from rectified_flow_vision_tpu.models import BaseFlowModel as JBase

    cfg, base, _, _ = pixel_run
    path = str(Path(cfg.paths.checkpoints) / "base_flow_final.npz")
    jm = JBase.from_checkpoint(path)
    noise = np.random.default_rng(0).standard_normal((3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jm.sample(noise=noise, num_steps=2, data_format="NHWC", dtype="float32"))
    got = base.sample(noise=noise, num_steps=2, data_format="NHWC", dtype="float32").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
