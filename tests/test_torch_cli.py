"""The port's latent pipeline and its CLI on the CPU.

* end to end at the tiny latent size of ``tests/test_experiments_e2e.py``:
  the ConvVAE trained first, the flow in its latent space, the benchmark
  judging decoded pixels; the artifact set of that test;
* the CLI, ``main(argv, device="cpu")``: steps 1-4 with K = 2 Reflow rounds
  (the JAX package's checkpoint names), then ``--skip-training
  --skip-download`` running the benchmark alone; its flags are the root
  ``main.py``'s.

Held by structure (rows, columns, artifacts, finite values); every path is
under ``tmp_path``, and ``repo_root`` is pointed there for the held-out
references the benchmark writes under ``data/``.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from rectified_flow_vision_tpu import config as JC
from rectified_flow_vision_tpu_torch import config as TC
from rectified_flow_vision_tpu_torch.experiments import benchmark as TB
from rectified_flow_vision_tpu_torch.experiments import train_base as TTB
from rectified_flow_vision_tpu_torch.experiments import train_rectified as TTR
from rectified_flow_vision_tpu_torch.main import main as cli_main
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt
from test_torch_experiments import PIXEL_ARTIFACTS, ROOT, tiny_cfg  # tests/ is on sys.path


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


@pytest.fixture(scope="module")
def latent_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e_latent")
    cfg = tiny_cfg(root, latent=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "repo_root", lambda: root)
        base = TTB.main(cfg, device="cpu")
        rect = TTR.main(cfg, device="cpu")
        rows = TB.main(cfg, device="cpu")
    return cfg, base, rect, rows


def test_latent_pipeline_trains_the_vae_and_benchmarks_decoded_pixels(latent_run):
    cfg, base, rect, rows = latent_run
    assert (base.image_size, base.in_channels) == (4, 4)  # the flow lives in latent space
    assert rect.image_size == 4
    ck, results = Path(cfg.paths.checkpoints), Path(cfg.paths.results)
    for f in ("vae.npz", "base_flow_final.npz", "rectified_flow_k1_final.npz"):
        assert (ck / f).exists(), f
    assert all(r["base_time_ms"] > 0 for r in rows)
    for f in PIXEL_ARTIFACTS:
        assert (results / f).exists(), f
    q = pd.read_csv(results / "quality_results.csv")
    assert len(q) == 9 and q["ssim_mean"].notna().all()
    assert np.isfinite(q["fid_deep"]).all()


def test_cli_runs_the_four_steps_then_the_benchmark_alone(tmp_path, monkeypatch):
    root = tmp_path
    cfg = tiny_cfg(root)
    cfg.training_rectified.epochs = 2
    cfg.training_rectified.num_reflow_iterations = 2  # K = 2: two more rounds
    cfg.training_rectified.ema_decay = 0.9
    cfg.benchmark.prefer_ema = True
    cfg.save(root / "cfg.yaml")
    monkeypatch.setattr(TC, "repo_root", lambda: root)

    cli_main(["--offline", "--config", str(root / "cfg.yaml")], device="cpu")
    ck, results = Path(cfg.paths.checkpoints), Path(cfg.paths.results)
    assert len(list(Path(cfg.data.data_dir).glob("image_*.png"))) == 12  # step 1
    for f in ("base_flow_final.npz", "rectified_flow_k1_final.npz",
              "rectified_flow_k1_ema_final.npz", "reflow_k1_final.npz", "reflow_k1_ema_final.npz",
              "reflow_k2_final.npz", "reflow_k2_ema_final.npz"):
        assert (ck / f).exists(), f
    assert ckpt.load_params(ck / "reflow_k2_final.npz")[1]["reflow_iteration"] == 2
    for f in PIXEL_ARTIFACTS:
        assert (results / f).exists(), f

    stamps = {p.name: p.stat().st_mtime_ns for p in ck.iterdir()}
    os.utime(results / "benchmark_results.csv", ns=(0, 0))
    cli_main(["--skip-training", "--skip-download", "--config", str(root / "cfg.yaml")],
             device="cpu")
    assert {p.name: p.stat().st_mtime_ns for p in ck.iterdir()} == stamps
    assert (results / "benchmark_results.csv").stat().st_mtime_ns > 0


def test_cli_flags_are_the_root_main_pys():
    jax_main = (ROOT / "main.py").read_text()
    parser_flags = {a.split('"')[1] for a in jax_main.split("parser.add_argument(")[1:]}
    from rectified_flow_vision_tpu_torch.main import parse_args

    args = parse_args(["--skip-training", "--skip-download", "--quick", "--offline",
                       "--config", "x.yaml"])
    assert {"--" + k.replace("_", "-") for k in vars(args)} == parser_flags
    assert dataclasses.asdict(TC.load_config(None)) == dataclasses.asdict(JC.load_config(None))
