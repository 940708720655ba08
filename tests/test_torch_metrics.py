"""The port's metrics against the JAX package's on identical numpy inputs.

32 seeded 64x64 images (and a perturbed copy) in fp32. Tolerances: SSIM is
the same numpy code: exact. SynthNet's heads and taps (the committed
``weights/synthnet.npz``; fp32 convs and GroupNorms in another summation
order) within 1e-4. The statistics built on them, and FID on raw pixels, within
1e-4 relative: they are float64 numpy / scipy on features that differ at the
level of fp32 rounding.
"""

import importlib
import logging

import numpy as np
import pandas as pd
import pytest
import torch

from rectified_flow_vision_tpu.utils import metrics as JM
from rectified_flow_vision_tpu.utils import synthnet as JS
from rectified_flow_vision_tpu_torch.experiments import benchmark as TB
from rectified_flow_vision_tpu_torch.utils import inception as TI
from rectified_flow_vision_tpu_torch.utils import lpips as TL
from rectified_flow_vision_tpu_torch.utils import metrics as TM
from rectified_flow_vision_tpu_torch.utils import synthnet as TS
from rectified_flow_vision_tpu_torch.utils import visualization as TV

RTOL = 1e-4


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


def _images(n=32, size=64, seed=0):
    r = np.random.default_rng(seed)
    coarse = np.kron(r.standard_normal((n, size // 8, size // 8, 3)), np.ones((1, 8, 8, 1)))
    return np.tanh(coarse + 0.2 * r.standard_normal((n, size, size, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def sets():
    ref = _images(seed=0)
    gen = np.clip(ref + 0.3 * _images(seed=1), -1, 1).astype(np.float32)
    return np.transpose(ref, (0, 3, 1, 2)), np.transpose(gen, (0, 3, 1, 2))


@pytest.fixture(scope="module")
def calcs():
    return TM.MetricsCalculator("cpu"), JM.MetricsCalculator()


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=0)


def test_ssim_is_exact(calcs):
    t, j = calcs
    a = ((_images(seed=2) + 1) * 127.5).astype(np.uint8)
    b = ((_images(seed=3) + 1) * 127.5).astype(np.uint8)
    for i in range(len(a)):
        assert t.compute_ssim(a[i], b[i]) == j.compute_ssim(a[i], b[i])
    assert t.compute_ssim(a[0, :, :, 0], b[0, :, :, 0]) == j.compute_ssim(a[0, :, :, 0],
                                                                          b[0, :, :, 0])
    with pytest.raises(ValueError):
        t.compute_ssim(a[0], b[0, :32])


def test_synthnet_apply_full_matches(sets):
    x = np.transpose(sets[0], (0, 2, 3, 1))
    jp = JS.load_weights()
    tp = TS.load_weights(device="cpu")
    want = JS.apply_full(jp, x)
    got = TS.apply_full(tp, torch.as_tensor(x))
    for k in ("counts", "blur", "noise"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0)
    assert len(got["taps"]) == len(want["taps"]) == 4
    for a, b in zip(got["taps"], want["taps"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    counts, taps = TS.apply(tp, torch.as_tensor(x))
    np.testing.assert_array_equal(counts.numpy(), got["counts"].numpy())


def test_synthnet_init_params_has_the_jax_shapes():
    import jax

    want = JS.init_params(jax.random.key(0))
    got = TS.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in got.items()} == {
        k: {n: tuple(np.shape(t)) for n, t in v.items()} for k, v in want.items()}
    out = TS.apply_full(got, torch.zeros((2, 32, 32, 3)))
    assert out["counts"].shape == (2, TS.NUM_TYPES, TS.MAX_COUNT + 1)


def test_fid_statistics_match(calcs, sets):
    t, j = calcs
    ref = sets[0][:12, :, :16, :16]
    (mu_t, sig_t), (mu_j, sig_j) = t.compute_fid_statistics(ref), j.compute_fid_statistics(ref)
    np.testing.assert_array_equal(mu_t, mu_j)  # raw pixels: the same numpy
    np.testing.assert_array_equal(sig_t, sig_j)
    (mu_t, sig_t) = t.compute_fid_statistics(ref, t.lpips_model.fid_features)
    (mu_j, sig_j) = j.compute_fid_statistics(ref, j.lpips_model.fid_features)
    np.testing.assert_allclose(mu_t, mu_j, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sig_t, sig_j, rtol=RTOL, atol=1e-6)


def test_synthnet_labeled_image_matches():
    from rectified_flow_vision_tpu_torch.utils.download_data import synthesize_image

    a, b, c = (np.random.default_rng(5) for _ in range(3))
    for _ in range(4):
        img_t, counts_t = TS.synthesize_labeled_image(a, 32)
        img_j, counts_j = JS.synthesize_labeled_image(b, 32)
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(counts_t, counts_j)
        np.testing.assert_array_equal(img_t, synthesize_image(c, 32))


def test_both_packages_choose_synthnet_without_lpips_and_inception_weights(calcs):
    assert not TL.DEFAULT_WEIGHTS_PATH.exists() and not TI.DEFAULT_WEIGHTS_PATH.exists()
    t, j = calcs
    assert t.lpips_model.backbone_name == j.lpips_model.backbone_name == "synthnet"
    assert isinstance(t.lpips_model, TS.SynthNetPerceptual)
    assert t.inception_model.__self__.backbone_name == "synthnet"
    with pytest.raises(FileNotFoundError):
        TL.LPIPS.load_default("cpu")
    with pytest.raises(FileNotFoundError):
        TI.InceptionV3Features.load_default("cpu")


def test_present_lpips_or_inception_weights_raise_rather_than_substitute(tmp_path,
                                                                         monkeypatch):
    for mod, cls in ((TL, TL.LPIPS), (TI, TI.InceptionV3Features)):
        (tmp_path / "w.npz").write_bytes(b"")
        monkeypatch.setattr(mod, "DEFAULT_WEIGHTS_PATH", tmp_path / "w.npz")
        with pytest.raises(NotImplementedError, match="A5"):
            cls.load_default("cpu")


def test_fid_raw_pixels_matches(calcs, sets):
    t, j = calcs
    ref, gen = sets
    _close(t.compute_fid(ref, gen), j.compute_fid(ref, gen))  # d > n: the Gram path
    assert abs(t.compute_fid(ref, ref)) < 1e-6


def test_fid_from_features_matches_on_both_paths():
    r = np.random.default_rng(4)
    for n, d in ((40, 16), (24, 300)):  # d x d covariances, then the Gram identity
        f1, f2 = r.standard_normal((n, d)), r.standard_normal((n, d)) + 0.3
        _close(TM.MetricsCalculator.fid_from_features(f1, f2),
               JM.MetricsCalculator.fid_from_features(f1, f2), rtol=1e-12)


def _gram_fid(f1, f2):
    """tr sqrt(S1 S2) as the nuclear norm of A B^T / sqrt(c1 c2)."""
    a, b = f1 - f1.mean(0), f2 - f2.mean(0)
    c1, c2 = len(f1) - 1, len(f2) - 1
    diff = f1.mean(0) - f2.mean(0)
    tr_sqrt = np.linalg.svd(a @ b.T, compute_uv=False).sum() / np.sqrt(c1 * c2)
    return diff @ diff + (a * a).sum() / c1 + (b * b).sum() / c2 - 2 * tr_sqrt


@pytest.mark.parametrize("case", ["replicate", "collapsed"])
def test_fid_from_features_where_s1_s2_is_singular(case):
    """The d x d branch where S1 S2 is singular: a bootstrap replicate that
    repeats samples (rank below d), or samples that all but coincide.
    Finite, and the Gram identity's value."""
    r = np.random.default_rng(5)
    n, d = 96, 80
    f1 = r.standard_normal((n, d)) @ r.standard_normal((d, d)) * 0.1
    f2 = r.standard_normal((n, d)) + 0.3
    f2 = f2[r.integers(0, n, n)] if case == "replicate" else f2[:1] + 1e-6 * f2
    got = TM.MetricsCalculator.fid_from_features(f1, f2)
    assert np.isfinite(got)
    _close(got, _gram_fid(f1, f2), rtol=1e-6)


def test_fid_deep_ci_matches(calcs, sets):
    t, j = calcs
    ref, gen = sets
    got = t.compute_fid_deep_ci(ref, gen, n_boot=16)
    want = j.compute_fid_deep_ci(ref, gen, n_boot=16)
    assert got["n"] == want["n"] == 32
    for k in ("fid", "lo", "hi"):
        _close(got[k], want[k])
    assert got["lo"] <= got["hi"]
    _close(t.compute_fid_deep(ref, gen), j.compute_fid_deep(ref, gen))
    _close(t.compute_fid_inception(ref, gen), j.compute_fid_inception(ref, gen))


def test_lpips_and_set_statistics_match(calcs, sets):
    t, j = calcs
    ref, gen = sets
    _close(t.compute_lpips(ref, gen, block=12), j.compute_lpips(ref, gen, block=12))
    got = t.compute_lpips_set_stats(gen, ref, block=10, n_boot=50)
    want = j.compute_lpips_set_stats(gen, ref, block=10, n_boot=50)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    _close(t.compute_lpips_to_set(gen, ref), j.compute_lpips_to_set(gen, ref))
    pair = t.lpips_model.pairwise_distance(gen[:5], ref[:5])
    _close(np.diag(pair), t.lpips_model(gen[:5], ref[:5]), rtol=1e-3)


def test_missing_backbone_gives_nan_with_every_key(monkeypatch, sets):
    calc = TM.MetricsCalculator("cpu")
    monkeypatch.setattr(TS, "DEFAULT_WEIGHTS_PATH", TS.DEFAULT_WEIGHTS_PATH.with_name("none.npz"))
    ref, gen = sets
    assert np.isnan(calc.compute_lpips(ref, gen))
    stats = calc.compute_lpips_set_stats(gen, ref)
    assert len(stats) == 6 and all(np.isnan(v) for v in stats.values())
    deep = calc.compute_fid_deep_ci(ref, gen)
    assert deep["n"] == 0 and np.isnan(deep["fid"])


def _rows():
    return [
        {"num_steps": 1, "model": "base", "ssim_mean": 0.5, "ssim_n": 32, "lpips": float("nan"),
         "fid_simple": 1.25e-5, "fid_deep": 3.0, "n_eval": 32, "extra": "x"},
        {"num_steps": 100, "model": "rectified", "ssim_mean": 0.1 + 0.2, "ssim_n": 32,
         "lpips": 0.07, "fid_simple": 12345.678901234, "fid_deep": float("inf"), "n_eval": 32},
    ]


def test_csv_writer_writes_what_pandas_writes(tmp_path):
    cols = ["num_steps", "model", "ssim_mean", "ssim_n", "lpips", "fid_simple", "fid_deep",
            "n_eval"]
    TB.write_csv(tmp_path / "t.csv", _rows(), cols)
    pd.DataFrame(_rows())[cols].to_csv(tmp_path / "p.csv", index=False)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()
    back = pd.read_csv(tmp_path / "t.csv")
    assert list(back.columns) == cols
    assert dict(back.dtypes) == dict(pd.read_csv(tmp_path / "p.csv").dtypes)


def test_figures_without_matplotlib_warn_once_each_and_the_report_is_written(tmp_path,
                                                                              monkeypatch,
                                                                              caplog):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    results = {
        "base_model": [{"num_steps": s, "time_per_image": 0.01 * s, "images_per_second": 100 / s}
                       for s in (1, 2)],
        "rectified_model": [{"num_steps": s, "time_per_image": 0.008 * s,
                             "images_per_second": 125 / s} for s in (1, 2)],
    }
    logging.getLogger("flow_vision").propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            TV.create_summary_report(results, str(tmp_path))
            TV.plot_generated_samples(np.zeros((4, 8, 8, 3)), save_path=str(tmp_path / "g.png"),
                                      data_format="NHWC")
            TV.plot_trajectory_comparison([np.zeros((1, 8, 8, 3))] * 2,
                                          [np.zeros((1, 8, 8, 3))] * 2,
                                          save_path=str(tmp_path / "t.png"), data_format="NHWC")
            TV.plot_quality_vs_speed({}, save_path=str(tmp_path / "q.png"))
    finally:
        logging.getLogger("flow_vision").propagate = False
    warned = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warned) == 4
    for name in ("speed_comparison.png", "g.png", "t.png", "q.png"):
        assert sum(name in w for w in warned) == 1, name
        assert not (tmp_path / name).exists()
    report = (tmp_path / "benchmark_report.txt").read_text()
    assert "Average speedup: 1.25x" in report


def test_figures_with_matplotlib_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    jv = importlib.import_module("rectified_flow_vision_tpu.utils.visualization")
    samples = np.random.default_rng(0).uniform(-1, 1, (4, 3, 8, 8))
    TV.plot_generated_samples(samples, save_path=str(tmp_path / "t.png"))
    jv.plot_generated_samples(samples, save_path=str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").stat().st_size > 0 and (tmp_path / "j.png").exists()
