"""The rest of the port's public API against the JAX package, on the CPU.

* ``utils.pt_import.export_pt_checkpoint``: the same ``.pt`` as the JAX
  export for the same weights (every tensor and the config exactly), and the
  import round trip of ``tests/test_pt_import.py``'s ``TestPtRoundTrip``;
* ``MetricsCalculator.compute_generation_speed`` / ``benchmark_models``:
  the JAX result's keys, the number of sampler calls (one warm-up, then
  ceil(n / batch) per run), batch 4 on the CPU;
* ``utils.download_data.main``: the JAX CLI's flag;
* ``utils.visualization.setup_plot_style``: the JAX style's rcParams;
* ``utils.profiling``: ``nan_check`` raises where an op produces a NaN and
  restores the previous state, ``annotate`` spans appear by name in
  ``trace()``'s ``trace.json``, and ``device_memory_stats()`` is empty
  without a card.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.utils import pt_import as JPT
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.utils import download_data as TDD
from rectified_flow_vision_tpu_torch.utils import metrics as TM
from rectified_flow_vision_tpu_torch.utils import profiling as TP
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

SMALL = dict(image_size=16, model_channels=16, channel_mult=[1, 2], num_res_blocks=2,
             sample_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jm = JBase(**SMALL)
    tm = BaseFlowModel(device="cpu", params=jax.tree_util.tree_map(np.asarray, jm.params),
                       **SMALL)
    return jm, tm


class TestExportPt:
    def test_export_is_the_jax_export(self, models, tmp_path):
        jm, tm = models
        JPT.export_pt_checkpoint(jm, tmp_path / "jax.pt")
        TPT.export_pt_checkpoint(tm, tmp_path / "torch.pt")
        want = torch.load(tmp_path / "jax.pt", weights_only=True)
        got = torch.load(tmp_path / "torch.pt", weights_only=True)
        assert got["config"] == want["config"] == {"image_size": 16, "in_channels": 3}
        assert got["state_dict"].keys() == want["state_dict"].keys()
        for k, v in want["state_dict"].items():
            assert got["state_dict"][k].dtype == v.dtype
            assert torch.equal(got["state_dict"][k], v), k

    def test_export_import_identity(self, models, tmp_path):
        _, tm = models
        path = tmp_path / "model.pt"
        TPT.export_pt_checkpoint(tm, path)
        params, config = TPT.import_pt_checkpoint(path)
        assert config["image_size"] == 16
        assert config["model_channels"] == 16
        assert config["channel_mult"] == [1, 2]
        assert config["num_res_blocks"] == 2
        for a, b in zip(jax.tree_util.tree_leaves(tm.params), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_model_load_pt_dispatch(self, models, tmp_path):
        """``load`` takes the exported ``.pt`` and samples as the original."""
        _, tm = models
        path = tmp_path / "model.pt"
        TPT.export_pt_checkpoint(tm, path)
        fresh = BaseFlowModel(device="cpu", seed=99, **SMALL)
        fresh.load(str(path))
        noise = np.random.randn(1, 3, 16, 16).astype(np.float32)
        np.testing.assert_allclose(fresh.sample(noise=noise, num_steps=2).numpy(),
                                   tm.sample(noise=noise, num_steps=2).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_from_checkpoint_pt(self, models, tmp_path):
        _, tm = models
        path = tmp_path / "model.pt"
        TPT.export_pt_checkpoint(tm, path)
        m2 = BaseFlowModel.from_checkpoint(str(path), device="cpu", sample_dtype="float32")
        assert m2.velocity_net.model_channels == 16


class TestGenerationSpeed:
    def test_keys_and_sampler_calls(self, models, monkeypatch):
        _, tm = models
        calls = []
        orig = BaseFlowModel.sample

        def spy(self, noise=None, num_steps=100, **kw):
            calls.append((tuple(noise.shape), num_steps, kw.get("data_format")))
            return orig(self, noise=noise, num_steps=num_steps, **kw)

        monkeypatch.setattr(BaseFlowModel, "sample", spy)
        out = TM.MetricsCalculator("cpu").compute_generation_speed(
            tm, num_samples=10, num_steps=2, num_runs=2, image_size=16)
        # the JAX result's keys
        assert set(out) == {"total_time", "time_per_image", "images_per_second", "time_std",
                            "num_steps", "num_samples"}
        assert (out["num_steps"], out["num_samples"]) == (2, 10)
        assert out["total_time"] > 0 and out["images_per_second"] == pytest.approx(
            10 / out["total_time"])
        # batch 4 on the CPU: one warm-up, then ceil(10 / 4) = 3 calls a run
        assert calls == [((4, 16, 16, 3), 2, "NHWC")] * (1 + 2 * 3)

    def test_benchmark_models(self, models, monkeypatch, capsys):
        _, tm = models
        res = TM.benchmark_models(tm, tm, [1, 2], num_samples=4, image_size=16, device="cpu")
        assert [r["num_steps"] for r in res["base_model"]] == [1, 2]
        assert {r["model"] for r in res["rectified_model"]} == {"rectified"}
        assert "BENCHMARK: Base Model vs Rectified Model" in capsys.readouterr().out


@pytest.mark.parametrize("argv,online", [([], True), (["--offline"], False)])
def test_download_data_main_is_the_jax_cli(argv, online, monkeypatch):
    import importlib

    # the JAX package's utils/__init__ binds the name to the function
    JDD = importlib.import_module("rectified_flow_vision_tpu.utils.download_data")
    seen = []
    for mod in (TDD, JDD):
        monkeypatch.setattr(mod, "download_data", lambda use_online: seen.append(use_online))
    TDD.main(argv)
    monkeypatch.setattr("sys.argv", ["download_data"] + argv)
    JDD.main()
    assert seen == [online, online]


def test_setup_plot_style_is_the_jax_style():
    import matplotlib

    from rectified_flow_vision_tpu.utils import visualization as JV
    from rectified_flow_vision_tpu_torch.utils import visualization as TV

    keys = ("figure.figsize", "font.size", "axes.labelsize", "axes.titlesize",
            "axes.grid", "axes.facecolor")
    with matplotlib.rc_context():
        JV.setup_plot_style()
        want = {k: matplotlib.rcParams[k] for k in keys}
    with matplotlib.rc_context():
        plt = TV.setup_plot_style()
        assert {k: matplotlib.rcParams[k] for k in keys} == want
        assert plt.get_backend().lower() == "agg"


class TestProfiling:
    def test_nan_check_raises_where_a_nan_is_produced(self):
        x = torch.tensor([1.0, -1.0])
        assert torch.isnan(torch.log(x)).any()  # off by default
        with pytest.raises(FloatingPointError, match="log"):
            with TP.nan_check():
                torch.log(x)
        with TP.nan_check():
            torch.log(torch.tensor([1.0, 2.0]))  # no NaN, no raise
            torch.empty(1 << 12)  # uninitialised memory is no NaN produced
            with TP.nan_check(False):
                torch.log(x)  # turned off for the inner body
            with pytest.raises(FloatingPointError):
                torch.sqrt(x)
        torch.log(x)  # the previous state is back
        assert not torch.is_anomaly_enabled()

    def test_nan_check_covers_the_backward(self):
        w = torch.tensor([0.0], requires_grad=True)
        with pytest.raises((FloatingPointError, RuntimeError)):
            with TP.nan_check():
                (torch.sqrt(w) * 0.0).sum().backward()

    def test_annotate_spans_appear_in_the_trace(self, tmp_path):
        with TP.trace(str(tmp_path)):
            with TP.annotate("rfv_test_span"):
                torch.ones(8).sum()
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        assert any(e.get("name") == "rfv_test_span" for e in events)

    def test_device_memory_stats_is_empty_without_a_card(self):
        stats = TP.device_memory_stats()
        if torch.cuda.is_available():  # the card's run reads it in chip_smoke.py
            assert set(stats) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}
        else:
            assert stats == {}
