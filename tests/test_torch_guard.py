"""Guards on the port's boundaries: no JAX inside it, no silent CPU or plain
fallback for the CUDA kernels, CUDA by default."""

import ast
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "rectified_flow_vision_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "rectified_flow_vision_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_import_leaves_jax_out():
    """Importing the port in a fresh interpreter loads neither JAX nor the
    JAX package."""
    code = (
        "import sys, rectified_flow_vision_tpu_torch as m\n"
        "import rectified_flow_vision_tpu_torch.serving\n"
        "import rectified_flow_vision_tpu_torch.main\n"
        "import rectified_flow_vision_tpu_torch.experiments.benchmark\n"
        "import rectified_flow_vision_tpu_torch.experiments.train_rectified\n"
        "import rectified_flow_vision_tpu_torch.data.native_loader\n"
        "import rectified_flow_vision_tpu_torch.utils.profiling\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'rectified_flow_vision_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path.name} imports {mod}"


def test_build_without_nvcc_raises_and_names_it(monkeypatch, tmp_path):
    """Without nvcc the kernel build raises a clear error; nothing falls back."""
    from rectified_flow_vision_tpu_torch.ops import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()
    assert build._lib is None


def test_kernel_sources_are_listed():
    """Every CUDA source in the package is compiled into the library."""
    from rectified_flow_vision_tpu_torch.ops import build

    on_disk = {p.name for p in (PORT / "ops" / "csrc").glob("*.cu")}
    assert on_disk == set(build.SOURCES)
    assert {"gn_silu_dropout.cu", "flash_attention.cu", "dropout.cu"} <= set(build.SOURCES)
    # every kernel has a launch counter and every C entry point a signature
    assert set(build.LAUNCHES) == {
        "gn_silu", "gn_silu_streamed", "conv3x3", "attention_block", "gn_silu_dropout",
        "gn_silu_backward",
        "dropout_mask_apply",
        "flash_attention", "flash_attention_backward", "dropout",
        "ln_modulate", "bias_act", "gated_residual", "qk_norm_rope",
    }
    text = "".join((PORT / "ops" / "csrc" / name).read_text() for name in build.SOURCES)
    for entry in build._SIGNATURES:
        assert f"int {entry}(" in text, entry


@pytest.mark.parametrize(
    "trainer,option,item",
    [
        ("base", dict(mesh=True), "A9"),
        ("base", dict(fsdp=True), "A9"),
        ("reflow", dict(mesh=True), "A9"),
        ("reflow", dict(fsdp=True), "A9"),
        ("dit", dict(mesh=True), "A9"),
        ("dit", dict(seq_axis="seq"), "A9"),
        ("dit", dict(pipeline_apply=True), "A9"),
    ],
    ids=lambda v: v if isinstance(v, str) else "-".join(v),
)
def test_unported_trainer_options_raise_and_name_their_roadmap_item(
        trainer, option, item, tmp_path):
    """The options that raised until their ROADMAP item was ported now run:
    each on a process group of this process alone (gloo, on the CPU) and a
    one-rank mesh, matching the result without them. The item is recorded as
    ported in ROADMAP.md section A, found by its bold label (the list's
    numbering changes whenever the roadmap is re-ordered), and so is A10, the
    last module to port: the open list holds no module to port, only A11,
    the port's benchmark."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from rectified_flow_vision_tpu_torch.models import (
        DiT,
        RectifiedFlowModel,
        train_base_flow,
        train_rectified_flow,
    )
    from rectified_flow_vision_tpu_torch.parallel.mesh import create_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
        if trainer in ("base", "reflow"):
            kw = dict(option, mesh=create_mesh(device="cpu"))
            runs = []
            for extra in (kw, {}):
                model = RectifiedFlowModel(image_size=8, model_channels=16, channel_mult=[1],
                                           num_res_blocks=1, device="cpu")
                if trainer == "base":
                    losses = train_base_flow(model, [x], epochs=1, progress=False, **extra)
                else:
                    losses = train_rectified_flow(model, x, x[::-1].copy(), epochs=1,
                                                  batch_size=2, data_format="NHWC",
                                                  progress=False, **extra)
                runs.append((losses, model.params["input_conv"]["w"]))
            assert runs[0][0] == runs[1][0]
            np.testing.assert_array_equal(runs[0][1], runs[1][1])
        else:
            dit = DiT(input_size=8, hidden_size=32, depth=2, num_heads=2)
            dit.reset_parameters(torch.Generator().manual_seed(0))
            with torch.no_grad():
                for p in dit.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
            lat = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 8, 4))
                                   .astype(np.float32))
            t = torch.tensor([0.3, 0.7])
            with torch.no_grad():
                want = dit(lat, t)
                if "pipeline_apply" in option:
                    stage = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("stage",))
                    got = dit.pipeline_apply(lat, t, stage, num_microbatches=2)
                else:
                    dims = ("seq",) if "mesh" in option else ("data", "seq")
                    mesh = DeviceMesh("cpu", torch.arange(1).reshape((1,) * len(dims)),
                                      mesh_dim_names=dims)
                    got = dit(lat, t, mesh=mesh, seq_axis="seq")
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    finally:
        dist.destroy_process_group()
    roadmap = (ROOT / "ROADMAP.md").read_text()
    section_a = roadmap.split("\n### A.", 1)[1].split("\n### B.", 1)[0]
    ported, still_open = section_a.split("\n1. ", 1)
    assert re.search(rf"\*\*{item}\b", ported), item
    assert re.search(r"\*\*A10\b", ported)
    assert re.findall(r"\*\*(A\d+)\b", still_open) == ["A11"]


@pytest.mark.parametrize("site", ["gn_silu_dropout_channels", "attention_heads", "row_conv",
                                  "row_conv_slice_of_32", "col_conv_slice_of_32",
                                  "conv_slice_of_8"])
def test_tensor_parallel_sites_take_the_kernel_or_raise(site, monkeypatch):
    """The tensor-parallel forms of the kernel sites (a rank's channel slice
    of the dropout mask, a rank's heads without the residual, a row-parallel
    conv without its bias, a rank's 32 of a site's 64 input or output
    channels) never take a plain version or a library call off the CPU: on a
    device without the kernels (``meta``) they raise for want of CUDA, and a
    slice narrower than the conv kernel takes (8 of 64 channels) raises for
    its shape. (Without ``RFV_CONV_WINOGRAD``: with it the convs take the
    Winograd conv, below.)"""
    from rectified_flow_vision_tpu_torch.ops import fused

    monkeypatch.delenv("RFV_CONV_WINOGRAD", raising=False)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    x, s = meta(1, 8, 8, 64), meta(64)
    with pytest.raises(ValueError, match="not supported" if site == "conv_slice_of_8" else "CUDA"):
        if site == "gn_silu_dropout_channels":
            fused.gn_silu_dropout(x, s, s, 0.1, 7, train=True, num_groups=4, channels=(64, 128))
        elif site == "attention_heads":
            fused.attention(x, s, s, meta(96, 64), meta(96), meta(64, 32), s, num_heads=2,
                            residual=False)
        elif site == "row_conv":
            fused.conv2d_fused(x, meta(64, 3, 3, 64), s)
        elif site == "row_conv_slice_of_32":
            fused.conv2d_fused(meta(1, 8, 8, 32), meta(64, 3, 3, 32), s, shards=(2, 1))
        elif site == "col_conv_slice_of_32":
            fused.conv2d_fused(x, meta(32, 3, 3, 64), meta(32), shards=(1, 2))
        else:
            fused.conv2d_fused(meta(1, 8, 8, 8), meta(64, 3, 3, 8), s, shards=(8, 1))


# conv2d_fused calls: (x shape, OHWI weight shape, stride, shards), and
# whether the JAX gate's conditions hold (stride 1, 3x3, even H and W; any
# channels)
GATED_CONVS = {
    "conv": ((1, 8, 8, 64), (64, 3, 3, 64), 1, (1, 1), True),
    "row_conv_slice_of_32": ((1, 8, 8, 32), (64, 3, 3, 32), 1, (2, 1), True),
    "col_conv_slice_of_32": ((1, 8, 8, 64), (32, 3, 3, 64), 1, (1, 2), True),
    "conv_slice_of_8": ((1, 8, 8, 8), (64, 3, 3, 8), 1, (8, 1), True),
    "conv_outside_the_kernel": ((1, 6, 10, 3), (24, 3, 3, 3), 1, (1, 1), True),
    "stride_2": ((1, 8, 8, 64), (64, 3, 3, 64), 2, (1, 1), False),
    "one_by_one": ((1, 8, 8, 64), (64, 1, 1, 64), 1, (1, 1), False),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("site", list(GATED_CONVS))
def test_winograd_gate_takes_every_qualifying_conv(site, device, monkeypatch):
    """With ``RFV_CONV_WINOGRAD`` set, a conv that meets the JAX gate's
    conditions reaches ``winograd_conv3x3`` on every device, a tensor-parallel
    slice included, whatever its channels; any other conv does not."""
    from rectified_flow_vision_tpu_torch.ops import fused
    from rectified_flow_vision_tpu_torch.ops import winograd as W

    x_shape, w_shape, stride, shards, gated = GATED_CONVS[site]
    calls = []
    real = W.winograd_conv3x3
    monkeypatch.setattr(W, "winograd_conv3x3",
                        lambda x, w, b: calls.append(x.device.type) or real(x, w, b))
    monkeypatch.setenv("RFV_CONV_WINOGRAD", "1")
    x, w, b = (torch.zeros(shape, device=device) for shape in (x_shape, w_shape, w_shape[:1]))
    out = fused.conv2d_fused(x, w, b, stride=stride, shards=shards)
    assert calls == ([device] if gated else [])
    assert out.shape[-1] == w_shape[0] and out.device.type == device
    if gated:
        assert tuple(out.shape) == x_shape[:3] + w_shape[:1]


def test_dryrun_under_torchrun_without_a_card_raises(monkeypatch):
    """Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) the dry run is the
    cards': without one it raises before it joins a group, and it never runs
    on the CPU by itself; ``dryrun`` defaults to the card."""
    from rectified_flow_vision_tpu_torch.parallel import dryrun as DR
    from rectified_flow_vision_tpu_torch.parallel import mesh as M

    def never(*args, **kwargs):
        raise AssertionError("the dry run went on without a card")

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["dryrun"])
    for module, name in ((DR, "dryrun"), (DR, "dryrun_multichip"),
                         (M, "maybe_init_distributed")):
        monkeypatch.setattr(module, name, never)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.main()
    monkeypatch.undo()
    assert inspect.signature(DR.dryrun).parameters["device"].default == "cuda"


def _native_corpus(tmp_path):
    from rectified_flow_vision_tpu_torch.data import ImageDataset
    from rectified_flow_vision_tpu_torch.utils.download_data import generate_synthetic_images

    generate_synthetic_images(str(tmp_path / "img"), 8, 8, seed=0)
    return ImageDataset(tmp_path / "img", 8)


def _tiny_model():
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    return BaseFlowModel(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
                         device="cpu")


def test_use_native_loader_takes_the_native_loader(tmp_path, monkeypatch):
    """``use_native_loader`` (no longer a raise) trains on the C++ loader's
    batches when its library builds."""
    from rectified_flow_vision_tpu_torch.data import native_loader
    from rectified_flow_vision_tpu_torch.models import train_base_flow

    if not native_loader.native_available():
        pytest.skip("no C++ compiler to build the native loader's library")
    epochs = []
    real_epoch = native_loader.NativeBatchLoader.epoch

    def spy(self, epoch):
        epochs.append(epoch)
        return real_epoch(self, epoch)

    monkeypatch.setattr(native_loader.NativeBatchLoader, "epoch", spy)
    losses = train_base_flow(_tiny_model(), _native_corpus(tmp_path), epochs=2, batch_size=4,
                             use_native_loader=True, progress=False)
    assert epochs == [0, 1] and len(losses) == 2 and np.isfinite(losses).all()


def test_use_native_loader_without_its_library_warns_and_uses_python_batches(
        tmp_path, monkeypatch, caplog):
    import logging

    from rectified_flow_vision_tpu_torch.data import native_loader
    from rectified_flow_vision_tpu_torch.models import train_base_flow

    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    data = _native_corpus(tmp_path)
    calls = []
    real_batches = type(data).batches
    monkeypatch.setattr(type(data), "batches",
                        lambda self, *a, **k: calls.append(1) or real_batches(self, *a, **k))
    logging.getLogger("flow_vision").propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            losses = train_base_flow(_tiny_model(), data, epochs=1, batch_size=4,
                                     use_native_loader=True, progress=False)
    finally:
        logging.getLogger("flow_vision").propagate = False
    assert calls == [1] and np.isfinite(losses).all()
    assert any("native loader requested but unavailable" in r.getMessage()
               for r in caplog.records)


def test_pipeline_entry_points_default_to_cuda():
    from rectified_flow_vision_tpu_torch import main as cli
    from rectified_flow_vision_tpu_torch.experiments import benchmark, train_base, train_rectified
    from rectified_flow_vision_tpu_torch.utils.metrics import MetricsCalculator
    from rectified_flow_vision_tpu_torch.utils.synthnet import SynthNetPerceptual

    for entry in (cli.main, train_base.main, train_base.build_model, train_rectified.main,
                  benchmark.main, MetricsCalculator, SynthNetPerceptual.load_default):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry


def test_cli_without_a_card_raises_before_any_step(tmp_path):
    """``main()`` on the command line is the card's: without one it raises
    and writes nothing; it does not run on the CPU."""
    from rectified_flow_vision_tpu_torch.config import Config
    from rectified_flow_vision_tpu_torch.main import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config()
    cfg.data.data_dir = str(tmp_path / "data")
    cfg.paths.checkpoints = str(tmp_path / "ckpt")
    cfg.paths.results = str(tmp_path / "results")
    cfg.save(tmp_path / "c.yaml")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--offline", "--config", str(tmp_path / "c.yaml")])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.yaml"]


def test_entry_points_default_to_cuda():
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    for entry in (BaseFlowModel, SamplerService.from_checkpoint, ConvVAE, ConvVAE.load):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry


def test_default_device_without_a_card_raises():
    """The default entry point does not carry on on the CPU when no card is
    found."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BaseFlowModel(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1)
    with pytest.raises(RuntimeError, match="cuda"):
        BaseFlowModel(image_size=8, in_channels=4, backbone="dit", hidden_size=32, depth=1,
                      num_heads=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ConvVAE(image_size=32, base_channels=16)


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
