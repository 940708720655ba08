"""Guards on the port's boundaries: no JAX inside it, no silent CPU or plain
fallback for the CUDA kernels, CUDA by default."""

import ast
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

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
        "gn_silu", "conv3x3", "attention_block", "gn_silu_dropout", "gn_silu_backward",
        "dropout_mask_apply",
        "flash_attention", "flash_attention_backward", "dropout",
    }
    text = "".join((PORT / "ops" / "csrc" / name).read_text() for name in build.SOURCES)
    for entry in build._SIGNATURES:
        assert f"int {entry}(" in text, entry


@pytest.mark.parametrize(
    "trainer,option,item",
    [
        ("base", dict(mesh=object()), "A9"),
        ("base", dict(fsdp=True), "A9"),
        ("base", dict(resume_dir="state"), "A7"),
        ("base", dict(use_native_loader=True), "A4"),
        ("reflow", dict(mesh=object()), "A9"),
        ("reflow", dict(fsdp=True), "A9"),
        ("reflow", dict(resume_dir="state"), "A7"),
        ("dit", dict(mesh=object()), "A9"),
        ("dit", dict(seq_axis="seq"), "A9"),
        ("dit", dict(pipeline_apply=True), "A9"),
    ],
    ids=lambda v: v if isinstance(v, str) else "-".join(v),
)
def test_unported_trainer_options_raise_and_name_their_roadmap_item(trainer, option, item):
    """What a later slice brings raises now, before any work, and says where
    ROADMAP.md holds it; nothing is silently ignored."""
    import numpy as np

    from rectified_flow_vision_tpu_torch.models import (
        DiT,
        RectifiedFlowModel,
        train_base_flow,
        train_rectified_flow,
    )

    model = RectifiedFlowModel(
        image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1, device="cpu"
    )
    x = np.zeros((2, 8, 8, 3), np.float32)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md item {item}"):
        if trainer == "base":
            train_base_flow(model, [x], epochs=1, **option)
        elif trainer == "reflow":
            train_rectified_flow(model, x, x, epochs=1, data_format="NHWC", **option)
        else:
            dit = DiT(input_size=8, hidden_size=32, depth=1, num_heads=2)
            lat, t = torch.zeros((1, 8, 8, 4)), torch.zeros((1,))
            if "pipeline_apply" in option:
                dit.pipeline_apply(lat, t, object())
            else:
                dit(lat, t, **option)
    # the item exists in ROADMAP.md section A, found by its bold label (the
    # list's numbering changes whenever the roadmap is re-ordered)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    section_a = roadmap.split("\n### A.", 1)[1].split("\n### B.", 1)[0]
    assert re.search(rf"\*\*{item}\b", section_a), item


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
