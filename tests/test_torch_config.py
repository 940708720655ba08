"""The port's config module against the JAX package's.

Both packages read YAML with ``yaml.safe_load`` and write it with
``yaml.dump``. Held exactly: ``load_config`` against the JAX package's field
by field on every config and on hand-written files (YAML 1.1 scalars,
comments, unknown sections and keys, anchors, flow mappings, malformed
YAML), ``quick_overlay`` likewise, and ``save`` against the JAX package's
text and both loaders.
"""

import dataclasses
from pathlib import Path

import pytest
import yaml

from rectified_flow_vision_tpu import config as JC
from rectified_flow_vision_tpu_torch import config as TC

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
_ids = lambda p: p.name  # noqa: E731


@pytest.mark.parametrize("path", CONFIGS + [ROOT / "configs" / "no_such_file.yaml"], ids=_ids)
def test_load_config_equals_the_jax_package(path):
    assert dataclasses.asdict(TC.load_config(path)) == dataclasses.asdict(JC.load_config(path))


@pytest.mark.parametrize(
    "text",
    [
        "training_base:\n  learning_rate: 1e-4",       # no dot: a string in YAML 1.1
        "training_base:\n  learning_rate: 1.0e-4",
        "training_base:\n  learning_rate: 1.5e3",      # no exponent sign: a string
        "training_base:\n  learning_rate: 0.0002  # trailing comment",
        "training_base:\n  learning_rate: .5\n  warmup_epochs: -.5",
        "training_base:\n  learning_rate: .inf\n  warmup_epochs: -.Inf",
        "paths:\n  results: '#'",
        'paths:\n  results: "a # b"',
        "paths:\n  results: x#y",
        "paths:\n  results: 'it''s'\n  figures: \"tab\\tnewline\\n\"",
        "paths:\n  checkpoints: /tmp/a-b/c_d\n  results: http://x/y",
        "parallel:\n  data_axis: -1\n  model_axis: +7",
        "model:\n  channel_mult: [1, 2, 'x', \"y\"]\n  channels: 3",
        "model:\n  channel_mult:\n  - 1\n  - 2\n  - 8\n  channels: 4",
        "model:\n  attention_resolutions: []\n  use_pallas: null\n  backbone: ~\n  latent:",
        "metrics:\n  compute_ssim: yes\n  compute_lpips: off\n  compute_fid: False",
        "# full-line comment\n\ntraining_base:   # after a key\n  epochs: 3   # after a value\n",
        "",
        "nope:\n  a: 1\ndata:\n  not_a_field: 2\n  image_size: 32",  # unknown names
        "data: 5\nmodel: [1, 2]",                       # sections that are not maps
        "training_base:\n  epochs: 0755",
        "training_base:\n  epochs: 0x1F",
        "training_base:\n  epochs: 1_000",
        "training_base:\n  epochs: 3:20",
        "paths:\n  results: 2001-01-01",
        "data: &d\n  image_size: 16\nmodel:\n  channels: 8",
        "data: &d\n  image_size: 16\nbenchmark:\n  quality_samples: 3\nextra: *d",
        "training_base:\n  epochs: !!str 1",
        "data: {image_size: 16, num_mock_images: 3}",
        "model:\n  channel_mult: [1, [2]]",
        "--- \ndata:\n  image_size: 8",
    ],
)
def test_load_config_equals_the_jax_package_on_hand_written_files(text, tmp_path):
    (tmp_path / "c.yaml").write_text(text)
    want = dataclasses.asdict(JC.load_config(tmp_path / "c.yaml"))
    assert dataclasses.asdict(TC.load_config(tmp_path / "c.yaml")) == want


@pytest.mark.parametrize("text", ["data: b: c", "data: 'open", "data:\n\timage_size: 1"])
def test_malformed_yaml_raises_as_in_the_jax_package(text, tmp_path):
    (tmp_path / "c.yaml").write_text(text)
    for load in (TC.load_config, JC.load_config):
        with pytest.raises(yaml.YAMLError):
            load(tmp_path / "c.yaml")


@pytest.mark.parametrize("path", CONFIGS, ids=_ids)
def test_quick_overlay_equals_the_jax_package(path):
    got = TC.quick_overlay(TC.load_config(path))
    want = JC.quick_overlay(JC.load_config(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_paths_match_the_jax_package():
    assert TC.repo_root() == JC.repo_root()
    assert TC.QUICK_CONFIG_PATH == JC.QUICK_CONFIG_PATH
    assert TC.DEFAULT_CONFIG_PATH == JC.DEFAULT_CONFIG_PATH


@pytest.mark.parametrize("path", CONFIGS, ids=_ids)
def test_save_round_trips_through_both_loaders(path, tmp_path):
    cfg = TC.quick_overlay(TC.load_config(path))
    cfg.paths.results = str(tmp_path / "abs path" / "it's")  # needs quoting
    cfg.data.data_dir = "yes"  # a string that plain YAML would read as a bool
    out = tmp_path / "saved.yaml"
    cfg.save(out)
    assert yaml.safe_load(out.read_text()) == cfg.to_dict()
    assert dataclasses.asdict(TC.load_config(out)) == cfg.to_dict()
    # the JAX package reads the port's file to the same config
    assert dataclasses.asdict(JC.load_config(out)) == cfg.to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=_ids)
def test_save_writes_the_jax_package_text(path, tmp_path):
    TC.load_config(path).save(tmp_path / "t.yaml")
    JC.load_config(path).save(tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
