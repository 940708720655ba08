"""The port's data path against the JAX package's and PIL, exactly.

* ``synthesize_image`` gives the JAX package's pixels bit for bit;
* ``load_image`` decodes (and resizes) PNG and JPEG files of every PIL mode
  to the JAX package's arrays;
* ``generate_synthetic_images``, ``ImageDataset`` and
  ``eval_reference_images`` give the JAX package's decoded corpus, and
  PNG files of the same pixels;
* ``pack_corpus`` writes the JAX package's bytes and ``PackedCorpus`` its
  batches; the native loader gives its batches, and without its library
  both trainers warn and train on Python batches.
"""

import importlib
import logging

import numpy as np
import pytest
from PIL import Image

from rectified_flow_vision_tpu import config as JC
from rectified_flow_vision_tpu.data import dataset as JD
from rectified_flow_vision_tpu.data import native_loader as JNL
from rectified_flow_vision_tpu.data import packed as JP
from rectified_flow_vision_tpu_torch import config as TC
from rectified_flow_vision_tpu_torch.data import dataset as TD
from rectified_flow_vision_tpu_torch.data import native_loader as TNL
from rectified_flow_vision_tpu_torch.data import packed as TP
from rectified_flow_vision_tpu_torch.utils import download_data as TDL

# the JAX package's utils/__init__ binds download_data to the function
JDL = importlib.import_module("rectified_flow_vision_tpu.utils.download_data")


@pytest.mark.parametrize("size", [32, 64, 256])
@pytest.mark.parametrize("seed", [0, 1, 7, 4242])
def test_synthesize_image_is_bit_identical(size, seed):
    a = np.random.default_rng(seed)
    b = np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(TDL.synthesize_image(a, size), JDL.synthesize_image(b, size))
    # the streams stay in step
    assert a.integers(0, 2**31) == b.integers(0, 2**31)


def _smooth(shape, seed):
    """Smooth-ish pixels, so encoders pick every filter type."""
    r = np.random.default_rng(seed)
    base = np.cumsum(r.integers(0, 9, shape), axis=1) + 3 * np.arange(shape[0])[:, None, None]
    return (base % 256).astype(np.uint8)


@pytest.mark.parametrize("size", [16, 32, 48])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_load_image_equals_the_jax_package(tmp_path, mode, size):
    """The decode, the RGB conversion, and PIL's BILINEAR resize where the
    size differs (32 is the files' own)."""
    img = Image.fromarray(_smooth((32, 32, 4), 9), "RGBA")
    img = img.convert("RGB").convert("P") if mode == "P" else img.convert(mode)
    img.save(tmp_path / "a.png", optimize=True)
    img.convert("RGB" if mode in ("RGBA", "P") else mode).save(tmp_path / "a.jpg", quality=90)
    for name in ("a.png", "a.jpg"):
        np.testing.assert_array_equal(TD.load_image(tmp_path / name, size),
                                      JD.load_image(tmp_path / name, size))


@pytest.mark.parametrize("size", [16, 32, 64])
def test_generated_corpus_equals_the_jax_package(tmp_path, size):
    TDL.generate_synthetic_images(str(tmp_path / "t"), 9, size, seed=3, start_index=2)
    JDL.generate_synthetic_images(str(tmp_path / "j"), 9, size, seed=3, start_index=2)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names[0] == "image_0002.png"
    t = TD.ImageDataset(tmp_path / "t", size)
    j = JD.ImageDataset(tmp_path / "j", size)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.images_u8, j.images_u8)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_eval_reference_images_equal_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setattr(TC, "repo_root", lambda: tmp_path / "t")
    monkeypatch.setattr(JC, "repo_root", lambda: tmp_path / "j")
    t = TD.eval_reference_images(16, 10)
    j = JD.eval_reference_images(16, 10)
    assert t.shape == (10, 16, 16, 3)
    np.testing.assert_array_equal(t, j)
    # a larger n regenerates; earlier images stay the same
    t2 = TD.eval_reference_images(16, 12)
    np.testing.assert_array_equal(t2[:10], t)
    assert len(list((tmp_path / "t" / "data" / "eval_16").iterdir())) == 12


def test_download_data_offline_uses_the_config(tmp_path, monkeypatch):
    cfg = TC.Config()
    cfg.data.image_size, cfg.data.num_mock_images = 16, 5
    cfg.data.data_dir = str(tmp_path / "data")
    cfg.save(tmp_path / "c.yaml")
    TDL.download_data(use_online=False, config_path=str(tmp_path / "c.yaml"))
    assert sorted(p.name for p in (tmp_path / "data").iterdir()) == [
        f"image_{i:04d}.png" for i in range(5)]
    assert TD.ImageDataset(tmp_path / "data", 16).images.shape == (5, 16, 16, 3)


def test_pack_corpus_is_byte_identical_and_batches_agree(tmp_path):
    JDL.generate_synthetic_images(str(tmp_path / "img"), 11, 16, seed=5)
    n_t = TP.pack_corpus(tmp_path / "img", tmp_path / "t.rfvc", 16, chunk=4)
    n_j = JP.pack_corpus(tmp_path / "img", tmp_path / "j.rfvc", 16, chunk=4)
    assert n_t == n_j == 11
    assert (tmp_path / "t.rfvc").read_bytes() == (tmp_path / "j.rfvc").read_bytes()
    t, j = TP.PackedCorpus(tmp_path / "t.rfvc"), JP.PackedCorpus(tmp_path / "j.rfvc")
    assert t.shape == j.shape and len(t) == 11 and t.num_batches(4) == j.num_batches(4)
    for drop_last in (True, False):
        tb = list(t.batches(4, seed=2, drop_last=drop_last))
        jb = list(j.batches(4, seed=2, drop_last=drop_last))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="packed corpus"):
        (tmp_path / "junk").write_bytes(b"x" * 64)
        TP.PackedCorpus(tmp_path / "junk")


@pytest.fixture
def native_lib():
    if not (TNL.native_available() and JNL.native_available()):
        pytest.skip("no C++ compiler to build the native loader's library")


def test_native_loader_gives_the_jax_packages_batches(tmp_path, native_lib):
    corpus = np.random.default_rng(0).integers(0, 256, (37, 8, 8, 3), dtype=np.uint8)
    t = TNL.NativeBatchLoader(corpus, 8, seed=3, workers=2)
    j = JNL.NativeBatchLoader(corpus, 8, seed=3, workers=2)
    try:
        assert t.batches_per_epoch == j.batches_per_epoch == 4
        for epoch in (0, 1):
            for a, b in zip(t.epoch(epoch), j.epoch(epoch)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.float32 and a.shape == (8, 8, 8, 3)
    finally:
        t.close()
        j.close()
    JDL.generate_synthetic_images(str(tmp_path / "img"), 10, 8, seed=1)
    ds = TD.ImageDataset(tmp_path / "img", 8)
    ldr = ds.native_loader(4, seed=1)
    assert ldr is not None and ldr.batches_per_epoch == 2
    ldr.close()
    assert ds.native_loader(11) is None  # larger than the corpus
    assert TD.ArrayDataset(ds.images).native_loader(4) is None


def test_without_the_library_both_packages_warn_and_use_python_batches(tmp_path, monkeypatch,
                                                                        caplog):
    """JAX's train_base_flow logs a warning and trains on Python batches when
    the native loader's library is missing; the port does the same."""
    from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
    from rectified_flow_vision_tpu.models import train_base_flow as j_train
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, train_base_flow

    monkeypatch.setattr(TNL, "native_available", lambda: False)
    monkeypatch.setattr(JNL, "native_available", lambda: False)
    JDL.generate_synthetic_images(str(tmp_path / "img"), 8, 8, seed=1)
    small = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
                 dropout=0.0)
    for name, ds, model, train in (
        ("port", TD.ImageDataset(tmp_path / "img", 8), BaseFlowModel(device="cpu", **small),
         train_base_flow),
        ("jax", JD.ImageDataset(tmp_path / "img", 8), JBase(**small), j_train),
    ):
        assert ds.native_loader(4) is None
        caplog.clear()
        logging.getLogger("flow_vision").propagate = True
        try:
            with caplog.at_level(logging.WARNING):
                losses = train(model, ds, epochs=1, batch_size=4, use_native_loader=True,
                               progress=False)
        finally:
            logging.getLogger("flow_vision").propagate = False
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert any("native loader requested but unavailable" in r.getMessage()
                   for r in caplog.records), name
