"""The port's LPIPS (AlexNet) and InceptionV3 networks against the JAX
package's, on the CPU, with seeded synthetic weights (pretrained weight files
are not in the repo).

Tolerances: LPIPS distances, ``fid_features`` and ``pairwise_distance`` rtol
1e-4 (atol 1e-6; measured: about 1e-6 relative, fp32 convs summed in other
orders); InceptionV3 pool3 features rtol 1e-4 / atol 1e-5 at 32x32, 64x64
and 320x320 input (the resize to 299 enlarges the first two and shrinks the
third; measured about 1.3e-6 absolute on features up to 4); the 299x299
resize itself atol 1e-4 against ``jax.image.resize`` (measured 2.4e-5 when
shrinking, 2e-6 when enlarging: the antialiasing kernel's weights are
rounded differently); ``MetricsCalculator``'s LPIPS statistics and FIDs on
these networks rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.utils import inception_jax as JI
from rectified_flow_vision_tpu.utils import lpips_jax as JL
from rectified_flow_vision_tpu.utils import metrics as JM
from rectified_flow_vision_tpu_torch.utils import inception as TI
from rectified_flow_vision_tpu_torch.utils import lpips as TL
from rectified_flow_vision_tpu_torch.utils import metrics as TM


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lpips_weights(seed=0):
    """``tests/test_lpips.py``'s ``_synthetic_weights``."""
    rng = np.random.default_rng(seed)
    w = {}
    in_ch = 3
    for i, (k, s, p, out_ch, _) in enumerate(JL._ALEX_LAYERS):
        w[f"conv{i}_w"] = rng.normal(0, 0.1, (k, k, in_ch, out_ch)).astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.01, (out_ch,)).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, (out_ch,)).astype(np.float32)
        in_ch = out_ch
    return w


def _images(n, size, seed):
    return np.random.default_rng(seed).normal(0, 0.5, (n, 3, size, size)).astype(
        np.float32).clip(-1, 1)


@pytest.fixture(scope="module")
def lpips_pair():
    w = _lpips_weights()
    return JL.LPIPS(w), TL.LPIPS(w, "cpu")


@pytest.fixture(scope="module")
def inception_pair():
    return JI.InceptionV3Features(JI.synthetic_weights(0)), TI.InceptionV3Features(
        TI.synthetic_weights(0), "cpu")


class TestLPIPS:
    def test_layers_and_constants_are_the_jax_modules(self):
        assert TL._ALEX_LAYERS == JL._ALEX_LAYERS
        np.testing.assert_array_equal(np.float32(TL._SHIFT), JL._SHIFT)
        np.testing.assert_array_equal(np.float32(TL._SCALE), JL._SCALE)

    @pytest.mark.parametrize("size", [64, 32])
    def test_distances_match(self, lpips_pair, size):
        j, t = lpips_pair
        a, b = _images(3, size, 0), _images(3, size, 1)
        np.testing.assert_allclose(t(a, b), j(a, b), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(t(a, a), 0.0, atol=1e-6)

    def test_fid_features_match(self, lpips_pair):
        j, t = lpips_pair
        a = _images(3, 64, 2)
        got, want = t.fid_features(a), j.fid_features(a)
        assert got.shape == (3, 256)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    def test_pairwise_distance_matches(self, lpips_pair):
        j, t = lpips_pair
        a, b = _images(3, 64, 3), _images(2, 64, 4)
        got = t.pairwise_distance(a, b)
        assert got.shape == (3, 2)
        np.testing.assert_allclose(got, j.pairwise_distance(a, b), rtol=1e-4, atol=1e-6)
        # the Gram identity is the paired distance on the diagonal
        np.testing.assert_allclose(np.diag(t.pairwise_distance(a[:2], b)), t(a[:2], b),
                                   rtol=1e-4, atol=1e-6)


class TestInception:
    def test_specs_and_synthetic_weights_are_the_jax_modules(self):
        assert TI.CONV_SPECS == JI.CONV_SPECS
        assert TI.FEATURE_DIM_IN == JI.FEATURE_DIM_IN == 2048
        tw, jw = TI.synthetic_weights(0), JI.synthetic_weights(0)
        assert tw.keys() == jw.keys()
        for k in jw:
            np.testing.assert_array_equal(tw[k], jw[k])

    @pytest.mark.parametrize("size", [32, 64, 320])
    def test_resize_299_matches_jax_image_resize(self, size):
        x = _images(2, size, size)
        want = jax.image.resize(jnp.transpose(x, (0, 2, 3, 1)), (2, 299, 299, 3), "bilinear")
        got = TI.resize_299(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)

    @pytest.mark.parametrize("size", [32, 64, 320])
    def test_features_match(self, inception_pair, size):
        j, t = inception_pair
        x = _images(2, size, 10 + size)
        got = t(x)
        assert got.shape == (2, 2048) and np.isfinite(got).all()
        np.testing.assert_allclose(got, j(x), rtol=1e-4, atol=1e-5)


def test_load_default_returns_the_networks_when_their_files_exist(tmp_path, monkeypatch):
    """With a weight file present, load_default loads it (rather than raising)
    and the network computes what one built from the arrays does."""
    np.savez(tmp_path / "lpips.npz", **_lpips_weights(1))
    np.savez(tmp_path / "inception.npz", **TI.synthetic_weights(1))
    monkeypatch.setattr(TL, "DEFAULT_WEIGHTS_PATH", tmp_path / "lpips.npz")
    monkeypatch.setattr(TI, "DEFAULT_WEIGHTS_PATH", tmp_path / "inception.npz")
    lp = TL.LPIPS.load_default("cpu")
    inc = TI.InceptionV3Features.load_default("cpu")
    a, b = _images(2, 32, 5), _images(2, 32, 6)
    np.testing.assert_array_equal(lp(a, b), TL.LPIPS(_lpips_weights(1), "cpu")(a, b))
    np.testing.assert_array_equal(inc(a), TI.InceptionV3Features(TI.synthetic_weights(1),
                                                                 "cpu")(a))


def test_metrics_calculator_takes_the_networks_as_the_jax_one_does(tmp_path, monkeypatch):
    """With both weight files present, each calculator prefers LPIPS and
    InceptionV3 over SynthNet, and the port's LPIPS, its set statistics,
    the deep FID and the Inception FID match the JAX calculator's."""
    np.savez(tmp_path / "lpips.npz", **_lpips_weights())
    np.savez(tmp_path / "inception.npz", **JI.synthetic_weights(0))
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "DEFAULT_WEIGHTS_PATH", tmp_path / "lpips.npz")
    for mod in (TI, JI):
        monkeypatch.setattr(mod, "DEFAULT_WEIGHTS_PATH", tmp_path / "inception.npz")
    t, j = TM.MetricsCalculator("cpu"), JM.MetricsCalculator()
    assert isinstance(t.lpips_model, TL.LPIPS) and isinstance(j.lpips_model, JL.LPIPS)
    assert isinstance(t.inception_model, TI.InceptionV3Features)
    assert isinstance(j.inception_model, JI.InceptionV3Features)

    real, gen = _images(6, 32, 7), _images(6, 32, 8)
    np.testing.assert_allclose(t.compute_lpips(real, gen), j.compute_lpips(real, gen),
                               rtol=1e-4)
    ts, js = t.compute_lpips_set_stats(real, gen, n_boot=8), j.compute_lpips_set_stats(
        real, gen, n_boot=8)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(t.compute_fid_deep(real, gen), j.compute_fid_deep(real, gen),
                               rtol=1e-4)
    np.testing.assert_allclose(t.compute_fid_inception(real, gen),
                               j.compute_fid_inception(real, gen), rtol=1e-4)
