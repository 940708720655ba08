"""SynthNet's training half of the port against the JAX package, on the CPU.

The labeled and corrupted corpora are numpy in both packages and must match
bit for bit. ``train_synthnet`` is held for three AdamW steps (12 training
images at 32 and 16 pixels, batch 4: two batches at 32, one at 16, in the
JAX schedule's order) from the JAX ``init_params`` tree: every parameter
within 1e-4 (absolute and relative) of the JAX one, the validation
accuracies equal. Measured: every leaf within 8e-6 but two entries of
``s3_conv1/w`` (of 589,824) at up to 7.3e-5: Adam divides each gradient
entry by its own magnitude, so where a gradient is at the level of fp32
rounding noise, another summation order moves its entry by a share of lr
= 3e-4 per step. ``save_weights`` writes the ``.npz`` that both packages'
``load_weights`` read.
"""

import jax
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.utils import synthnet as JS
from rectified_flow_vision_tpu_torch.utils import synthnet as TS


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_level_constants_are_the_jax_modules():
    assert TS.NUM_LEVELS == JS.NUM_LEVELS
    assert TS.BLUR_SIGMAS == JS.BLUR_SIGMAS
    assert TS.NOISE_SIGMAS == JS.NOISE_SIGMAS


@pytest.mark.parametrize("size,seed", [(64, 0), (32, 5)])
def test_labeled_corpus_is_the_jax_one(size, seed):
    for got, want in zip(TS.make_labeled_corpus(6, size, seed),
                         JS.make_labeled_corpus(6, size, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,seed", [(32, 0), (16, 7)])
def test_corrupted_corpus_is_the_jax_one(size, seed):
    got, want = TS.make_corrupted_corpus(8, size, seed), JS.make_corrupted_corpus(8, size, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sigma", [0.0, 0.35, 2.45])
def test_gaussian_blur_and_corrupt_image_are_the_jax_ones(sigma):
    img = np.random.default_rng(1).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(TS.gaussian_blur(img, sigma), JS.gaussian_blur(img, sigma))
    got = TS.corrupt_image(img, np.random.default_rng(int(sigma * 100)))
    want = JS.corrupt_image(img, np.random.default_rng(int(sigma * 100)))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_apply_full_is_differentiable_and_matches_jax_gradients():
    """The loss of one labeled batch and its gradient in every leaf, against
    ``jax.grad`` of the JAX loss (atol 1e-5 of the gradient's scale)."""
    jp = JS.init_params(jax.random.key(1))
    x, c, b, nz = JS.make_corrupted_corpus(2, 32, seed=3)

    def jloss(p):
        out = JS.apply_full(p, x)

        def ce(logits, labels, k):
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -(jax.nn.one_hot(labels, k) * logp).sum(-1).mean()

        return (ce(out["counts"], c, JS.MAX_COUNT + 1) + ce(out["blur"], b, JS.NUM_LEVELS)
                + ce(out["noise"], nz, JS.NUM_LEVELS))

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: {n: torch.tensor(np.asarray(v), requires_grad=True) for n, v in sub.items()}
          for k, sub in jp.items()}
    tl, _ = TS._losses_and_metrics(tp, torch.as_tensor(x), *(torch.as_tensor(a).long()
                                                             for a in (c, b, nz)))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, sub in jg.items():
        for n, g in sub.items():
            g = np.asarray(g)
            np.testing.assert_allclose(tp[k][n].grad.numpy(), g,
                                       atol=1e-5 * max(np.abs(g).max(), 1e-3), err_msg=f"{k}/{n}")


def test_three_train_steps_match_jax():
    kw = dict(n_train=12, n_val=8, size=32, batch=4, epochs=1, lr=3e-4, seed=0, progress=False)
    want, want_metrics = JS.train_synthnet(**kw)
    init = jax.tree_util.tree_map(np.asarray, JS.init_params(jax.random.key(0)))
    got, got_metrics = TS.train_synthnet(**kw, params=init, device="cpu")
    assert got.keys() == want.keys()
    moved = 0.0
    for k, sub in want.items():
        for n, w in sub.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[k][n].numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k}/{n}")
            moved = max(moved, float(np.abs(w - init[k][n]).max()))
    assert moved > 1e-4  # the steps moved the weights beyond the tolerance
    assert got_metrics == pytest.approx(want_metrics)


def test_train_synthnet_without_params_draws_the_ports_init():
    kw = dict(n_train=12, n_val=4, size=32, batch=4, epochs=1, progress=False, device="cpu")
    a, _ = TS.train_synthnet(seed=3, **kw)
    b, _ = TS.train_synthnet(seed=3, **kw)
    for k, sub in a.items():
        assert sub.keys() == TS.init_params(torch.Generator(), device="cpu")[k].keys()
        for n, t in sub.items():
            assert torch.equal(t, b[k][n]) and torch.isfinite(t).all()


def test_train_synthnet_takes_a_tensor_tree_and_leaves_it_untouched(tmp_path):
    """A tree of tensors (``init_params``, ``load_weights``) trains as its
    numpy copy does, and the caller's tensors keep their values; with no
    tree the run starts from ``init_params`` of its seed."""
    kw = dict(n_train=12, n_val=4, size=32, batch=4, epochs=1, seed=3, progress=False,
              device="cpu")
    init = TS.init_params(torch.Generator().manual_seed(3), device="cpu")
    TS.save_weights(init, tmp_path / "init.npz")
    loaded = TS.load_weights(tmp_path / "init.npz", "cpu")
    before = {k: {n: t.clone() for n, t in sub.items()} for k, sub in loaded.items()}
    from_numpy, _ = TS.train_synthnet(
        **kw, params={k: {n: t.numpy() for n, t in sub.items()} for k, sub in init.items()})
    from_tensors, _ = TS.train_synthnet(**kw, params=loaded)
    drawn, _ = TS.train_synthnet(**kw)
    for k, sub in from_numpy.items():
        for n, t in sub.items():
            assert torch.equal(from_tensors[k][n], t) and torch.equal(drawn[k][n], t)
            assert torch.equal(loaded[k][n], before[k][n])
            assert not loaded[k][n].requires_grad


def test_save_weights_is_read_by_both_packages(tmp_path):
    params = TS.init_params(torch.Generator().manual_seed(0), device="cpu")
    path = tmp_path / "synthnet.npz"
    TS.save_weights(params, path)
    mine, theirs = TS.load_weights(path, "cpu"), JS.load_weights(path)
    for k, sub in params.items():
        for n, t in sub.items():
            assert torch.equal(mine[k][n], t)
            np.testing.assert_array_equal(np.asarray(theirs[k][n]), t.numpy())
