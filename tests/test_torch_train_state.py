"""Resume and asynchronous checkpoints of the port, on the CPU.

Mirrors ``tests/test_resume.py`` (the JAX package's resume tests) for both
of the port's trainers, on a tiny UNet (8x8, 16 channels, one level, dropout
0.1): a run crashed after epoch 2's state is committed and resumed with the
same horizon repeats the uninterrupted run (losses rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6, the JAX test's tolerances), a finished run's resume
trains nothing, and the EMA survives a restart. The base trainer is held on
its host path and on its device-resident epoch path (forced on the CPU).
Then: the first resumed step runs at the schedule's lr, ``max_to_keep`` keeps
the epochs that the JAX package's Orbax manager keeps, and ``AsyncSaver`` /
``TrainStateManager`` write the state as it was at ``save``, not later values.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu_torch.data import ArrayDataset
from rectified_flow_vision_tpu_torch.models import (
    BaseFlowModel,
    RectifiedFlowModel,
    train_base_flow,
    train_rectified_flow,
)
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt
from rectified_flow_vision_tpu_torch.utils import train_state as ts

TINY = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
            sample_dtype="float32", device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 8, 8, 3).astype(np.float32)


def _model(trainer, seed):
    return (BaseFlowModel if trainer == "base" else RectifiedFlowModel)(seed=seed, **TINY)


def _train(trainer, model, *, device_epoch=False, **kwargs):
    """Run one trainer on a fixed 8-image corpus (2 steps an epoch)."""
    if trainer == "base":
        data = ArrayDataset(_images(8, 0))
        return train_base_flow(model, data, batch_size=4, device_epoch=device_epoch, **kwargs)
    return train_rectified_flow(model, _images(8, 1), _images(8, 2), batch_size=4,
                                data_format="NHWC", device_epoch=device_epoch, **kwargs)


def _crash_after_second_save(monkeypatch):
    """Make TrainStateManager.save commit its state, then raise on the 2nd call."""
    orig_save = ts.TrainStateManager.save
    calls = {"n": 0}

    def crashing_save(self, epoch, params, opt_state, losses, ema=None):
        orig_save(self, epoch, params, opt_state, losses, ema=ema)
        self.wait()  # the checkpoint is committed before "dying"
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(ts.TrainStateManager, "save", crashing_save)
    return lambda: monkeypatch.setattr(ts.TrainStateManager, "save", orig_save)


def _assert_same_params(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-6)


RUNS = [("base", False), ("base", True), ("reflow", False)]
RUN_IDS = ["base-host", "base-device_epoch", "reflow"]


@pytest.mark.parametrize("trainer,device_epoch", RUNS, ids=RUN_IDS)
def test_interrupted_run_resumes_and_matches(trainer, device_epoch, tmp_path, monkeypatch):
    kwargs = dict(epochs=4, lr=1e-3, progress=False, seed=3, save_every=1,
                  device_epoch=device_epoch)
    m_full = _model(trainer, 1)
    losses_full = _train(trainer, m_full, **kwargs)

    resume_dir = tmp_path / "state"
    restore = _crash_after_second_save(monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        _train(trainer, _model(trainer, 1), resume_dir=str(resume_dir), **kwargs)
    restore()
    assert ts.TrainStateManager(resume_dir).latest_epoch() == 1

    # a fresh model from the same init seed resumes from the committed state
    m_b = _model(trainer, 1)
    losses_b = _train(trainer, m_b, resume_dir=str(resume_dir), **kwargs)
    assert len(losses_b) == 4
    np.testing.assert_allclose(losses_b, losses_full, rtol=1e-5)
    _assert_same_params(m_full.params, m_b.params)


@pytest.mark.parametrize("trainer", ["base", "reflow"])
def test_completed_run_resume_is_noop(trainer, tmp_path, monkeypatch):
    resume_dir = str(tmp_path / "state")
    kwargs = dict(epochs=2, lr=1e-3, progress=False, save_every=1, resume_dir=resume_dir)
    m = _model(trainer, 0)
    losses1 = _train(trainer, m, **kwargs)
    steps = []
    monkeypatch.setattr(TBF.FlowOptimizer, "step", lambda self: steps.append(1))
    m2 = _model(trainer, 0)
    losses2 = _train(trainer, m2, **kwargs)
    np.testing.assert_allclose(losses1, losses2, rtol=1e-6)
    assert not steps  # nothing left to train
    _assert_same_params(m.params, m2.params)  # the resumed weights are the saved ones


@pytest.mark.parametrize("trainer", ["base", "reflow"])
def test_ema_survives_restart(trainer, tmp_path, monkeypatch):
    """The EMA is saved and restored: a run crashed mid-flight (same epoch
    horizon) reproduces the uninterrupted run's EMA checkpoint."""
    kwargs = dict(epochs=4, lr=1e-3, progress=False, seed=5, save_every=1, ema_decay=0.5)
    _train(trainer, _model(trainer, 2), save_path=str(tmp_path / "full"), **kwargs)
    ema_full, _ = ckpt.load_params(str(tmp_path / "full_ema_final.npz"))

    resume_dir = tmp_path / "state"
    restore = _crash_after_second_save(monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        _train(trainer, _model(trainer, 2), resume_dir=str(resume_dir), **kwargs)
    restore()
    _train(trainer, _model(trainer, 2), resume_dir=str(resume_dir),
           save_path=str(tmp_path / "resumed"), **kwargs)
    ema_res, _ = ckpt.load_params(str(tmp_path / "resumed_ema_final.npz"))
    _assert_same_params(ema_full, ema_res)


@pytest.mark.parametrize("trainer", ["base", "reflow"])
def test_first_resumed_step_runs_at_the_schedules_lr(trainer, tmp_path, monkeypatch):
    """The optimizer's step count is part of the state: the resumed run's
    steps take the lr of the schedule at their global step (a per-step
    warm-up ramp on the base trainer), not a restarted cosine."""
    warm = dict(warmup_epochs=1.5) if trainer == "base" else {}
    kwargs = dict(epochs=4, lr=1e-3, progress=False, seed=3, save_every=1, **warm)
    orig_step = TBF.FlowOptimizer.step
    seen = []

    def spy(self):
        seen.append((self.step_count, self.schedule(self.step_count)))
        orig_step(self)
        seen[-1] += (self.adamw.param_groups[0]["lr"],)

    monkeypatch.setattr(TBF.FlowOptimizer, "step", spy)
    restore = _crash_after_second_save(monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        _train(trainer, _model(trainer, 1), resume_dir=str(tmp_path / "s"), **kwargs)
    restore()
    seen.clear()
    _train(trainer, _model(trainer, 1), resume_dir=str(tmp_path / "s"), **kwargs)
    schedule = TBF.make_epoch_cosine_schedule(1e-3, 4, 2, warm.get("warmup_epochs", 0.0))
    assert [s[0] for s in seen] == [4, 5, 6, 7]  # epochs 3 and 4, 2 steps each
    for step, _, lr in seen:
        assert lr == schedule(step)
    assert seen[0][2] != schedule(0)


def test_max_to_keep_keeps_the_epochs_the_jax_manager_keeps(tmp_path):
    """Six saves with max_to_keep=3: the port's manager and the JAX package's
    Orbax one keep the same three epochs, and both restore the newest."""
    from rectified_flow_vision_tpu.utils.train_state import TrainStateManager as JManager

    tree = {"w": np.arange(6, dtype=np.float32)}
    jm = JManager(tmp_path / "jax", max_to_keep=3)
    tm = ts.TrainStateManager(tmp_path / "torch", max_to_keep=3)
    for epoch in range(6):
        jm.save(epoch, tree, {"count": np.int32(epoch)}, [0.1] * (epoch + 1))
        jm.wait()
        tm.save(epoch, {"w": torch.from_numpy(tree["w"]) + epoch}, {"count": epoch},
                [0.1] * (epoch + 1))
    tm.close()
    assert tm.epochs() == sorted(jm.manager.all_steps()) == [3, 4, 5]
    assert tm.latest_epoch() == jm.latest_epoch() == 5
    params, opt_state, losses, next_epoch, ema = tm.restore()
    jparams, _, jlosses, jnext, jema = jm.restore(tree, {"count": np.int32(0)})
    jm.close()
    assert next_epoch == jnext == 6 and ema is None and jema is None
    assert losses == jlosses == [0.1] * 6
    assert opt_state == {"count": 5}
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(jparams["w"]) + 5)
    assert not list((tmp_path / "torch").glob("*.tmp"))
    assert tm.save(5, params, opt_state, losses) is False  # held already, as Orbax skips it


def _blocking(monkeypatch, module, name):
    """Replace ``module.name`` by a version that waits for ``go`` first."""
    go, entered = threading.Event(), threading.Event()
    orig = getattr(module, name)

    def blocked(*args, **kwargs):
        entered.set()
        assert go.wait(30)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, blocked)
    return go, entered


def test_async_saver_writes_the_snapshot_not_later_values(tmp_path, monkeypatch):
    """The writer thread blocks until the caller has updated the CPU tensors
    in place (as an optimizer step does): the file holds the values at
    ``save``."""
    go, entered = _blocking(monkeypatch, ckpt, "save_params")
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = np.ones(4, np.float32)
    saver = ckpt.AsyncSaver()
    saver.save(tmp_path / "m.npz", {"layer": {"w": w, "b": b}}, {"k": 1})
    assert entered.wait(30)
    w.add_(100.0)
    b += 100.0
    go.set()
    saver.wait()
    params, config = ckpt.load_params(tmp_path / "m.npz")
    np.testing.assert_array_equal(params["layer"]["w"], np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(params["layer"]["b"], np.ones(4))
    assert config == {"k": 1}


def test_a_failed_background_write_raises_on_the_callers_thread(tmp_path, monkeypatch):
    """``AsyncSaver``'s thread (the train state's writer too) keeps a write's
    error for ``wait``, which raises it once; the next write runs."""
    def broken(*args):
        raise OSError("disk full")

    saver = ckpt.AsyncSaver()
    saver.submit(broken)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()
    monkeypatch.setattr(ts.torch, "save", broken)
    mgr = ts.TrainStateManager(tmp_path / "s")
    mgr.save(0, {"w": torch.ones(2)}, {}, [1.0])
    with pytest.raises(OSError, match="disk full"):
        mgr.close()
    monkeypatch.undo()
    mgr.save(1, {"w": torch.ones(2)}, {}, [1.0, 0.5])
    mgr.close()
    assert mgr.epochs() == [1]


def test_train_state_manager_writes_the_snapshot_not_later_values(tmp_path, monkeypatch):
    """The same for the train state: weights, AdamW moments and EMA change
    in place after ``save`` and before the write; the restored state is the
    one at ``save``."""
    model = BaseFlowModel(seed=0, **TINY)
    opt = TBF.make_optimizer(model, 1e-3, 2, 1)
    ema = TBF.init_ema(model)
    step = TBF.make_train_step(model, opt, coupled=False, ema=ema, ema_decay=0.9)
    step(torch.as_tensor(_images(4, 0)), torch.Generator().manual_seed(0))
    want_params = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = {k: v.clone() for k, v in opt.adamw.state[opt.params[0]].items()}
    want_ema = {k: v.clone() for k, v in ema.items()}

    go, entered = _blocking(monkeypatch, ts.torch, "save")
    mgr = ts.TrainStateManager(tmp_path / "s")
    mgr.save(0, model.state_dict(), opt.state_dict(), [1.0], ema=ema)
    assert entered.wait(30)
    step(torch.as_tensor(_images(4, 1)), torch.Generator().manual_seed(1))  # in place
    go.set()
    mgr.close()

    params, opt_state, losses, next_epoch, ema_r = ts.TrainStateManager(tmp_path / "s").restore()
    assert (losses, next_epoch, opt_state["step_count"]) == ([1.0], 1, 1)
    for k, v in want_params.items():
        assert torch.equal(params[k], v) and not torch.equal(model.state_dict()[k], v)
    for k, v in want_ema.items():
        assert torch.equal(ema_r[k], v)
    saved_moments = opt_state["adamw"]["state"][0]
    for k, v in want_opt.items():
        assert torch.equal(saved_moments[k], v)


def test_experiments_resume_from_their_state_dirs(tmp_path, monkeypatch):
    """With ``resume: true`` the pipeline's two training stages save their
    state under the checkpoint directory, and a second run resumes from it:
    nothing is left to train, and the loss curve is the first run's."""
    from rectified_flow_vision_tpu_torch import config as TC
    from rectified_flow_vision_tpu_torch.experiments import train_base as TTB
    from rectified_flow_vision_tpu_torch.experiments import train_rectified as TTR

    cfg = TC.Config()
    cfg.data.image_size, cfg.data.num_mock_images = 8, 8
    cfg.data.data_dir = str(tmp_path / "data")
    cfg.model.channels, cfg.model.channel_mult, cfg.model.num_res_blocks = 16, [1], 1
    cfg.model.sample_dtype = "float32"
    cfg.training_base.epochs, cfg.training_base.batch_size = 2, 4
    cfg.training_base.save_every, cfg.training_base.num_timesteps = 1, 20
    cfg.training_rectified.epochs, cfg.training_rectified.batch_size = 2, 4
    cfg.training_rectified.num_pairs, cfg.training_rectified.num_reflow_iterations = 8, 1
    cfg.training_rectified.save_every = 1
    cfg.training_base.resume = cfg.training_rectified.resume = True
    cfg.paths.checkpoints = str(tmp_path / "ckpt")
    cfg.paths.results = str(tmp_path / "results")
    monkeypatch.setattr(TC, "repo_root", lambda: tmp_path)
    ck = tmp_path / "ckpt"

    curves = []
    for _ in range(2):
        TTB.main(cfg, device="cpu")
        TTR.main(cfg, device="cpu")
        curves.append([np.load(ck / f"{name}_losses.npy")
                       for name in ("base_flow", "rectified_flow_k1")])
        if len(curves) == 1:  # the second run trains no step
            monkeypatch.setattr(TBF.FlowOptimizer, "step", lambda self: pytest.fail("trained"))
    for state in ("state_base", "state_rectified_k1"):
        assert ts.TrainStateManager(ck / state).epochs() == [0, 1]
    for first, second in zip(*curves):
        assert first.shape == (2,)
        np.testing.assert_array_equal(first, second)
