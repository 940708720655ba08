"""Spawned gloo ranks on the CPU for the port's parallel tests.

``spawn(fn, world, tmp_path, **kwargs)`` starts ``world`` processes, each of
which joins a gloo process group through a ``file://`` store under
``tmp_path`` (no ports), runs ``fn(rank, world, **kwargs)`` with one torch
thread, and saves what it returns; ``spawn`` returns the ranks' results in
rank order. A rank that hangs is killed at the timeout and fails the one
test. The workers below import torch and the port only, never JAX: the tests
hold their results against the JAX package in the parent.
"""

from __future__ import annotations

import faulthandler
import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _entry(fn, rank, world, store, out_dir, kwargs, timeout):
    torch.set_num_threads(1)
    # a rank that hangs writes where it is before the parent kills it
    trace = open(Path(out_dir) / f"stack{rank}.txt", "w")
    faulthandler.dump_traceback_later(max(timeout - 10.0, 1.0), exit=True, file=trace)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        result = fn(rank, world, **kwargs)
        torch.save(result, Path(out_dir) / f"out{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (Path(out_dir) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(fn, world: int, tmp_path, timeout: float = 240.0, **kwargs):
    out = Path(tmp_path) / f"spawn_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(out / "store"), str(out), kwargs, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = "".join((out / f"{kind}{r}.txt").read_text() for r in range(world)
                     for kind in ("err", "stack") if (out / f"{kind}{r}.txt").exists())
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s\n{errors}")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}\n{errors}")
    return [torch.load(out / f"out{r}.pt", weights_only=False) for r in range(world)]


def _leaves(tree, prefix=""):
    """A param tree as {path: numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _fixed_times(monkey_module, times):
    """Make ``sample_times`` return the given global times, in order."""
    it = iter(times)
    monkey_module.sample_times = lambda *a, **k: torch.from_numpy(np.asarray(next(it)))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def train_step_cases(rank, world, params, x0, x1, t, lr, cases, save_dir=None):
    """One coupled train step of a fresh model per case ``name: dict(cfg=,
    dp=, tp=, fsdp=)``, on this rank's rows of (x0, x1) with the global times
    ``t``; a case may bring its own ``params``, ``x0``, ``x1``, ``t``, and
    ``winograd=True`` runs it with ``RFV_CONV_WINOGRAD`` set); rank 0
    returns each case's global loss, the whole updated weights, the share
    of the parameters this rank stored and its Winograd conv calls. With
    ``save_dir`` each case's model is saved there as ``<name>.npz`` (rank 0
    writes)."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.models import base_flow as TBF
    from rectified_flow_vision_tpu_torch.ops import winograd
    from rectified_flow_vision_tpu_torch.parallel import mesh as M

    out = {}
    for name, case in cases.items():
        case = {"params": params, "x0": x0, "x1": x1, "t": t, **case}
        if case.get("winograd"):
            os.environ["RFV_CONV_WINOGRAD"] = "1"
        else:
            os.environ.pop("RFV_CONV_WINOGRAD", None)
        winograd.reset_calls()
        _fixed_times(TBF, [case["t"]])
        mesh = M.create_mesh(data_axis=case["dp"], model_axis=case["tp"], device="cpu")
        model = BaseFlowModel(device="cpu", params=case["params"], **case["cfg"])
        total = sum(p.numel() for p in model.parameters())
        M.place_params(mesh, model, fsdp=case["fsdp"])
        stored = sum(M.local(p).numel() for p in model.parameters())
        opt = TBF.make_optimizer(model, lr, 1, 1, mesh=mesh)
        step = TBF.make_train_step(model, opt, coupled=True, mesh=mesh)
        batch = tuple(M.shard_batch(mesh, torch.from_numpy(case[k])) for k in ("x0", "x1"))
        loss = float(step(batch, torch.Generator().manual_seed(0)))
        weights = model.params
        if save_dir is not None:
            model.save(str(Path(save_dir) / f"{name}.npz"))
        out[name] = dict(loss=loss, params=_leaves(weights), stored=stored / total,
                         winograd_calls=winograd.CALLS["winograd"])
    return out if rank == 0 else None


def reflow_epoch_cases(rank, world, cfg, params, x0, x1, times, kw, cases, save_dir):
    """``train_rectified_flow`` per case ``name: (dp, tp, fsdp)`` with the
    given times for its steps; every rank returns the losses and the model's
    weights after the trainer (whole again), and the checkpoints are written
    under ``save_dir/<name>``."""
    from rectified_flow_vision_tpu_torch.models import RectifiedFlowModel
    from rectified_flow_vision_tpu_torch.models import base_flow as TBF
    from rectified_flow_vision_tpu_torch.models import rectified_flow as TRF
    from rectified_flow_vision_tpu_torch.parallel import mesh as M

    sample_times = TBF.sample_times
    out = {}
    for name, (dp, tp, fsdp) in cases.items():
        _fixed_times(TBF, times)
        mesh = M.create_mesh(data_axis=dp, model_axis=tp, device="cpu")
        model = RectifiedFlowModel(device="cpu", params=params, **cfg)
        losses = TRF.train_rectified_flow(model, x0, x1, mesh=mesh, fsdp=fsdp,
                                          save_path=f"{save_dir}/{name}", **kw)
        out[name] = dict(losses=losses, params=_leaves(model.params),
                         tp=getattr(model.velocity_net, "tp", None) is not None)
        # resume on the mesh: the state of each epoch kept per rank; the last
        # one removed, the run again from the one before
        TBF.sample_times = sample_times
        runs = []
        for again in (False, True):
            if again:
                mine = f"{save_dir}/{name}_state/rank{rank}_of_{world}"
                dist.barrier()
                Path(mine, f"epoch_{kw['epochs'] - 1:08d}.pt").unlink()
                dist.barrier()
            model = RectifiedFlowModel(device="cpu", params=params, **cfg)
            runs.append((TRF.train_rectified_flow(model, x0, x1, mesh=mesh, fsdp=fsdp,
                                                  resume_dir=f"{save_dir}/{name}_state",
                                                  save_every=1, **kw),
                         _leaves(model.params)))
        out[name + "_resume"] = runs
    return out


def _dit(cfg, state):
    from rectified_flow_vision_tpu_torch.models import DiT

    dit = DiT(**cfg)
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return dit


def _flow_loss(pred, x1, x0):
    return torch.mean(torch.square(pred.float() - (x1 - x0).float()))


def _grads(loss, named):
    names = list(named)
    gs = torch.autograd.grad(loss, [named[k] for k in names])
    return {k: g.numpy() for k, g in zip(names, gs)}


def seq_cases(rank, world, ring, dit):
    """Sequence parallelism over every rank. ``ring``: name -> (q, k, v, g):
    ``ring_attention_sharded`` on a ``seq`` mesh, its output and the
    gradients of sum(out * g). ``dit``: ``DiT.forward`` on a (1, world)
    ('data', 'seq') mesh, the velocity, the flow loss and every gradient.
    Rank 0 returns them."""
    from torch.distributed.device_mesh import DeviceMesh

    from rectified_flow_vision_tpu_torch.parallel.ring_attention import ring_attention_sharded

    out = {}
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("seq",))
    for name, (q, k, v, g) in ring.items():
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        att = ring_attention_sharded(*leaves, mesh, seq_axis="seq")
        grads = torch.autograd.grad((att * torch.from_numpy(g)).sum(), leaves)
        out[name] = dict(out=att.detach().numpy(), grads=[gr.numpy() for gr in grads])
    mesh2 = DeviceMesh("cpu", torch.arange(world).reshape(1, world), mesh_dim_names=("data", "seq"))
    net = _dit(dit["cfg"], dit["state"])
    x1, x0, t = (torch.from_numpy(dit[k]) for k in ("x1", "x0", "t"))
    tb = t[:, None, None, None]
    pred = net((1 - tb) * x0 + tb * x1, t, masters=True, mesh=mesh2, seq_axis="seq")
    loss = _flow_loss(pred, x1, x0)
    out["dit"] = dict(pred=pred.detach().numpy(), loss=float(loss.detach()),
                      grads=_grads(loss, dict(net.named_parameters())))
    return out if rank == 0 else None


def pipeline_cases(rank, world, cfg, state, x, tx, x1, x0, t, microbatches, lr, steps):
    """On a ``stage`` mesh over every rank: ``DiT.pipeline_apply`` for each
    microbatch count; the gradients of the pipeline train step's ``loss_fn``
    (rest, and this stage's blocks); the split / merge round trip; then
    ``steps`` AdamW steps on x1 and the merged weights."""
    from torch.distributed.device_mesh import DeviceMesh

    from rectified_flow_vision_tpu_torch.parallel import pipeline as PP

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("stage",))
    dit = _dit(cfg, state)
    x, tx = torch.from_numpy(x), torch.from_numpy(tx)
    with torch.no_grad():
        fwd = {m: dit.pipeline_apply(x, tx, mesh, num_microbatches=m).numpy() for m in microbatches}
    step, loss_fn = PP.make_pipeline_train_step(
        dit, lambda ps: torch.optim.AdamW(ps, lr=lr), mesh, num_microbatches=2)
    rest, blocks = PP.split_pipeline_params(dit, mesh)
    roundtrip = {k: v.numpy().copy()
                 for k, v in PP.merge_pipeline_params(rest, blocks, mesh).items()}
    x1, x0, t = (torch.from_numpy(a) for a in (x1, x0, t))
    loss = loss_fn(rest, blocks, x1, x0, t)
    grads = _grads(loss, {**{f"rest.{k}": v for k, v in rest.items()},
                          **{f"stage.{k}": v for k, v in blocks.items()}})
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(rest, blocks, x1, gen)) for _ in range(steps)]
    merged = {k: v.numpy() for k, v in PP.merge_pipeline_params(rest, blocks, mesh).items()}
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in merged.items()})
    with torch.no_grad():
        served = dit(x1, torch.full((x1.shape[0],), 0.5)).numpy()
    return dict(fwd=fwd, loss=float(loss.detach()), grads=grads, stage=rank, losses=losses,
                roundtrip=roundtrip, served=served)


def serving_cases(rank, world, cfg, params, batch, n, steps, seed, meshes):
    """``SamplerService(mesh=)`` per mesh ``name: (dp, tp)``, each service
    generating ``n`` images; ``generate_reflow_pairs`` under the data mesh;
    the experiments' ``default_mesh``; then the whole ``parallel.dryrun``.
    Every rank returns its images and pairs."""
    from rectified_flow_vision_tpu_torch.config import Config
    from rectified_flow_vision_tpu_torch.experiments.train_base import default_mesh
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, generate_reflow_pairs
    from rectified_flow_vision_tpu_torch.parallel import mesh as M
    from rectified_flow_vision_tpu_torch.parallel.dryrun import dryrun
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    out = {}
    for name, (dp, tp) in meshes.items():
        mesh = M.create_mesh(data_axis=dp, model_axis=tp, device="cpu")
        model = BaseFlowModel(device="cpu", params=params, **cfg)
        svc = SamplerService(model, mesh=mesh, step_counts=(steps,), batch_size=batch, seed=seed)
        out[name] = svc.generate(n, num_steps=steps, data_format="NHWC")
    teacher = BaseFlowModel(device="cpu", params=params, **cfg)
    out["pairs"] = generate_reflow_pairs(teacher, 6, batch_size=4, num_steps=2, seed=3,
                                         method="heun", mesh=M.create_mesh(device="cpu"))
    config = Config()
    config.parallel.model_axis = 2
    out["default_mesh"] = tuple(default_mesh(config, "cpu").mesh.shape)
    dryrun("cpu")
    return out
