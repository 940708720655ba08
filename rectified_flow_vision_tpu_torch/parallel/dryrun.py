"""A dry run of every parallel path over n ranks: the counterpart of the
repo's ``__graft_entry__.dryrun_multichip``.

In order: a data x tensor parallel train step of a small UNet and mesh
sampling; a sequence-parallel DiT train step (ring attention) on a
('data', 'seq') mesh; the GPipe forward against the plain DiT, and a
pipeline train step, on a ('data', 'stage') mesh; an FSDP (+ tensor
parallel) train step and the share of the weights a rank stores; two epochs
of ``train_base_flow`` on the device-resident corpus under the mesh. Each
prints one line on rank 0 and fails on a non-finite loss or a mismatch.

    torchrun --nproc_per_node=4 -m rectified_flow_vision_tpu_torch.parallel.dryrun
    python -m rectified_flow_vision_tpu_torch.parallel.dryrun --ranks 4   # gloo on the CPU

Under ``torchrun`` each rank runs on its card (NCCL), and without a visible
card the run raises; without ``torchrun``, ``--ranks`` gloo processes are
spawned on the CPU (``dryrun_multichip``), the only way it runs there.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _finite(name: str, value: float) -> float:
    if not (math.isfinite(value) and value > 0):
        raise RuntimeError(f"dryrun {name}: bad loss {value}")
    return value


def dryrun(device: str = "cuda") -> None:
    """Run every path over the process group's ranks (see the module
    docstring); every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    from rectified_flow_vision_tpu_torch.data import ArrayDataset
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, train_base_flow
    from rectified_flow_vision_tpu_torch.models import base_flow as BF
    from rectified_flow_vision_tpu_torch.parallel import mesh as M
    from rectified_flow_vision_tpu_torch.parallel import pipeline as PP
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    world = dist.get_world_size()
    model_axis = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = M.create_mesh(model_axis=model_axis, device=device)
    _say(f"mesh: data {M.axis_size(mesh, 'data')} x model {M.axis_size(mesh, 'model')}")
    unet = dict(image_size=16, model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                sample_dtype="float32", device=device)
    batch = 2 * world

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    def step_once(fsdp: bool):
        model = BaseFlowModel(**unet)
        M.place_params(mesh, model, fsdp=fsdp)
        opt = BF.make_optimizer(model, 1e-4, 1, 1, mesh=mesh)
        step = BF.make_train_step(model, opt, coupled=False, mesh=mesh)
        x = torch.randn((batch, 16, 16, 3), generator=gen(0), device=device)
        return model, float(step(M.shard_batch(mesh, x), gen(1)))

    _, loss = step_once(fsdp=False)
    svc = SamplerService(BaseFlowModel(**unet), mesh=mesh, step_counts=(2,), batch_size=batch,
                         warmup=False)
    out = svc.generate(batch, num_steps=2, data_format="NHWC")
    if out.shape != (batch, 16, 16, 3) or not np.isfinite(out).all():
        raise RuntimeError(f"dryrun sample: {out.shape}")
    _say(f"dryrun ok (dp x tp): loss={_finite('dp x tp', loss):.4f}, sample={out.shape}")

    # sequence parallelism: a DiT train step with ring attention
    seq = min(world, 4) if world % min(world, 4) == 0 else 1
    seq_mesh = DeviceMesh(device, torch.arange(world).reshape(world // seq, seq),
                          mesh_dim_names=("data", "seq"))
    dit_cfg = dict(image_size=16, in_channels=4, backbone="dit", patch_size=2, hidden_size=32,
                   depth=2, num_heads=4, sample_dtype="float32", device=device)
    dit_model = BaseFlowModel(**dit_cfg)
    x1 = M.shard_batch(seq_mesh, torch.randn((2 * (world // seq), 16, 16, 4), generator=gen(5),
                                             device=device))
    g = gen(6)
    x0 = torch.randn(x1.shape, generator=g, device=device)
    t = torch.rand((x1.shape[0],), generator=g, device=device)
    x_t, target = dit_model.get_interpolation(x0, x1, t)
    pred = dit_model.velocity_net(x_t, t, masters=True, mesh=seq_mesh, seq_axis="seq")
    sp_loss = torch.mean(torch.square(pred - target))
    sp_loss.backward()
    _say(f"dryrun ok (dp x sp ring-attention DiT): loss={_finite('sp', float(sp_loss.detach())):.4f}")

    # pipeline parallelism: GPipe forward against the plain DiT, then a step
    stages = 2 if world % 2 == 0 else 1
    pp_mesh = DeviceMesh(device, torch.arange(world).reshape(world // stages, stages),
                         mesh_dim_names=("data", "stage"))
    net = dit_model.velocity_net
    x_pp = torch.randn((4, 16, 16, 4), generator=gen(8), device=device)
    t_pp = torch.linspace(0.1, 0.9, 4, device=device)
    with torch.no_grad():
        err = float((net.pipeline_apply(x_pp, t_pp, pp_mesh, num_microbatches=2)
                     - net(x_pp, t_pp)).abs().max())
    if err >= 1e-3:
        raise RuntimeError(f"dryrun pipeline mismatch {err}")
    _say(f"dryrun ok (pp GPipe DiT, {stages} stages): max err={err:.2e}")
    pp_step, _ = PP.make_pipeline_train_step(
        net, lambda ps: torch.optim.AdamW(ps, lr=1e-4), pp_mesh, num_microbatches=2)
    rest, blocks = PP.split_pipeline_params(net, pp_mesh)
    pp_loss = float(pp_step(rest, blocks, torch.randn((4, 16, 16, 4), generator=gen(9),
                                                      device=device), gen(10)))
    _say(f"dryrun ok (pp GPipe DiT TRAIN step): loss={_finite('pp', pp_loss):.4f}")

    # FSDP (+ tensor parallel)
    model, f_loss = step_once(fsdp=True)
    w = dict(model.named_parameters())["velocity_net.input_conv.weight"]
    frac = M.local(w).numel() / w.numel()
    _say(f"dryrun ok (FSDP dp{M.axis_size(mesh, 'data')} x tp{M.axis_size(mesh, 'model')} "
         f"TRAIN step): loss={_finite('fsdp', f_loss):.4f}, shard_frac={frac:.3f}")

    # the device-resident epoch under the mesh
    corpus = np.random.RandomState(0).randn(4 * batch, 16, 16, 3).astype(np.float32)
    losses = train_base_flow(BaseFlowModel(**unet), ArrayDataset(corpus), epochs=2, lr=1e-4,
                             batch_size=batch, mesh=mesh, device_epoch=True, progress=False)
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise RuntimeError(f"dryrun mesh epoch losses {losses}")
    _say(f"dryrun ok (mesh device epoch, dp{M.axis_size(mesh, 'data')} x "
         f"tp{M.axis_size(mesh, 'model')}): losses={[round(v, 4) for v in losses]}")


def _rank(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        dryrun("cpu")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, timeout: float = 600.0) -> None:
    """Spawn ``n_ranks`` gloo processes on the CPU and run ``dryrun`` in each;
    raise if a rank fails or is still running at ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, n_ranks, os.path.join(tmp, "store")))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"dryrun ranks exited with {bad}")


def main() -> None:
    from rectified_flow_vision_tpu_torch.parallel.mesh import maybe_init_distributed

    parser = argparse.ArgumentParser(description="Dry run of the port's parallel paths")
    parser.add_argument("--ranks", type=int, default=4,
                        help="gloo ranks to spawn on the CPU when not under torchrun")
    args = parser.parse_args()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun under torchrun runs each rank on its cuda card, and no CUDA device is "
            "visible; for gloo ranks on the CPU run it without torchrun (--ranks N)")
    if maybe_init_distributed():
        try:
            dryrun("cuda")
        finally:
            dist.destroy_process_group()
    else:
        dryrun_multichip(args.ranks)


if __name__ == "__main__":
    main()
