"""Rectified Flow (Reflow) student model and the reflow training pipeline.

Counterpart of the JAX package's ``models/rectified_flow.py``:

* ``RectifiedFlowModel``: the base model's architecture, trained on
  teacher-synthesized coupled pairs instead of (noise, real data); its config
  carries ``reflow_iteration``, so ``BaseFlowModel.from_checkpoint``
  dispatches as it does in JAX;
* ``generate_reflow_pairs``: (noise, teacher sample) pairs, and data-side
  pairs by integrating the teacher backward from real images;
* ``train_rectified_flow``: flow-matching training on coupled pairs;
* ``iterative_reflow``: K rounds of student -> teacher promotion with
  teacher-step halving (floor 10);
* ``compute_straightness``: mean squared deviation of the rolled-out
  velocity from the constant ideal velocity x1 - x0.

Pair synthesis runs on the model's device at one fixed batch shape and comes
to the host once per batch.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rectified_flow_vision_tpu_torch.models.base_flow import (
    _DTYPE_NAMES,
    DEVICE_EPOCH_MAX_BYTES,
    BaseFlowModel,
    _to_nhwc,
    close_train_state,
    epoch_generator,
    init_ema,
    make_optimizer,
    make_train_epoch,
    make_train_step,
    place_for_training,
    restore_train_state,
    save_epoch_checkpoints,
    save_train_state,
)
from rectified_flow_vision_tpu_torch.parallel import mesh as mesh_lib
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.models")


class RectifiedFlowModel(BaseFlowModel):
    """Reflow student: same flow model, trained on straightened couplings."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.reflow_iteration = 0

    @property
    def config(self) -> dict:
        cfg = super().config
        cfg["reflow_iteration"] = self.reflow_iteration
        return cfg

    @staticmethod
    def from_base_model(
        base_model: BaseFlowModel, *, copy_weights: bool = False, seed: int = 1
    ) -> "RectifiedFlowModel":
        """Fresh student with the teacher's architecture, dtypes and device.

        ``copy_weights=False`` matches the reference default (its weight copy
        is deliberately disabled).
        """
        cfg = dict(base_model.config)
        cfg.pop("model_type", None)
        cfg.pop("reflow_iteration", None)
        student = RectifiedFlowModel(
            seed=seed,
            compute_dtype=_DTYPE_NAMES[base_model.compute_dtype],
            sample_dtype=_DTYPE_NAMES[base_model.sample_dtype],
            device=base_model.device,
            **cfg,
        )
        if copy_weights:
            student.load_state_dict(base_model.state_dict(), strict=True)
        return student

    @torch.no_grad()
    def compute_straightness(
        self, x0, x1, num_points: int = 10, *, data_format: str = "NCHW"
    ) -> float:
        """Trajectory straightness: the Euler rollout's mean squared deviation
        from the constant velocity x1 - x0 (0 is perfectly straight). Model
        compute in ``sample_dtype``, state in fp32; one read at the end."""
        x0 = _to_nhwc(x0, data_format, self.device).float()
        x1 = _to_nhwc(x1, data_format, self.device).float()
        dtype = self.sample_dtype
        dt = np.float32(1.0 / num_points)
        ideal = x1 - x0
        x = x0
        devs = []
        for i in range(num_points):
            t = torch.full(
                (x.shape[0],), float(np.float32(i) * dt), dtype=torch.float32, device=x.device
            )
            v = self.velocity_net(x.to(dtype), t, dtype=dtype).float()
            devs.append(torch.mean(torch.square(v - ideal)))
            x = x + v * float(dt)
        return float(torch.stack(devs).mean())


# ---------------------------------------------------------------------------
# Reflow pipeline
# ---------------------------------------------------------------------------


def generate_reflow_pairs(
    teacher_model: BaseFlowModel,
    num_pairs: int,
    batch_size: int = 32,
    num_steps: int = 100,
    *,
    seed: int = 0,
    data_format: str = "NCHW",
    method: str = "euler",
    real_data=None,
    data_pair_fraction: float = 0.0,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesize (noise, image) couplings for Reflow training, as numpy
    arrays of shape [num_pairs, ...].

    Forward couplings: draw x0 ~ N(0, I) (from a generator seeded with
    ``seed`` on the teacher's device) and integrate the teacher ODE forward
    to x1. Every batch has the full shape; the last one is cut on the host.

    Data-side couplings (``data_pair_fraction`` > 0, requires ``real_data``):
    take real images x1 and integrate the teacher ODE backward
    (``BaseFlowModel.invert``) to their coupled noise x0, so the student's
    endpoints are real data ("Simple ReFlow", arXiv:2410.07815). Inversion is
    deterministic, so each unique image is inverted once and tiled when the
    corpus is smaller than the request. Data-side pairs come first.

    ``method`` selects the teacher's integrator ("euler", "midpoint", "heun").

    With ``mesh`` (every rank calls it alike) each data rank integrates its
    rows of every batch and the batches are gathered, so every rank returns
    all the pairs, the same as without a mesh.
    """
    mesh = mesh_lib.effective_mesh(mesh)
    if batch_size % mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS):
        raise ValueError(f"batch_size {batch_size} does not split over the data ranks")

    def rows(fn, x):
        return mesh_lib.gather_batch(mesh, fn(mesh_lib.shard_batch(mesh, torch.as_tensor(x))))

    num_data_pairs = 0
    if data_pair_fraction > 0.0:
        if real_data is None:
            raise ValueError("data_pair_fraction > 0 requires real_data")
        num_data_pairs = min(int(round(num_pairs * data_pair_fraction)), num_pairs)
    num_fwd_pairs = num_pairs - num_data_pairs
    device = teacher_model.device
    log.info(
        "Generating %d pairs for Reflow (%d steps%s)...", num_pairs, num_steps,
        f", {num_data_pairs} data-side" if num_data_pairs else "",
    )

    x0_list, x1_list = [], []
    if num_data_pairs:
        data_nhwc = _to_nhwc(real_data, data_format, device).float().cpu().numpy()
        n_unique = min(num_data_pairs, data_nhwc.shape[0])
        unique = data_nhwc[:n_unique]
        x0_parts = []
        for start in range(0, n_unique, batch_size):
            x1 = unique[start : start + batch_size]
            pad = batch_size - x1.shape[0]
            x1_full = np.concatenate([x1, x1[:1].repeat(pad, 0)]) if pad else x1
            x0 = rows(lambda x: teacher_model.invert(
                x, num_steps=num_steps, data_format="NHWC", method=method), x1_full)
            x0_parts.append(x0.cpu().numpy()[: x1.shape[0]])
        idx = np.arange(num_data_pairs) % n_unique
        x0_list.append(np.concatenate(x0_parts)[idx])
        x1_list.append(unique[idx])

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (
        batch_size, teacher_model.image_size, teacher_model.image_size,
        teacher_model.in_channels,
    )
    for _ in range(-(-num_fwd_pairs // batch_size) if num_fwd_pairs else 0):
        x0 = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        x1 = rows(lambda x: teacher_model.sample(
            noise=x, num_steps=num_steps, data_format="NHWC", method=method), x0)
        # to the host per batch: at most one rollout is in flight, and device
        # memory holds two batches
        x0_list.append(x0.cpu().numpy())
        x1_list.append(x1.cpu().numpy())

    x0_all = np.concatenate(x0_list)[:num_pairs]
    x1_all = np.concatenate(x1_list)[:num_pairs]
    log.info("Generated %d pairs", x0_all.shape[0])
    if data_format.upper() == "NCHW":
        x0_all = np.transpose(x0_all, (0, 3, 1, 2))
        x1_all = np.transpose(x1_all, (0, 3, 1, 2))
    return x0_all, x1_all


def train_rectified_flow(
    model: RectifiedFlowModel,
    x0_data,
    x1_data,
    epochs: int = 30,
    batch_size: int = 16,
    lr: float = 1e-4,
    save_path: Optional[str] = None,
    save_every: int = 10,
    *,
    mesh=None,
    seed: int = 0,
    data_format: str = "NCHW",
    ckpt_ext: str = ".npz",
    progress: bool = True,
    resume_dir: Optional[str] = None,
    device_epoch: Optional[bool] = None,
    fsdp: bool = False,
    ema_decay: Optional[float] = None,
    time_sampling: str = "uniform",
) -> List[float]:
    """Train the student on pre-generated couplings; returns the per-epoch
    mean losses. The AdamW / cosine / clip recipe of the base trainer, the
    loss on (x0, x1) pairs with t ~ U[0, 1] by default (``time_sampling``
    selects logit_normal / u_shaped). With ``ema_decay`` an EMA of the student
    is carried and written as ``*_ema_*``: the weights to sample from.
    ``resume_dir`` saves and restores the full train state, and ``mesh`` /
    ``fsdp`` place the training, as in ``train_base_flow``."""
    device = model.device
    x0_data = _to_nhwc(x0_data, data_format, device).float()
    x1_data = _to_nhwc(x1_data, data_format, device).float()
    n = x0_data.shape[0]
    if n == 0:
        raise ValueError("no reflow pairs given")

    steps_per_epoch = max(n // batch_size, 1)
    mesh = place_for_training(model, mesh, fsdp, batch_size)
    opt = make_optimizer(model, lr, epochs, steps_per_epoch, mesh=mesh)
    use_ema = ema_decay is not None and ema_decay > 0
    state_mgr, losses, start_epoch, ema = None, [], 0, None
    if resume_dir is not None:
        state_mgr, losses, start_epoch, ema = restore_train_state(
            resume_dir, model, opt, use_ema, "reflow", mesh)
    if use_ema and ema is None:
        ema = init_ema(model)
    step_kwargs = dict(
        coupled=True, ema=ema, ema_decay=ema_decay if use_ema else None,
        time_sampling=time_sampling, mesh=mesh,
    )
    nbytes = (x0_data.numel() + x1_data.numel()) * 4
    if device_epoch is None:
        device_epoch = device.type != "cpu" and nbytes <= DEVICE_EPOCH_MAX_BYTES
    if device_epoch:
        train_epoch = make_train_epoch(model, opt, **step_kwargs)
    else:
        train_step = make_train_step(model, opt, **step_kwargs)
        # the per-step path keeps the pairs on the host and uploads each batch
        x0_host, x1_host = x0_data.cpu(), x1_data.cpu()

    for epoch in range(start_epoch, epochs):
        order = np.random.default_rng(seed * 99991 + epoch).permutation(n)
        gen = epoch_generator(model, seed, epoch)
        t0 = time.time()
        # fixed-shape batches; a too-small corpus is tiled up to one batch
        if n < batch_size:
            order = np.tile(order, -(-batch_size // n))[:batch_size]
        end = max(len(order) - (len(order) % batch_size), batch_size)
        perm = torch.as_tensor(order[:end].reshape(-1, batch_size))
        if device_epoch:
            step_losses = train_epoch((x0_data, x1_data), perm.to(device), gen)
        else:
            step_losses = torch.stack([
                train_step((x0_host[idx].to(device), x1_host[idx].to(device)), gen)
                for idx in map(lambda i: mesh_lib.shard_batch(mesh, i), perm)
            ])
        avg_loss = float(step_losses.mean())
        losses.append(avg_loss)
        if progress:
            log.info(
                "Reflow Epoch %d/%d - Loss: %.4f (%.1fs)", epoch + 1, epochs, avg_loss,
                time.time() - t0,
            )
        if save_path and (epoch + 1) % save_every == 0:
            save_epoch_checkpoints(model, ema, save_path, f"epoch{epoch + 1}", ckpt_ext)
        if state_mgr is not None and (epoch + 1) % save_every == 0:
            save_train_state(state_mgr, epoch, model, opt, losses, ema)

    if save_path:
        save_epoch_checkpoints(model, ema, save_path, "final", ckpt_ext)
    if state_mgr is not None:
        close_train_state(state_mgr, model, opt, losses, ema, start_epoch, epochs)
    mesh_lib.unshard(model)
    return losses


def iterative_reflow(
    initial_model: BaseFlowModel,
    real_data_loader=None,
    num_iterations: int = 2,
    epochs_per_iter: int = 30,
    num_pairs: int = 5000,
    teacher_steps: int = 100,
    lr: float = 1e-4,
    save_dir: Optional[str] = None,
    *,
    pair_batch_size: int = 32,
    batch_size: int = 16,
    seed: int = 0,
    mesh=None,
    fsdp: bool = False,
    init_from_teacher: bool = False,
    teacher_method: str = "euler",
    time_sampling: str = "uniform",
    ema_decay: Optional[float] = None,
    real_data=None,
    data_pair_fraction: float = 0.0,
) -> List[RectifiedFlowModel]:
    """Reflow-K: each round makes a student from the current teacher,
    synthesizes pairs with the teacher, trains the student, and promotes it to
    teacher; the teacher's sampling steps halve each round (floor 10).
    ``real_data_loader`` is accepted for signature parity and unused.

    ``init_from_teacher`` starts each student at the teacher's weights (the
    original Rectified Flow recipe). With ``ema_decay`` and ``save_dir`` each
    round's EMA weights become the returned model's weights and the next
    round's teacher.
    """
    models: List[RectifiedFlowModel] = []
    current_teacher = initial_model
    for k in range(num_iterations):
        log.info("=" * 60)
        log.info("REFLOW ITERATION %d/%d", k + 1, num_iterations)
        log.info("=" * 60)
        student = RectifiedFlowModel.from_base_model(
            current_teacher, seed=seed + 1000 * (k + 1), copy_weights=init_from_teacher
        )
        student.reflow_iteration = k + 1
        x0_data, x1_data = generate_reflow_pairs(
            current_teacher,
            num_pairs=num_pairs,
            batch_size=pair_batch_size,
            num_steps=teacher_steps,
            seed=seed + k,
            data_format="NHWC",
            method=teacher_method,
            real_data=real_data,
            data_pair_fraction=data_pair_fraction,
        )
        save_path = f"{save_dir}/reflow_k{k + 1}" if save_dir else None
        train_rectified_flow(
            student,
            x0_data,
            x1_data,
            epochs=epochs_per_iter,
            batch_size=batch_size,
            lr=lr,
            save_path=save_path,
            seed=seed + k,
            data_format="NHWC",
            mesh=mesh,
            fsdp=fsdp,
            ema_decay=ema_decay,
            time_sampling=time_sampling,
        )
        if ema_decay is not None and ema_decay > 0 and save_path:
            student.params = ckpt_io.load_params(f"{save_path}_ema_final.npz")[0]
        models.append(student)
        current_teacher = student
        teacher_steps = max(teacher_steps // 2, 10)
    return models
