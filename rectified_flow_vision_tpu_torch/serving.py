"""Sampling service: few-step image generation at a fixed batch shape.

Counterpart of the JAX package's ``serving.py``:

* ``SamplerService`` prepares one sampler per configured step count and
  runs each once at start-up (``warmup``), so the first request pays no
  kernel build;
* requests of any ``n`` are served from the fixed batch shape (largest-batch
  tiling, then truncation), and images are clipped to [-1, 1];
* noise comes from a seeded ``torch.Generator`` on the model's device, so a
  service built with the same seed returns the same images;
* with a ``vae`` the flow model samples latents and a ConvVAE decode (bf16,
  clipped to [-1, 1]) maps them to pixel images before they are returned;
* a conditional model (``model.cond_shapes``: FLUX) is served with ``cond``,
  its rows by name, one per image (host or device tensors); ``generate``
  stages each batch's rows on the device next to its noise, the last row
  repeated into the padding rows. An unconditional model takes none;
* with a ``mesh`` (``parallel.mesh.create_mesh``; every rank builds the
  service alike and calls it alike) the parameters are tensor-parallel over
  ``model``, each data rank samples its rows of every batch and the rows are
  gathered, so ``generate`` returns the whole batch on every rank, the same
  images as without a mesh;
* ``stats`` counts, for every ``generate`` call (``generate_calls``), the
  seconds spent issuing its work on the host (``enqueue_sum_s``: from the
  call's start to the stream synchronise; where the launch queue fills, as
  in a DiT call, that includes device time), waiting for the device in that
  synchronise (``device_wait_sum_s``) and copying the images to the host
  (``to_host_sum_s``), and the rows computed and not returned
  (``padded_images``: a call pays whole batches), and for a conditional
  model the conditioning rows staged (``cond_rows``, padding included) and
  the seconds staging them (``cond_sum_s``). ``serving_http.Batcher``
  copies them into its own ``stats`` after each call. Spans
  (``utils.profiling.annotate``): ``rfv.generate`` around the call,
  ``rfv.generate.noise`` per batch's noise, ``rfv.generate.cond`` per
  batch's conditioning, ``rfv.decode`` per decode,
  ``rfv.generate.device_wait`` and ``rfv.generate.to_host``.

Example:
    svc = SamplerService.from_checkpoint("checkpoints/rectified_flow_k1_final.npz",
                                         step_counts=(1, 2, 4), batch_size=256)
    images = svc.generate(1000, num_steps=4)   # [1000, C, H, W] in [-1, 1]
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rectified_flow_vision_tpu_torch.models.base_flow import BaseFlowModel, _from_nhwc
from rectified_flow_vision_tpu_torch.parallel import mesh as mesh_lib
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger
from rectified_flow_vision_tpu_torch.utils.profiling import annotate

log = get_logger("flow_vision.serving")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_cond(shapes: Optional[Dict[str, Tuple[int, ...]]], n: int, cond) -> None:
    """Raise unless ``cond`` is what a model of conditioning ``shapes`` (its
    ``cond_shapes``) takes for ``n`` images: none where ``shapes`` is None,
    else its rows by name, ``n`` each."""
    if shapes is None:
        if cond is not None:
            raise ValueError("this model takes no conditioning; cond must be None")
        return
    want = {k: (n, *shape) for k, shape in shapes.items()}
    if cond is None:
        raise ValueError(f"this model needs a prompt's encoder outputs: cond {want}")
    got = {k: tuple(c.shape) for k, c in cond.items()}
    if got != want:
        raise ValueError(f"cond {got}; this model takes {want}")


class SamplerService:
    """Few-step sampler around a flow model, at one fixed batch shape."""

    def __init__(
        self,
        model: BaseFlowModel,
        *,
        step_counts: Sequence[int] = (1, 2, 4, 8),
        batch_size: int = 256,
        method: str = "euler",
        seed: int = 0,
        mesh=None,
        warmup: bool = True,
        vae=None,
        vae_params=None,
    ) -> None:
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            dp = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
            if batch_size % dp:
                raise ValueError(f"batch_size {batch_size} does not split over {dp} data ranks")
            mesh_lib.shard_params(mesh, model)
        self.batch_size = batch_size
        self.method = method
        self.step_counts = tuple(step_counts)
        self.device = model.device
        self.cond_shapes: Optional[Dict[str, Tuple[int, ...]]] = model.cond_shapes
        if mesh is not None and self.cond_shapes is not None:
            raise ValueError("a conditional model is not served on a mesh")
        self.stats = {"generate_calls": 0, "enqueue_sum_s": 0.0, "device_wait_sum_s": 0.0,
                      "to_host_sum_s": 0.0, "padded_images": 0, "cond_rows": 0,
                      "cond_sum_s": 0.0}
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._noise_shape = (batch_size, model.image_size, model.image_size, model.in_channels)
        # latent pipeline: the flow model samples latents, and the ConvVAE
        # decode (clipped to [-1, 1]) maps them to pixels
        self._decode = None
        if vae is not None:
            from rectified_flow_vision_tpu_torch.models.autoencoder import LatentFlowPipeline

            self._decode = LatentFlowPipeline(model, vae, vae_params).decode
        self._samplers = {
            n: model._get_sampler(n, False, model.sample_dtype, method) for n in self.step_counts
        }
        if warmup:
            self.warmup()

    @classmethod
    def from_checkpoint(
        cls, path: str, *, vae_path: Optional[str] = None,
        device: str | torch.device = "cuda", **kwargs,
    ) -> "SamplerService":
        """Load a flow checkpoint (.npz or reference .pt) onto ``device``;
        ``vae_path`` makes it a latent service (sample latents, decode to
        pixels)."""
        model = BaseFlowModel.from_checkpoint(path, device=device)
        if vae_path is not None:
            from rectified_flow_vision_tpu_torch.models.autoencoder import ConvVAE

            kwargs.update(vae=ConvVAE.load(vae_path, device=device))
        return cls(model, **kwargs)

    # ---- lifecycle ---------------------------------------------------------

    def warmup(self) -> Dict[int, float]:
        """Run every configured sampler once; returns seconds per step count
        (the first includes building the CUDA kernels)."""
        stats: Dict[int, float] = {}
        noise = torch.zeros(self._noise_shape, dtype=torch.float32, device=self.device)
        cond = self._zero_cond()
        for n, sampler in self._samplers.items():
            t0 = time.perf_counter()
            self._run(functools.partial(sampler, cond=cond), noise)
            _sync(self.device)
            stats[n] = time.perf_counter() - t0
            log.info("warmed num_steps=%d in %.1fs", n, stats[n])
        return stats

    def _run(self, sampler, noise: torch.Tensor) -> torch.Tensor:
        """One batch: the sampler (bound to the batch's conditioning rows),
        then the decode of a latent service; on a mesh, of this rank's rows,
        then gathered."""
        out = sampler(mesh_lib.shard_batch(self.mesh, noise))
        if self._decode is not None:
            with annotate("rfv.decode"):
                out = self._decode(out)
        return out if self.mesh is None else mesh_lib.gather_batch(self.mesh, out)

    def _zero_cond(self) -> Optional[Dict[str, torch.Tensor]]:
        """A batch of zero conditioning rows (warm-up, throughput), or None."""
        if self.cond_shapes is None:
            return None
        return {k: torch.zeros((self.batch_size, *shape), device=self.device)
                for k, shape in self.cond_shapes.items()}

    def _gathered(self, sampler):
        """The sampler on this rank's rows, its output gathered."""
        return lambda x: mesh_lib.gather_batch(self.mesh, sampler(mesh_lib.shard_batch(self.mesh, x)))

    def _noise(self) -> torch.Tensor:
        with annotate("rfv.generate.noise"):
            return torch.randn(
                self._noise_shape, generator=self._generator, dtype=torch.float32,
                device=self.device,
            )

    def _stage(self, cond, start: int) -> Dict[str, torch.Tensor]:
        """One batch's conditioning rows on the device: rows ``start`` on,
        the last row repeated into the padding rows."""
        with annotate("rfv.generate.cond"):
            out = {}
            for k, rows in cond.items():
                rows = torch.as_tensor(rows)[start:start + self.batch_size]
                pad = self.batch_size - rows.shape[0]
                rows = rows.to(self.device, torch.float32)
                if pad:
                    rows = torch.cat([rows, rows[-1:].expand(pad, *rows.shape[1:])])
                out[k] = rows
            return out

    # ---- serving -------------------------------------------------------------

    def generate(
        self, n: int, num_steps: Optional[int] = None, *, data_format: str = "NCHW",
        cond=None,
    ) -> np.ndarray:
        """Generate ``n`` images; always runs the configured batch shape. A
        conditional model takes ``cond``: its rows by name, ``n`` each."""
        num_steps = num_steps if num_steps is not None else self.step_counts[0]
        if num_steps not in self._samplers:
            raise ValueError(
                f"num_steps={num_steps} not precompiled; configured: {self.step_counts}"
            )
        check_cond(self.cond_shapes, n, cond)
        sampler = self._samplers[num_steps]
        t0 = time.perf_counter()
        cond_s = 0.0
        with annotate("rfv.generate"):
            outs = []
            for start in range(0, n, self.batch_size):
                rows = None
                if cond is not None:
                    c0 = time.perf_counter()
                    rows = self._stage(cond, start)
                    cond_s += time.perf_counter() - c0
                outs.append(self._run(functools.partial(sampler, cond=rows), self._noise()))
            result = _from_nhwc(torch.clamp(torch.cat(outs)[:n], -1.0, 1.0), data_format)
            t1 = time.perf_counter()
            # the copy below waits for the stream too: waiting first times it alone
            with annotate("rfv.generate.device_wait"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            t2 = time.perf_counter()
            with annotate("rfv.generate.to_host"):
                images = result.cpu().numpy()
            t3 = time.perf_counter()
        s = self.stats
        # one update: a copy of the dict taken on another thread sees each sum
        # with its count
        s.update(generate_calls=s["generate_calls"] + 1,
                 enqueue_sum_s=s["enqueue_sum_s"] + (t1 - t0),
                 device_wait_sum_s=s["device_wait_sum_s"] + (t2 - t1),
                 to_host_sum_s=s["to_host_sum_s"] + (t3 - t2),
                 padded_images=s["padded_images"] + len(outs) * self.batch_size - n,
                 cond_rows=s["cond_rows"] + (0 if cond is None else len(outs) * self.batch_size),
                 cond_sum_s=s["cond_sum_s"] + cond_s)
        return images

    def throughput(self, num_steps: int, iters: int = 8) -> float:
        """Steady-state images/sec, each batch fed the previous batch's output
        (a latent service decodes every batch besides; on a mesh, each rank
        its rows, the output gathered)."""
        sampler = functools.partial(self._samplers[num_steps], cond=self._zero_cond())
        if self.mesh is not None:
            sampler = self._gathered(sampler)
        x = sampler(self._noise())
        if self._decode is not None:
            self._decode(x)
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            x = sampler(x)
            if self._decode is not None:
                self._decode(x)
        _sync(self.device)
        return self.batch_size * iters / (time.perf_counter() - t0)


def main() -> None:
    """CLI: generate samples from a checkpoint and save them as .npy.

    python -m rectified_flow_vision_tpu_torch.serving \
        --checkpoint checkpoints/rectified_flow_k1_final.npz \
        --num 16 --steps 4 --out results/served_samples.npy

    With ``--vae checkpoints/dit256/vae.npz`` the checkpoint is a latent-space
    flow model and the samples are decoded to pixels.
    """
    import argparse
    from pathlib import Path

    parser = argparse.ArgumentParser(description="Flow sampler service (PyTorch / CUDA)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--num", type=int, default=16)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--method", default="euler", choices=["euler", "midpoint", "heun"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="results/served_samples.npy")
    parser.add_argument("--vae", default=None, metavar="VAE_NPZ",
                        help="ConvVAE checkpoint: serve a latent-space flow model, "
                             "decoding samples to pixels")
    parser.add_argument("--bench", action="store_true", help="also print steady-state throughput")
    args = parser.parse_args()

    svc = SamplerService.from_checkpoint(
        args.checkpoint,
        vae_path=args.vae,
        device=args.device,
        step_counts=(args.steps,),
        batch_size=min(args.batch_size, max(args.num, 1)),
        method=args.method,
        seed=args.seed,
    )
    imgs = svc.generate(args.num, num_steps=args.steps)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.save(args.out, imgs)
    log.info("wrote %d samples to %s", args.num, args.out)
    if args.bench:
        log.info("throughput: %.1f img/s at %d steps", svc.throughput(args.steps), args.steps)


if __name__ == "__main__":
    main()
