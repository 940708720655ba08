"""Rectified Flow (Reflow) student model.

Counterpart of the JAX package's ``models/rectified_flow.py``: the
``RectifiedFlowModel`` class (its config carries ``reflow_iteration``) and
``from_base_model``, so that ``BaseFlowModel.from_checkpoint`` dispatches
as it does in JAX. Pair generation and reflow training come with the
training slice.
"""

from __future__ import annotations

from rectified_flow_vision_tpu_torch.models.base_flow import _DTYPE_NAMES, BaseFlowModel


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
