"""Transform models of the PyTorch port: solve / apply / residual for
each geometric family (the port's copy of kcmc_tpu/models/__init__.py's
exports; see the package docstring)."""

from kcmc_tpu_torch.models.transforms import (
    MODELS,
    TransformModel,
    apply_transform,
    get_model,
)

__all__ = ["MODELS", "TransformModel", "apply_transform", "get_model"]
