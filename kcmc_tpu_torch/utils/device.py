"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. With no card and no explicit device this raises —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_full_precision() -> None:
    """Full float32 matmuls and convolutions on the card: the reference
    pins Precision.HIGHEST for the polish einsums and transform
    composes, and TF32 keeps only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_tensor(x, name: str, dtype, ndim: int) -> None:
    """Wrapper argument check: a contiguous tensor of the given dtype
    and rank."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_route(*tensors) -> bool:
    """True when the tensors lie on the card (launch the kernel), False
    when they lie on the CPU (the plain version). Any other placement,
    or a mix, raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one cuda device or all on the cpu, got {types}")
