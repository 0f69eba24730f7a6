"""Execution-backend plugin registry of the PyTorch port.

Counterpart of `kcmc_tpu/backends/__init__.py`: the orchestrator stays
backend-agnostic and `backend=` selects the implementation. Backends
register themselves under a string name; the `MotionCorrector` looks
them up here.

Built-in backends:

* ``"torch"`` — the hand-written CUDA kernels on the card, or their
  plain PyTorch versions with ``device="cpu"`` (`torch_backend.py`).
* ``"numpy"`` — the pure-NumPy mirror of the same algorithm
  (`numpy_backend.py`), the host oracle the port's parity is judged
  against. It imports no torch.

Third-party backends can call :func:`register_backend` directly. This
module imports no torch: the built-ins are imported the first time a
name is looked up.
"""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_backend(name: str):
    """Class decorator: register an execution backend under `name`."""

    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtins() -> None:
    # Import for side effect: the modules self-register. Lazy, so that
    # importing the registry (or the numpy oracle) never pays the torch
    # import.
    import importlib

    for mod in ("kcmc_tpu_torch.backends.torch_backend",
                "kcmc_tpu_torch.backends.numpy_backend"):
        try:
            importlib.import_module(mod)
        except ImportError:
            pass


def available_backends() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def get_backend(name: str, config, **options):
    """Instantiate the backend registered under `name`.

    `options` are backend-specific (`device=` and `mesh=` for the torch
    backend).
    """
    if name not in _REGISTRY:
        _ensure_builtins()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        )
    return _REGISTRY[name](config, **options)
