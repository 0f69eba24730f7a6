"""Run manifest: what exactly ran, hashed for cross-run attribution (the
port's copy of kcmc_tpu/obs/manifest.py).

A throughput or quality trajectory across runs is only attributable
when each artifact records the resolved configuration and environment
it came from. `build_manifest` captures the resolved `CorrectorConfig`
(plus a sha256 of its canonical JSON — two runs with the same digest
ran the same pipeline; the plan stamps key on it too, plans/runtime.py),
the package, python, torch, CUDA and numpy versions, the backend's
device description (`TorchBackend.runtime_info`) and the armed fault
plan. It is embedded in the Chrome-trace metadata and the frame-records
JSONL header, in the reference's schema, so either package's report
reads either package's artifacts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import sys
import time


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def config_digest(config) -> tuple[dict, str]:
    """(resolved config as a JSON-safe dict, sha256 of its canonical
    JSON). Key-sorted serialization, so the digest does not depend on
    field order."""
    cfg = {k: _jsonable(v) for k, v in dataclasses.asdict(config).items()}
    canon = json.dumps(cfg, sort_keys=True, separators=(",", ":"))
    return cfg, hashlib.sha256(canon.encode()).hexdigest()


def runtime_versions() -> dict:
    """Package, interpreter and accelerator-stack versions. torch is
    named only when already imported: report-only processes never pay
    for an accelerator import."""
    from kcmc_tpu_torch import __version__

    import numpy as np_mod

    out = {
        "kcmc_tpu_torch": __version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch"] = getattr(torch, "__version__", "unknown")
        version = getattr(torch, "version", None)
        out["cuda"] = getattr(version, "cuda", None)
    out["numpy"] = np_mod.__version__
    return out


def device_inventory() -> list[dict]:
    """The visible cards, when torch is imported and CUDA is already
    initialized; never initializes CUDA itself and never raises."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        return [
            {
                "id": i,
                "platform": "gpu",
                "kind": str(torch.cuda.get_device_name(i)),
            }
            for i in range(torch.cuda.device_count())
        ]
    except Exception:
        return []


def build_manifest(
    config=None,
    backend=None,
    backend_name: str | None = None,
    extra: dict | None = None,
) -> dict:
    """Assemble the run manifest.

    `backend` may expose a `runtime_info()` seam (TorchBackend does)
    describing its execution environment; otherwise the generic card
    inventory is recorded.
    """
    manifest: dict = {
        "kind": "kcmc_run_manifest",
        "version": 1,
        "created_unix_s": round(time.time(), 3),
        "versions": runtime_versions(),
        "argv": list(sys.argv),
    }
    if backend_name:
        manifest["backend"] = backend_name
    info = getattr(backend, "runtime_info", None)
    if info is not None:
        try:
            manifest["backend_runtime"] = _jsonable(info())
        except Exception:
            pass
    if "backend_runtime" not in manifest:
        devs = device_inventory()
        if devs:
            manifest["backend_runtime"] = {"devices": devs}
    if config is not None:
        cfg, digest = config_digest(config)
        manifest["config"] = cfg
        manifest["config_sha256"] = digest
        manifest["fault_plan"] = cfg.get("fault_plan")
    if extra:
        manifest.update(_jsonable(extra))
    return manifest


def slim_manifest() -> dict:
    """The compact environment stamp: versions plus the first card's
    identity, no config."""
    out = {"versions": runtime_versions()}
    devs = device_inventory()
    if devs:
        out["device"] = devs[0]
        out["n_devices"] = len(devs)
    return out
