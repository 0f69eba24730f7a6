"""The config digest of a run (the port's copy of `config_digest` from
kcmc_tpu/obs/manifest.py): the resolved `CorrectorConfig` as a
JSON-safe dict and the sha256 of its canonical JSON, so two runs with
the same digest ran the same pipeline. The plan stamps key on it
(plans/runtime.py)."""

from __future__ import annotations

import dataclasses
import hashlib
import json


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
