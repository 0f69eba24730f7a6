"""The persistent kernel cache and the plan-stamp registry (the port's
counterpart of kcmc_tpu/plans/cache.py).

Two layers make a cold process start warm:

* **The kernel libraries.** The port has no traced program to
  serialize: what a new process would otherwise rebuild is the nvcc
  output of every `csrc/*.cu` source. While a cache directory is active
  (`enable_compile_cache`, from the `compile_cache_dir` config field or
  the `KCMC_COMPILE_CACHE` environment variable), `ops/cuda_build.py`
  builds and loads its libraries under
  `<cache_dir>/kcmc_tpu_torch_kernels/`, named by the hash of their
  sources and flags as always; a second process finds them there and
  runs no nvcc.
* **Plan stamps** (`PlanCache`): one small JSON file per program under
  `<cache_dir>/kcmc_plans/`, recording which programs an earlier
  process already built with that cache, keyed by (program, shape
  bucket, dtype, rung, config digest, package, torch and CUDA versions,
  device, code fingerprint). `stamp_misses == 0` on a rerun is the
  machine-checkable "the second process built nothing new" contract.

Stamps are only read and written while a cache directory is active,
and a stamp counts as a hit only while every kernel library its
program launches is present under the directory (`check(key,
artifacts)`) and a warmup did not have to build it first: a stamp
without the libraries under it would claim a warmth the directory
cannot deliver.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading

from kcmc_tpu_torch.ops import cuda_build

_ENABLE_LOCK = threading.Lock()
_ENABLED_DIR: str | None = None

KERNEL_SUBDIR = "kcmc_tpu_torch_kernels"


def enable_compile_cache(path: str) -> str:
    """Make `path` the process's persistent cache directory (process
    global; idempotent per directory). Returns the active directory.

    The first writer wins: a second request for another directory keeps
    the first one (with an advisory warning), so every runtime of one
    process stamps programs under the directory the kernel libraries
    really live in."""
    global _ENABLED_DIR
    path = os.path.abspath(path)
    with _ENABLE_LOCK:
        if _ENABLED_DIR == path:
            return _ENABLED_DIR
        if _ENABLED_DIR is not None:
            from kcmc_tpu_torch.obs.log import advise

            advise(
                f"kcmc: compile cache already active at {_ENABLED_DIR}; "
                f"ignoring the request to re-point it at {path} (one "
                "persistent cache per process)",
                stacklevel=3,
            )
            return _ENABLED_DIR
        os.makedirs(path, exist_ok=True)
        _ENABLED_DIR = path
        cuda_build.set_lib_dir(os.path.join(path, KERNEL_SUBDIR))
        return _ENABLED_DIR


def disable_compile_cache() -> None:
    """Unset the persistent cache directory (tests: a temporary cache
    must not outlive its test). Libraries already loaded stay loaded."""
    global _ENABLED_DIR
    with _ENABLE_LOCK:
        _ENABLED_DIR = None
        cuda_build.set_lib_dir(None)


def active_compile_cache_dir() -> str | None:
    return _ENABLED_DIR


class PlanCache:
    """Stamp registry under `<root>/kcmc_plans/` (root = the cache
    directory; None disables: checks report misses-free inactivity and
    stamps are skipped)."""

    def __init__(self, root: str | None):
        self.root = (
            os.path.join(os.path.abspath(root), "kcmc_plans") if root else None
        )

    @property
    def persistent(self) -> bool:
        return self.root is not None

    @staticmethod
    def program_key(**fields) -> str:
        """Deterministic key of a program: sha256 of the canonical JSON
        of its identity fields, 24 hex characters."""
        canon = json.dumps(
            {k: fields[k] for k in sorted(fields)},
            sort_keys=True,
            separators=(",", ":"),
            default=str,
        )
        return hashlib.sha256(canon.encode()).hexdigest()[:24]

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def check(self, key: str, artifacts=()) -> bool:
        """Whether an earlier process stamped this program key and every
        file in `artifacts` (the program's kernel libraries) is still
        there."""
        if self.root is None:
            return False
        try:
            return os.path.exists(self._path(key)) and all(
                os.path.exists(a) for a in artifacts)
        except OSError:
            return False

    def load(self, key: str) -> dict | None:
        """A stamp's recorded metadata (None when absent or unreadable)."""
        if self.root is None:
            return None
        try:
            with open(self._path(key), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stamp(self, key: str, meta: dict) -> None:
        """Record a built program (atomic write; best effort: a
        read-only cache directory must not fail the run)."""
        if self.root is None:
            return
        try:
            os.makedirs(self.root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(meta, f, default=str)
                    f.write("\n")
                os.replace(tmp, self._path(key))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass
