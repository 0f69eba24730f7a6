"""Static and runtime analysis of the port itself (the port's copy of
kcmc_tpu/analysis: `python -m kcmc_tpu_torch check` and `sanitize`),
plus the roofline model (roofline.py).

Six passes over a shared module index check the contracts that
otherwise live only in comments:

* ``config-registry`` — every `CorrectorConfig` field classified as
  resume-signature neutral or affecting, and validated at construction;
* ``lock-discipline`` — lock-order cycles and the "kernel builds and
  card work only on non-daemon threads" rule (``daemon-cuda``);
* ``span-registry`` — every trace-span and `timing` key literal drawn
  from the canonical `obs/registry.py` vocabulary;
* ``thread-roots`` — the concurrent-entry-point inventory (named,
  statically-resolvable threads) feeding the cross-module call graph;
* ``race`` — whole-program happens-before race detection: shared
  accesses from concurrent roots with disjoint lock sets, with
  program-wide lock identity (Condition/constructor-param aliasing);
* ``resource-lifecycle`` — every acquired thread/pool/socket/file/
  telemetry resource reaches its release on all paths.

The JAX package's ``jit-purity``, ``traceflow`` and ``donation`` check
traced programs; the port traces none, so they do not apply.

The runtime half (`analysis/sanitize.py`, behind `sanitize` /
`KCMC_SANITIZE=1`) instruments real locks, validates executed
acquisition order against the static lock-order graph, watches for
deadlocks, leak-checks, and hosts the retrace sentinel. Results are
content-hash cached under `.kcmc_torch_check_cache/`
(`analysis/cache.py`; `check --no-cache` bypasses).

Stdlib-only on purpose: the checker runs before (and without) torch.
"""

from kcmc_tpu_torch.analysis.cli import default_passes, main, run_check
from kcmc_tpu_torch.analysis.core import (
    Baseline,
    BaselineEntry,
    CheckResult,
    Finding,
    Module,
    ModuleIndex,
    run_passes,
)

__all__ = [
    "Baseline",
    "BaselineEntry",
    "CheckResult",
    "Finding",
    "Module",
    "ModuleIndex",
    "default_passes",
    "main",
    "run_check",
    "run_passes",
]
