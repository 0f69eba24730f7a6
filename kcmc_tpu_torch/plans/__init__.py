"""Execution plans: shape buckets, warm-up and the persistent kernel
cache (the port's counterpart of kcmc_tpu/plans).

Declare a ladder of frame-shape buckets (`plan_buckets`): a 2D
matrix-model input whose shape is not a bucket is zero-padded to the
smallest covering bucket, registered there with detection, sanitize
statistics and every warp masked to its valid extent, and sliced back,
so arbitrary crop sizes run on a fixed set of warm programs.
`MotionCorrector.warmup()` (`ExecutionPlan`) runs every hot program
once per bucket and dtype on zero-filled inputs. With
`compile_cache_dir` / `KCMC_COMPILE_CACHE` the kernel libraries are
built into that directory and every program is stamped there, so a new
process builds nothing: `stamp_misses == 0` and no nvcc run. Counters
land in `timing["plan_cache"]`.

The package init is lazy: `config.py` imports `plans.buckets`, which
imports no torch.
"""

__all__ = [
    "ExecutionPlan",
    "PlanCache",
    "PlanRuntime",
    "active_compile_cache_dir",
    "disable_compile_cache",
    "enable_compile_cache",
    "normalize_buckets",
    "predict_compile_keys",
    "route_shape",
]

_HOME = {
    "ExecutionPlan": "plan",
    "PlanCache": "cache",
    "PlanRuntime": "runtime",
    "active_compile_cache_dir": "cache",
    "disable_compile_cache": "cache",
    "enable_compile_cache": "cache",
    "normalize_buckets": "buckets",
    "predict_compile_keys": "runtime",
    "route_shape": "buckets",
}


def __getattr__(name):
    if name in _HOME:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
