"""ExecutionPlan: the warm-up of every hot program (the port's
counterpart of kcmc_tpu/plans/plan.py).

A cold process pays its first batch's latency in building and loading
the kernel libraries, creating library handles and growing the
allocator's pool, not in the card's work. `ExecutionPlan.build()` first
builds every kernel library its programs launch, in one parallel nvcc
round, then walks the declared shape buckets x dtypes and drives each
hot program through the backend's real entry points with zero-filled
inputs: reference preparation, the registration batch program (and for
integer dtypes the device-side output cast), the rolling-template
`update_reference` program and, for 2D models, the apply warp. Each
first run goes through the backend's `PlanRuntime.timed` (plan stamps,
hit and miss counters, `kcmc.plan_build` profiler ranges). With a
persistent cache directory (`compile_cache_dir` / `KCMC_COMPILE_CACHE`)
the libraries are built into it, so a second process's warm-up runs no
nvcc and reports `stamp_misses == 0`.

Warm by execution, as the reference: the port runs eagerly, so there is
no program to capture on the side; running the real entry points once
is what leaves the process in the state production traffic needs. A
backend without a plan runtime (the numpy oracle, a plugin) is warmed
the same way, through whichever of its entry points it has, and its
summary carries no stamp counters (kcmc_tpu/plans/plan.py:98-146).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

_DEFAULT_PROGRAMS = ("reference", "register", "update_reference", "apply")


def kernel_libraries(backend, programs) -> list[str]:
    """The kernel libraries (`ops/cuda_build.SOURCES` names) the given
    programs launch on `backend`'s device under its config; none on the
    CPU, where every wrapper takes its plain version, nor for a backend
    without a device (the numpy oracle)."""
    from kcmc_tpu_torch.config import BINS_FIRST_MIN_K
    from kcmc_tpu_torch.ops import cuda_warp_field
    from kcmc_tpu_torch.ops.cuda_warp import warp_translation
    from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix

    device = getattr(backend, "device", None)
    if device is None or device.type != "cuda":
        return []
    cfg = backend.config
    progs = set(programs)
    libs = set()
    if progs & {"reference", "register", "update_reference"}:
        libs.add("detect")
        if backend.precision == "float32":
            libs.add("patches")
        elif cfg.resolved_oriented() and cfg.max_keypoints >= BINS_FIRST_MIN_K:
            libs.update(("moments", "patch", "select"))
        else:
            libs.add("patch")
    if "register" in progs:
        if cfg.model == "piecewise":
            if cfg.warp != "jnp" and cuda_warp_field.supports(cfg.patch_grid, cfg.max_flow_px):
                libs.add("warp_field")
        else:
            warp = backend._resolve_batch_warp((512, 512))
            fn = warp.func if isinstance(warp, functools.partial) else warp
            if fn is warp_translation:
                libs.add("warp")
            elif fn is warp_batch_matrix:
                libs.add("warp_matrix")
    if "apply" in progs:
        if cfg.model != "piecewise":
            libs.add("warp_matrix")
        elif cuda_warp_field.supports(cfg.patch_grid, 6):
            libs.add("warp_field")
    return sorted(libs)


class ExecutionPlan:
    """The warm-up of one corrector's hot programs.

    corrector: the `MotionCorrector` whose backend and config to warm
        (normally through `MotionCorrector.warmup(...)`); it supplies the
        batch size, the rolling-template knobs and the backend.
    buckets: shape buckets to build for; default the config's
        `plan_buckets`. Must be non-empty.
    dtypes: input dtypes to warm per bucket (each uploads and pads in its
        own dtype); default ("float32",). Integer dtypes also warm the
        device-side output cast.
    programs: subset of ("reference", "register", "update_reference",
        "apply"); default all that apply (`update_reference` only with
        rolling templates armed).
    """

    def __init__(self, corrector, buckets=None, dtypes=None, programs=None):
        from kcmc_tpu_torch.plans.buckets import normalize_buckets

        self.mc = corrector
        self.backend = corrector.backend
        self.config = corrector.config
        plan = getattr(self.backend, "_plan", None)
        if self.config.model == "rigid3d":
            raise ValueError(
                "execution plans cover 2D models; rigid3d volumes "
                "compile per (D, H, W) shape on first use"
            )
        self.buckets = (normalize_buckets(buckets) if buckets is not None
                        else plan.buckets if plan is not None else ())
        if not self.buckets:
            raise ValueError(
                "no shape buckets to build — set plan_buckets in the "
                "config (or pass buckets=) so the plan knows which "
                "shapes to compile for"
            )
        self.dtypes = tuple(str(np.dtype(d)) for d in (dtypes or ("float32",)))
        progs = tuple(programs) if programs is not None else _DEFAULT_PROGRAMS
        if "update_reference" in progs and (corrector.template_update_every <= 0
                                            or not hasattr(self.backend, "update_reference")):
            progs = tuple(p for p in progs if p != "update_reference")
        self.programs = progs

    def build(self, progress: bool = False) -> dict:
        """Build every (bucket, dtype) program; returns the summary
        (counts, stamp hits and misses, seconds, the kernel libraries and
        their build seconds, and the backend's plan-cache snapshot)."""
        from kcmc_tpu_torch.ops import cuda_build

        backend = self.backend
        plan = getattr(backend, "_plan", None)
        before = plan.stats() if plan is not None else None
        t0 = time.perf_counter()
        names = kernel_libraries(backend, self.programs)
        libs = cuda_build.build(names) if names else {}
        if plan is not None:
            plan.fresh.update(cuda_build.target(n) for n, v in libs.items() if not v["cached"])
            plan.building = True
        libraries_s = time.perf_counter() - t0
        if progress and names:
            print(f"[plan] kernel libraries {names} ready", flush=True)
        built = []
        try:
            for bucket in self.buckets:
                ref = None
                if {"reference", "register", "update_reference"} & set(self.programs):
                    ref = backend.prepare_reference(np.zeros(bucket, np.float32))
                    built.append(("reference", bucket, "float32"))
                    if progress:
                        print(f"[plan] reference {bucket} ready", flush=True)
                first_out = None
                for dt in self.dtypes:
                    if "register" in self.programs:
                        out = self._build_register(ref, bucket, dt)
                        if first_out is None:
                            first_out = out
                        built.append(("register", bucket, dt))
                        if progress:
                            print(f"[plan] register {bucket} {dt} ready", flush=True)
                if "update_reference" in self.programs and first_out is not None:
                    # dtype-invariant: the blend runs in float32
                    self._build_update(ref, first_out)
                    built.append(("update_reference", bucket, "float32"))
                if "apply" in self.programs:
                    self._build_apply(bucket)
                    built.append(("apply", bucket, "float32"))
        finally:
            if plan is not None:
                plan.building = False
        summary = {
            "buckets": [list(b) for b in self.buckets],
            "dtypes": list(self.dtypes),
            "programs": list(self.programs),
            "programs_built": len(built),
            "build_s": round(time.perf_counter() - t0, 3),
            "libraries": {n: {"cached": v["cached"], "seconds": round(v["seconds"], 3)}
                          for n, v in libs.items()},
            "libraries_s": round(libraries_s, 3),
        }
        if plan is not None:
            after = plan.stats()
            for k in ("stamp_hits", "stamp_misses", "programs_compiled"):
                summary[k] = after[k] - before[k]
            summary["compile_s"] = round(after["compile_s"] - before["compile_s"], 3)
            summary["persistent"] = after["persistent"]
            summary["cache_dir"] = after["cache_dir"]
            summary["plan_cache"] = after
        return summary

    # -- one warm-up per program -------------------------------------------

    def _build_register(self, ref, bucket, dtype):
        B = self.config.batch_size
        dt = np.dtype(dtype)
        batch = np.zeros((B,) + tuple(bucket), dt)
        idx = np.arange(B, dtype=np.int64)
        if getattr(self.backend, "process_batch_async", None) is None:
            # a synchronous backend: the plain entry point, host outputs
            return self.backend.process_batch(batch, ref, idx)
        cast = dt if np.issubdtype(dt, np.integer) else None
        out = self.backend.process_batch(batch, ref, idx, to_host=False, cast_dtype=cast)
        # read one small per-frame output back: the run has finished
        out["n_inliers"].cpu()
        return out

    def _build_update(self, ref, out):
        mc = self.mc
        W = min(mc.template_window, mc.template_update_every)
        corrected = out.get("corrected")
        if corrected is None:
            return
        if isinstance(corrected, torch.Tensor):
            corrected = corrected[:W].to(torch.float32)
            ok = torch.ones(corrected.shape[0], dtype=torch.bool, device=corrected.device)
        else:
            corrected = np.asarray(corrected[:W], np.float32)
            ok = np.ones(len(corrected), bool)
        self.backend.update_reference(ref, [corrected], [ok], W, mc.template_update_alpha)

    def _build_apply(self, bucket) -> None:
        """Warm `apply_correction`'s batch warp for this bucket at the
        corrector's batch size (K7 for the matrix models, K8 for
        piecewise grids it takes); only the torch backend's, as the
        reference warms only its jax backend's (plan.py:206)."""
        from kcmc_tpu_torch.ops.warp import fast_apply_fields, fast_apply_matrix

        backend = self.backend
        if getattr(backend, "name", "") != "torch":
            return
        B = self.config.batch_size
        dev = backend.device
        frames = torch.zeros((B,) + tuple(bucket), dtype=torch.float32, device=dev)
        with backend._plan.maybe_timed("apply", bucket, "float32"):
            if self.config.model == "piecewise":
                gh, gw = self.config.patch_grid
                fast_apply_fields(frames, torch.zeros((B, gh, gw, 2), device=dev))
            else:
                eye = torch.eye(3, dtype=torch.float32, device=dev)
                fast_apply_matrix(frames, eye.expand(B, 3, 3).contiguous())
