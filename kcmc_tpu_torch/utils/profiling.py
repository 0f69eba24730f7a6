"""Honest device timing, profiler traces and the per-stage breakdown
(the port's counterpart of kcmc_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the card has run it, so a host
clock around a loop of calls measures the enqueue. The protocol here:

1. Warm up with a synchronise after every call, for at least
   `min_warmup_s` of wall time: the first calls build kernels, fill the
   allocator and run at a cold clock.
2. On the card, record a CUDA event, issue `iters` calls back to back
   (the stream is in order), record a second event and synchronise:
   the elapsed event time over `iters` is the device time per call,
   host launch gaps included where a call's host time exceeds its
   device time. On the CPU every call is synchronous, so the host clock
   around the loop is the time.

`stage_breakdown` times cumulative prefixes of the registration
pipeline (detect / +describe / +match / +consensus / full (+warp))
with this protocol, so the difference between consecutive rows is a
stage's incremental cost inside the whole batch program.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from kcmc_tpu_torch.utils.device import resolve_device


def honest_time(fn, *args, iters: int = 24, warmup: int = 1,
                min_warmup_s: float = 0.25, device=None) -> float:
    """Seconds per call of `fn(*args)` on `device` (the card unless
    "cpu"): CUDA events around `iters` back-to-back calls on the card,
    `perf_counter` around synchronous calls on the CPU, after a warm-up
    of at least `warmup` calls and `min_warmup_s` seconds (each call
    synchronised)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    n = 0
    while n < max(1, warmup) or time.perf_counter() - t0 < min_warmup_s:
        fn(*args)
        sync()
        n += 1
        if n >= 1024:  # sub-microsecond calls: don't warm up forever
            break
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with `torch.profiler` (host, and the card where
    there is one) and write a Chrome trace, `trace.json` in `log_dir`
    (chrome://tracing or Perfetto read it; no TensorBoard plugin). Yields
    the profiler, whose `key_averages()` sums time by operation."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def stage_breakdown(
    model: str = "translation",
    shape: tuple[int, int] = (512, 512),
    batch_size: int = 64,
    iters: int = 16,
    n_blobs: int | None = None,
    sigma_range: tuple | None = None,
    device=None,
    **config_overrides,
) -> dict[str, dict[str, float] | float]:
    """Incremental cost (ms per batch) of each 2D pipeline stage on
    `device` (the card unless "cpu").

    Times cumulative prefixes of the batch program with `honest_time`:
    detect (K1 and keypoint selection), + describe, + match (the dense
    Hamming 2-NN), + consensus, and `full (+warp)`, which is
    `TorchBackend.process_batch` without the download (the polish and
    the pyramid's refine included). The row keys are the reference's.
    Prefixes run single-scale: with `n_octaves > 1` only the full row
    runs the pyramid. `n_blobs` / `sigma_range` shape the scene, as the
    judged configs' scenes do (match density sets the stages' prices).
    """
    import numpy as np

    from kcmc_tpu_torch.backends import get_backend
    from kcmc_tpu_torch.config import CorrectorConfig
    from kcmc_tpu_torch.ops.describe import describe_keypoints_batch
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.match import knn_match_impl
    from kcmc_tpu_torch.ops.ransac import consensus_batch
    from kcmc_tpu_torch.utils import prng
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    if model in ("piecewise", "rigid3d"):
        raise ValueError(
            "stage_breakdown covers the 2D matrix-model pipeline; "
            f"got model={model!r}"
        )
    cfg = CorrectorConfig(model=model, batch_size=batch_size, **config_overrides)
    backend = get_backend("torch", cfg, device=device)
    dev = backend.device
    gen_kw = {}
    if n_blobs is not None:
        gen_kw["n_blobs"] = n_blobs
    if sigma_range is not None:
        gen_kw["sigma_range"] = sigma_range
    data = make_drift_stack(n_frames=8, shape=shape, model=model, seed=0, **gen_kw)
    reps = (batch_size + 7) // 8
    stack = np.tile(data.stack, (reps, 1, 1))[:batch_size]
    frames = torch.as_tensor(stack, dtype=torch.float32, device=dev).contiguous()
    ref = backend.prepare_reference(np.asarray(data.stack[0], np.float32))
    idx = np.arange(batch_size)
    keys = prng.fold_in(backend._base_key, torch.as_tensor(idx, device=dev))

    def detect(fr):
        return detect_keypoints_batch(
            fr, max_keypoints=cfg.max_keypoints, threshold=cfg.detect_threshold,
            nms_size=cfg.nms_size, border=cfg.border, harris_k=cfg.harris_k,
            smooth_sigma=cfg.blur_sigma, window_sigma=cfg.harris_window_sigma,
            cand_tile=cfg.cand_tile,
        )

    def describe(fr):
        kps, smooth = detect(fr)
        return kps, describe_keypoints_batch(
            fr, kps, blur_sigma=cfg.blur_sigma, smooth=smooth,
            oriented=cfg.resolved_oriented(), precision=backend.precision,
        )

    def match(fr):
        kps, desc = describe(fr)
        return kps, knn_match_impl(desc, ref["desc"], kps.valid, ref["valid"],
                                   ratio=cfg.ratio, max_dist=cfg.max_hamming,
                                   mutual=cfg.mutual)

    def consensus(fr):
        kps, m = match(fr)
        return consensus_batch(
            backend.model, ref["xy"][m.idx], kps.xy, m.valid, keys,
            n_hypotheses=cfg.n_hypotheses, threshold=cfg.inlier_threshold,
            refine_iters=cfg.refine_iters, score_cap=cfg.score_cap,
            budget_rungs=cfg.budget_rungs, early_exit_frac=cfg.early_exit_frac,
        )

    def full(fr):
        return backend.process_batch(fr, ref, idx, to_host=False)

    stages = [("detect", detect), ("describe", describe), ("match", match),
              ("consensus", consensus), ("full (+warp)", full)]
    report: dict = {}
    prev = 0.0
    for name, fn in stages:
        t = honest_time(fn, frames, iters=iters, device=dev) * 1000.0
        report[name] = {"cumulative_ms": round(t, 2), "incremental_ms": round(t - prev, 2)}
        prev = t
    report["frames_per_sec"] = round(batch_size / (prev / 1000.0), 1)
    return report
