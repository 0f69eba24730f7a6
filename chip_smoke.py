#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It
imports only kcmc_tpu_torch, torch and numpy. Phases, one JSON line
each; any failure raises, so the exit code is non-zero and no result
line is printed:

1. device: requires a CUDA card; prints nvidia-smi's name and power
   limit;
2. build: compiles every CUDA kernel of the translation path from
   kcmc_tpu_torch/csrc (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card
   at the main path's shapes (B=32, 512x512, K=512), K2 also at
   2048x2048 and K3 also at 1024x1024: K1 fields within 1e-5 of
   max|response| with the identical -inf pattern inside the border, K2
   bit-identical, K3 within 1e-5 relative with identical ok flags; then
   CUDA-event times of kernel, plain version and (K3) the grid_sample
   yardstick, and each kernel's bound;
4. e2e: MotionCorrector(model="translation").correct() on a
   1000-frame 512x512 synthetic drift stack (config 1 of BASELINE.json)
   with the launch counters reset just before: transform RMSE <= 0.05
   px, every frame warp_ok, and K1/K2/K3 launched 33/33/64 times.

The line before the last holds the kernels table; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

instead runs the device and build phases and then profiles six 32-frame
batches of the translation batch program (host wall time, device busy
time and idle share, the kcmc.* stage ranges, the top device
operations), for PERF.md's breakdown.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_FLOPS
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "device", "name": name, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })
    return name, smi


def phase_build() -> None:
    from kcmc_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    info = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libs": info})


def _frames(n, shape, seed):
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    s = make_drift_stack(n_frames=n, shape=shape, model="translation", seed=seed)
    return torch.as_tensor(s.stack, device="cuda").contiguous()


def _check_k1(frames, border: int = 16):
    from kcmc_tpu_torch.ops.cuda_detect import detect_response, detect_response_plain

    got = detect_response(frames, smooth_sigma=2.0)
    want = detect_response_plain(frames, smooth_sigma=2.0)
    torch.cuda.synchronize()
    H, W = frames.shape[1:]
    inner = (slice(None), slice(border, H - border), slice(border, W - border))
    gn, wn = got[0][inner], want[0][inner]
    if not torch.equal(torch.isfinite(gn), torch.isfinite(wn)):
        raise AssertionError("K1: -inf (non-maximum) pattern differs inside the border")
    fin = torch.isfinite(wn)
    scale = float(wn[fin].abs().max())
    err = float((gn[fin] - wn[fin]).abs().max()) if fin.any() else 0.0
    for g, w in zip(got[1:], want[1:]):
        err = max(err, float((g - w).abs().max()))
    if err > TOL * max(scale, 1e-30):
        raise AssertionError(f"K1: max error {err} exceeds {TOL} x max|resp| ({scale})")
    return err


def phase_kernels() -> list[dict]:
    from kcmc_tpu_torch.ops import cuda_detect, cuda_patch, cuda_warp
    from kcmc_tpu_torch.ops.describe import edge_pad
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.patterns import PATCH_RADIUS

    B, H, W, K = 32, 512, 512, 512
    P = 2 * PATCH_RADIUS + 2
    frames = _frames(B, (H, W), seed=1)
    rows = []

    # K1 detect_response
    err1 = _check_k1(frames)
    px = B * H * W
    g = len(cuda_detect.gauss_taps(1.5))
    s = len(cuda_detect.gauss_taps(2.0))
    flops_px = 2 * (2 * s - 1) + 4 * 5 + 3 + 6 * (2 * g - 1) + 7 + 8 + 20
    b1, by1 = bound_ms(px * 4 * 5, px * flops_px)
    rows.append({
        "name": "detect_response", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/detect.cu",
        "replaces": "kcmc_tpu/ops/pallas_detect.py:346",
        "max_abs_err": err1,
        "ms": event_ms(lambda: cuda_detect.detect_response(frames, smooth_sigma=2.0), 20),
        "plain_ms": event_ms(
            lambda: cuda_detect.detect_response_plain(frames, smooth_sigma=2.0), 3, 1
        ),
        "bound_ms": b1, "bound_by": by1, "library_ms": None,
    })

    # K2 extract_blended, on the main path's own keypoints
    kps, smooth = detect_keypoints_batch(frames, max_keypoints=K, threshold=1e-4,
                                         smooth_sigma=2.0)
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    padded = edge_pad((smooth - mu).to(torch.bfloat16), PATCH_RADIUS + 1).contiguous()
    xy = kps.xy.contiguous()
    err2 = 0.0
    got = cuda_patch.extract_blended(padded, xy, P)
    want = cuda_patch.extract_blended_plain(padded, xy, P)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("K2: not bit-identical to its plain version at 512x512")
    # 2048x2048: the size the TPU's banded/slab layouts covered
    big = _frames(2, (2048, 2048), seed=2)
    pbig = edge_pad(big.to(torch.bfloat16), PATCH_RADIUS + 1).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(3)
    xyb = (16 + torch.rand((2, K, 2), device="cuda", generator=gen) * (2048 - 32)).contiguous()
    if not torch.equal(
        cuda_patch.extract_blended(pbig, xyb, P).view(torch.int16),
        cuda_patch.extract_blended_plain(pbig, xyb, P).view(torch.int16),
    ):
        raise AssertionError("K2: not bit-identical to its plain version at 2048x2048")
    del big, pbig
    n_out = B * K * (P - 1) ** 2
    b2, by2 = bound_ms(padded.numel() * 2 + xy.numel() * 4 + n_out * 2, n_out * 9)
    rows.append({
        "name": "extract_blended", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/patch.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:524",
        "max_abs_err": err2,
        "ms": event_ms(lambda: cuda_patch.extract_blended(padded, xy, P), 20),
        "plain_ms": event_ms(lambda: cuda_patch.extract_blended_plain(padded, xy, P), 3, 1),
        "bound_ms": b2, "bound_by": by2, "library_ms": None,
    })

    # K3 warp_translation: drift-sized shifts, one beyond +-PAD
    def shifts(n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        M = torch.eye(3, device="cuda").repeat(n, 1, 1)
        M[:, :2, 2] = (torch.rand((n, 2), device="cuda", generator=g) - 0.5) * 30.0
        M[0, 0, 2] = 140.5  # beyond the exact window: zeroed, ok=False
        return M.contiguous()

    err3 = 0.0
    for fr, M in ((frames, shifts(B, 4)), (_frames(8, (1024, 1024), seed=5), shifts(8, 6))):
        out, ok = cuda_warp.warp_translation(fr, M)
        ref, ref_ok = cuda_warp.warp_translation_plain(fr, M)
        e = float((out - ref).abs().max())
        if e > TOL * float(ref.abs().max()) or not torch.equal(ok, ref_ok):
            raise AssertionError(f"K3: error {e} or ok flags differ at {tuple(fr.shape)}")
        if bool(ok[0]) or float(out[0].abs().max()) != 0.0:
            raise AssertionError("K3: a shift beyond +-PAD must zero and flag the frame")
        err3 = max(err3, e)
    M = shifts(B, 4)
    M[0, 0, 2] = 3.25
    # yardstick: grid_sample with border padding samples the same
    # translation (normalized coordinates, align_corners=True)
    ys = torch.arange(H, device="cuda", dtype=torch.float32)
    xs = torch.arange(W, device="cuda", dtype=torch.float32)
    gx = (xs[None, None, :] + M[:, 0, 2, None, None]) * (2.0 / (W - 1)) - 1.0
    gy = (ys[None, :, None] + M[:, 1, 2, None, None]) * (2.0 / (H - 1)) - 1.0
    grid = torch.stack([gx.expand(B, H, W), gy.expand(B, H, W)], dim=-1).contiguous()
    lib = event_ms(lambda: torch.nn.functional.grid_sample(
        frames[:, None], grid, mode="bilinear", padding_mode="border",
        align_corners=True), 20)
    b3, by3 = bound_ms(2 * B * H * W * 4 + M.numel() * 4, B * H * W * 9)
    rows.append({
        "name": "warp_translation", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/warp.cu",
        "replaces": "kcmc_tpu/ops/pallas_warp.py:183",
        "max_abs_err": err3,
        "ms": event_ms(lambda: cuda_warp.warp_translation(frames, M), 20),
        "plain_ms": event_ms(lambda: cuda_warp.warp_translation_plain(frames, M), 3, 1),
        "bound_ms": b3, "bound_by": by3, "library_ms": lib,
    })
    emit({"phase": "kernels", "checked": [r["name"] for r in rows],
          "max_abs_err": {r["name"]: r["max_abs_err"] for r in rows}})
    return rows


def phase_e2e(smi: str) -> dict[str, int]:
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.utils.metrics import relative_transforms, transform_rmse
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    t0 = time.perf_counter()
    data = make_drift_stack(n_frames=1000, shape=(512, 512), model="translation", seed=0)
    t_data = time.perf_counter() - t0
    mc = MotionCorrector(model="translation")
    mc.correct(data.stack[:32])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    mc.backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = mc.correct(data.stack)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mc.backend.launch_counts()

    rmse = transform_rmse(res.transforms, relative_transforms(data.transforms), (512, 512))
    rescued = int(np.sum(res.diagnostics["warp_rescued"]))
    emit({
        "phase": "e2e", "frames": len(data.stack), "seconds": seconds,
        "frames_per_s": len(data.stack) / seconds, "rmse_px": rmse,
        "warp_rescued": rescued, "launches": launches,
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"])),
        "data_seconds": t_data, "card": smi,
    })
    if res.corrected.shape != data.stack.shape or not np.isfinite(res.corrected).all():
        raise AssertionError("e2e: corrected stack has the wrong shape or non-finite values")
    if not np.isfinite(res.transforms).all() or rmse > 0.05:
        raise AssertionError(f"e2e: transform RMSE {rmse} px exceeds 0.05 px")
    if rescued:
        raise AssertionError(f"e2e: {rescued} frames were not warp_ok")
    want = {"detect_response": 33, "extract_blended": 33, "warp_translation": 64}
    if launches != want:
        raise AssertionError(f"e2e: launch counts {launches} != {want}")
    return launches


def phase_profile(smi: str, n_batches: int = 6) -> None:
    """Where the time of the translation batch program goes on the card:
    host wall time per 32-frame batch (no profiler), then one
    torch.profiler pass over the same batches for device busy time, the
    per-stage ranges (kcmc.*: host time and device span) and the
    device's top kernels and copies. The profiled pass is slower than
    the timed one; the idle share compares its busy time with the
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    B = 32
    data = make_drift_stack(n_frames=B * (n_batches + 1), shape=(512, 512), seed=0)
    backend = MotionCorrector(model="translation").backend
    ref = backend.prepare_reference(data.stack[0])
    batches = [
        (data.stack[i * B:(i + 1) * B], np.arange(i * B, (i + 1) * B))
        for i in range(n_batches + 1)
    ]
    backend.process_batch(batches[0][0], ref, batches[0][1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr, idx in batches[1:]:
        backend.process_batch(fr, ref, idx)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fr, idx in batches[1:]:
            backend.process_batch(fr, ref, idx)
        torch.cuda.synchronize()

    def span(e):
        return e.time_range.end - e.time_range.start  # microseconds

    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    work = [e for e in on_dev if not e.name.startswith("kcmc.")]
    # device busy time: the union of kernel and copy intervals
    busy, end = 0.0, -1.0
    for e in sorted(work, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    stages: dict[str, dict] = {}
    for e in prof.events():
        if e.name.startswith("kcmc."):
            side = "device_span_ms" if e.device_type == DeviceType.CUDA else "host_ms"
            st = stages.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0})
            st[side] += span(e) / 1e3 / n_batches
    ops: dict[str, list] = {}
    for e in work:
        o = ops.setdefault(e.name[:80], [0.0, 0])
        o[0] += span(e)
        o[1] += 1
    top = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:15]
    busy_ms = busy / 1e3 / n_batches
    emit({
        "phase": "profile", "batch": B, "batches": n_batches, "card": smi,
        "wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "stages": stages,
        "top_device_ops": [
            {"name": k, "device_ms_per_batch": v[0] / 1e3 / n_batches,
             "calls_per_batch": v[1] / n_batches}
            for k, v in top
        ],
    })


def main() -> int:
    # outside a checkout this fails before anything is printed
    import kcmc_tpu_torch  # noqa: F401

    name, smi = phase_device()
    phase_build()
    if "--profile" in sys.argv[1:]:
        phase_profile(smi)
        return 0
    rows = phase_kernels()
    launches = phase_e2e(smi)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
