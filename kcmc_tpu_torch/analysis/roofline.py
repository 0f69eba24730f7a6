"""Roofline attribution: which resource binds each configuration (the
port's counterpart of kcmc_tpu/analysis/roofline.py).

A table of peaks per platform, a first-order bytes/FLOPs cost model per
pipeline stage, and a judge that combines the model with a MEASURED
wall time into a binding-resource verdict and its fraction of peak.
`chip_smoke.py` judges every priced e2e line on the `h100` row, and
its `--profile` prints `achieved_rates` beside `stage_breakdown`
(utils/profiling.py).

`stage_costs` prices the WORK a batch needs, from config and shape,
whatever implements it: it returns exactly the reference's figures for
the same arguments (the reference calibrated its constant factors once
against a compiler's cost analysis of the 512² programs). Trust the
binding-resource classification and order-of-magnitude fractions, not
the third digit. On the CPU the "device" is the host itself, so the
verdict degenerates to host-compute-bound vs memory-bound vs
staging-bound.
"""

from __future__ import annotations

# -- peaks catalogue (per platform class, table-driven) ---------------------
#
# Units: FLOP/s and bytes/s. `compute` is the peak of the matrix work
# of the match and consensus stages, at the precision the port runs it;
# `vector` the elementwise peak the detect/describe/warp stages are
# bounded by; `memory` main-memory bandwidth (HBM on the card, DRAM on
# the host); `vmem` on-chip memory bandwidth (None: not priced);
# `link` the host<->device staging path; `interconnect` per-device
# bandwidth for multi-device gathers (None = single-device class).
PEAKS: dict[str, dict] = {
    "cpu": {
        "label": "host (CPU)",
        "compute": 2.0e11,
        "vector": 1.0e11,
        "memory": 2.5e10,
        "vmem": None,
        "link": 1.2e10,
        "interconnect": None,
    },
    # NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
    # The match's Hamming matrix is a float32 ±1 torch.matmul with TF32
    # pinned off (ops/match.py, utils/device.set_full_precision), so
    # `compute` is the float32 rate outside the tensor cores, not the
    # bf16 tensor peak (989 TFLOP/s) no stage of the port runs at.
    "h100": {
        "label": "NVIDIA H100 80GB HBM3",
        "compute": 6.7e13,
        "vector": 6.7e13,
        "memory": 3.35e12,
        "vmem": None,
        # PCIe Gen5 x16, one direction (128 GB/s both ways)
        "link": 6.4e10,
        "interconnect": None,
    },
}

# Resource key -> the name the judged report gives it.
RESOURCE_NAMES = {
    "compute": "matrix/compute",
    "vector": "vector",
    "memory": "HBM/memory",
    "vmem": "on-chip memory bandwidth",
    "link": "host link",
    "interconnect": "interconnect",
}


def platform_of(device_name: str) -> str:
    """Peaks-table key of a CUDA card by its name: "h100" for the H100
    SXM part the row describes. Any other card raises, naming it, so
    that no row is silently applied to hardware it does not describe:
    the H100 PCIe and NVL parts have other memory and compute rates."""
    name = str(device_name)
    if "H100" in name and not any(part in name for part in ("PCIe", "NVL")):
        return "h100"
    raise ValueError(
        f"no peaks row for the CUDA card {device_name!r}; the table has "
        f"{sorted(PEAKS)} — add the card's row to PEAKS"
    )


def detect_platform() -> str:
    """Peaks-table key of this process's device: "cpu" without a CUDA
    card, else the card's row (`platform_of` of card 0's name)."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return platform_of(torch.cuda.get_device_name(0))


def _pyramid_px_factor(n_octaves: int, octave_scale: float) -> float:
    """Sum of per-octave pixel-count ratios vs the base frame."""
    return sum(
        (1.0 / float(octave_scale)) ** (2 * i) for i in range(max(1, n_octaves))
    )


def stage_costs(
    model: str,
    shape: tuple[int, int],
    batch: int,
    *,
    max_keypoints: int = 512,
    n_octaves: int = 1,
    octave_scale: float = 2.0,
    oriented: bool | None = None,
    n_hypotheses: int = 128,
    refine_iters: int = 2,
    patch_grid: tuple[int, int] = (8, 8),
    patch_hypotheses: int = 32,
    in_itemsize: int = 4,
    out_itemsize: int = 4,
    emit_frames: bool = True,
) -> dict[str, dict[str, float]]:
    """First-order bytes/FLOPs per pipeline stage for ONE batch.

    Returns {stage: {"flops", "mem_bytes", "link_bytes"}} with the
    stage keys matching `utils.profiling.stage_breakdown`'s rows
    (detect / describe / match / consensus / full (+warp)) plus the
    transfer pseudo-stages ``upload`` and ``download`` that never
    appear in a device breakdown but dominate host-fed rooflines.

    The constant factors are the reference's, calibrated against a
    compiler's cost analysis of its 512² programs (first-order:
    blocking, padding, and fusion change them by tens of percent, not
    orders of magnitude).
    """
    from kcmc_tpu_torch.ops.patterns import (
        N_BITS,
        PATCH_RADIUS,
        ROT_RADIUS,
    )

    H, W = int(shape[0]), int(shape[1])
    B = int(batch)
    px = float(B * H * W)
    K = int(max_keypoints)
    if oriented is None:
        oriented = model not in ("translation",)
    r = ROT_RADIUS if oriented else PATCH_RADIUS
    P = 2 * r + 2
    pyr = _pyramid_px_factor(n_octaves, octave_scale)

    costs: dict[str, dict[str, float]] = {}
    costs["upload"] = {
        "flops": 0.0,
        "mem_bytes": px * in_itemsize,
        "link_bytes": px * in_itemsize,
    }
    # Harris + blur + NMS + subpixel: ~12 conv/reduce passes of ~9-25
    # taps over every pixel (per octave on the pyramid path).
    costs["detect"] = {
        "flops": px * pyr * 160.0,
        "mem_bytes": px * pyr * 4 * 24.0,
        "link_bytes": 0.0,
    }
    # Patch extraction (K patches of P² pixels, bf16 slabs) + N_BITS
    # pair comparisons + orientation moments per keypoint.
    costs["describe"] = {
        "flops": B * K * (P * P * 24.0 + N_BITS * 4.0) * (1.0 if n_octaves <= 1 else 1.2),
        "mem_bytes": px * pyr * 4 * 2.0 + B * K * P * P * 2 * 2.0,
        "link_bytes": 0.0,
    }
    # Hamming matrix as one matmul: K x K_ref x N_BITS bit-MACs, plus
    # the 2-NN selection sweep.
    costs["match"] = {
        "flops": 2.0 * B * K * K * (N_BITS / 8.0) + B * K * K * 4.0,
        "mem_bytes": B * K * K * 2.0,
        "link_bytes": 0.0,
    }
    # Blocked hypothesis solves/scores over the match set; piecewise
    # prices its global+patch field hypotheses through the same term.
    hyp = float(n_hypotheses)
    if model == "piecewise":
        gh, gw = patch_grid
        hyp = float(n_hypotheses + gh * gw * patch_hypotheses)
    costs["consensus"] = {
        "flops": B * hyp * K * 30.0 * (1.0 + refine_iters),
        "mem_bytes": B * hyp * K * 8.0,
        "link_bytes": 0.0,
    }
    # Bilinear warp + polish-free output pass.
    costs["full (+warp)"] = {
        "flops": px * 14.0,
        "mem_bytes": px * 4 * 3.0,
        "link_bytes": 0.0,
    }
    dl = px * out_itemsize if emit_frames else 0.0
    costs["download"] = {
        "flops": 0.0,
        "mem_bytes": dl + B * 64.0,
        "link_bytes": dl + B * 64.0,
    }
    return costs


def total_costs(costs: dict[str, dict[str, float]]) -> dict[str, float]:
    """Sum per-stage costs into one {"flops","mem_bytes","link_bytes"}."""
    out = {"flops": 0.0, "mem_bytes": 0.0, "link_bytes": 0.0}
    for c in costs.values():
        for k in out:
            out[k] += c.get(k, 0.0)
    return out


def judge(
    costs: dict[str, dict[str, float]],
    measured_s: float,
    platform: str,
    *,
    n_devices: int = 1,
    gathered_bytes: float = 0.0,
) -> dict:
    """Combine the cost model with a MEASURED wall time into a
    binding-resource verdict.

    For each resource the model computes the time the batch's work
    would take at that resource's table peak; the resource with the
    largest time-at-peak is the BINDING resource (the roofline's
    ridge), and `fraction_of_peak` is that time divided by the
    measured time — 1.0 means running at the model's speed of light,
    small fractions mean overhead/latency the roofline cannot
    attribute (dispatch, stalls, under-utilization).

    `gathered_bytes` (multi-device): per-batch bytes each device
    receives through the reference gathers, priced against the interconnect
    peak. Compute/memory terms are divided by `n_devices` (perfectly
    sharded work — optimistic, which is what a roofline is).
    """
    peaks = PEAKS[platform]
    tot = total_costs(costs)
    times: dict[str, float] = {}
    # Matrix-class work (match+consensus) runs against the compute
    # peak; elementwise pixel work against the vector peak where the
    # table distinguishes them.
    matrix_flops = sum(
        costs.get(s, {}).get("flops", 0.0) for s in ("match", "consensus")
    )
    vec_flops = tot["flops"] - matrix_flops
    n = max(1, int(n_devices))
    if peaks.get("compute"):
        times["compute"] = matrix_flops / peaks["compute"] / n
    if peaks.get("vector"):
        times["vector"] = vec_flops / peaks["vector"] / n
    if peaks.get("memory"):
        times["memory"] = tot["mem_bytes"] / peaks["memory"] / n
    if peaks.get("link"):
        times["link"] = tot["link_bytes"] / peaks["link"]
    if peaks.get("interconnect") and gathered_bytes > 0:
        times["interconnect"] = gathered_bytes / peaks["interconnect"]
    binding = max(times, key=times.get)
    bound_s = times[binding]
    measured_s = max(float(measured_s), 1e-12)
    return {
        "platform": platform,
        "platform_label": peaks["label"],
        "binding": binding,
        "binding_label": RESOURCE_NAMES[binding],
        "fraction_of_peak": round(min(bound_s / measured_s, 1.0), 4),
        "time_at_peak_s": {k: round(v, 6) for k, v in sorted(times.items())},
        "measured_s": round(measured_s, 6),
    }


def achieved_rates(
    costs: dict[str, dict[str, float]], stage_seconds: dict[str, float]
) -> dict[str, dict[str, float]]:
    """Achieved FLOP/s and bytes/s per measured stage (the --profile
    columns): model work divided by measured incremental time. Stages
    without a cost row or with non-positive time are skipped."""
    out: dict[str, dict[str, float]] = {}
    for name, secs in stage_seconds.items():
        c = costs.get(name)
        if c is None or not secs or secs <= 0:
            continue
        out[name] = {
            "achieved_gflops": round(c["flops"] / secs / 1e9, 2),
            "achieved_gbs": round(c["mem_bytes"] / secs / 1e9, 2),
        }
    return out
