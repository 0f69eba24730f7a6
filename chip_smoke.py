#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It
imports only kcmc_tpu_torch, torch and numpy. Phases, one JSON line
each; any failure raises, so the exit code is non-zero and no result
line is printed:

1. device: requires a CUDA card; prints nvidia-smi's name and power
   limit;
2. build: compiles every CUDA kernel (K1-K11) from
   kcmc_tpu_torch/csrc (one nvcc per source, in parallel); each
   library's ptxas lines (registers, shared memory, spills of every
   kernel; none, and `cached`, where the build cache held it);
3. kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes, then CUDA-event times of kernel, plain
   version and one-call PyTorch yardstick where there is one, and each
   kernel's bound (the larger of bytes over 3.35 TB/s and operations
   over the peak rate of their type, which the phase line names):
   - translation path (B=32, 512x512, K=512): K1's four fields
     bit-identical over whole frames, K2 bit-identical (also at
     2048x2048), K3 within 1e-5 relative with identical ok flags (also at
     1024x1024); K1 and K2 are also timed under CUDA-graph replay;
   - affine path (config 2: 32 frames of 512x512, K=4096, inputs from
     the bins-first route): K1 at nms 3 / window 1.2 as above (and
     timed), K4
     identical by bits (also at 1024x1024 and at an odd 3x230x301 of
     +-0.0 with a constant region; timed also under CUDA-graph replay, and
     beside one fill of its two output maps, `k4_fill_ms`: the card's
     write rate on the same bytes), K2 at P=32 on the 4368 sorted
     slots bit-identical, K5 bit-identical with the one-hot selection
     stack and within one bf16 ulp with a dense one (a sentinel bin
     included), K7 bit-identical with identical ok flags at max_px=18
     on config 2's affine ground-truth maps and on config 4's projective
     ones (also at 1024x1024 and 2048x2048, affine and projective maps; a
     rotation beyond the bound, a shift beyond +-128 px and M[2,2]=0 are
     zeroed and flagged, a g = 1e-30 frame takes the division path); K7
     is timed on both map kinds, each beside one grid_sample call on
     the maps' dense grid (built before timing: the projective time is
     in the phase line), and K5's achieved TFLOP/s is in the phase line;
   - config-4 and config-3 paths: K6 (K2 with in-kernel ORB moments) on
     the keypoints of 32 config-4 frames (K=512, P=32): patches
     bit-identical to its plain version and to K2, moments identical by
     bits, bins identical (also at 2048x2048), also timed under CUDA-graph
     replay; K8 (the piecewise field warp) at
     512x512, B=32, on config 3's 8x8 fields with max_px=6, bit-identical
     with identical ok flags (a residual beyond the bound and a mean
     beyond +-128 px zeroed and flagged; also at 1024x1024 and at 200x160
     with a 6x5 grid); K8 and its grid_sample yardstick also timed under
     CUDA-graph replay;
   - config-5 path (kernels_volumes: 8 volumes of 32x256x256, K=512): K9
     (3D structure tensor, Harris response and blur, one launch)
     identical by bits to its plain version on both fields, on the
     zero-background scene, on a camera-offset one (background 100 +-
     noise) and at an odd 24x200x136; timed also under CUDA-graph replay;
     its float32 issue floor is in the phase line (`issue_floor_ms`: its
     operations, each one rounded instruction, at 33.5 T instructions/s); K10
     (trilinear 3D patches, Pz=8, Pxy=20) identical by bits on the path's
     own keypoints, and on keypoints in and around the clamped band at
     (8, 20), (5, 13) and (16, 33) (the last two the general
     instantiation); timed also under CUDA-graph replay and beside one
     fill of its output (`k10_fill_ms`); K10's bytes count the union of
     the slabs this run's keypoints read;
   - pyramid path (kernels_pyramid; similarity, n_octaves=3 at 512^2:
     octaves of 512, 344 and 232 px, K=176 each): K1 as above at 344^2
     and 232^2 (32 octave frames each; timed) and, with B=2, at 2048^2 (the
     width where the reference runs K1's TPU kernel as column panels);
     K6 bit-identical (patches, moments by bits, bins) at K=176 on 344^2,
     and timed there; K11
     (the raw integer-origin patch cut, which no path of either package
     launches: its e2e launch count is 0) bit-identical at B=32, K=512,
     P=28 on (32, 540, 540) padded blur at the translation path's
     keypoint origins, and at K=13; K11's bytes count the union of the
     windows read;
4. e2e: MotionCorrector(model="translation").correct() on a 1000-frame
   512x512 drift stack (config 1 of BASELINE.json), launch counters
   reset just before: transform RMSE <= 0.05 px, every frame warp_ok,
   launches K1/K2/K3 = 33/33/64 and no affine kernel;
5. e2e_affine: MotionCorrector(model="affine", max_keypoints=4096,
   nms_size=3, harris_window_sigma=1.2, cand_tile=4).correct() on
   config 2 (64 frames of 512x512, 12000 sharp blobs, tiled to 1000 as
   the JAX package's bench.py tiles it): RMSE <= 0.05 px, launches
   K1/K2/K4/K5 = 33 and K7 = 64, no K3; frames K7 flagged are rescued
   through the gather warp and counted, beside the count of frames whose
   ground-truth map K7 flags (gt_beyond_warp_bound; config 4 and rigid
   too);
6. e2e_homography: MotionCorrector(model="homography").correct() on
   config 4 (the default config, K=512: the small-K oriented route) on
   64 frames of 512x512 projective drift tiled to 1000: RMSE <= 0.05 px,
   launches K1/K6 = 33 and K7 = 64, no other kernel; then 128 frames of
   model="rigid" (RMSE <= 0.05 px, K6 and K7 launched);
7. e2e_piecewise: MotionCorrector(model="piecewise").correct() on config
   3 (8x8 grid, field_polish=4) on 64 frames of 512x512 tiled to 1000:
   field RMSE <= 0.15 px, launches K1/K2 = 33 and K8 = 160, no other
   kernel; frames K8 flagged are rescued through the gather warp and
   counted;
8. e2e_rigid3d: MotionCorrector(model="rigid3d").correct() on config 5
   (the default config, K=512, batch 8) on 125 volumes of 32x256x256 (16
   distinct volumes of rigid 3D drift tiled, the JAX package's bench.py
   sizing: frames // 8): transform RMSE on a 9x9x9 control grid <= 0.05
   px, launches K9 = K10 = 17 (16 batches and the reference volume) and
   no other kernel; volumes the bounded volume warp flags are rescued
   through the trilinear gather and counted, beside gt_beyond_warp_bound;
9. e2e_pyramid: MotionCorrector(model="similarity", n_octaves=3).correct()
   on the JAX package's bench.py pyramid row (64 frames of 512x512
   similarity drift tiled to 1000, batch 32): RMSE <= 0.05 px, launches
   K1 = K6 = 131 (3 octaves of the reference, then per batch 3 octaves
   and the single-scale fine pass: 3 + 32 x 4) and no other kernel; the
   separable warp is plain torch (the reference has no Pallas kernel
   there); frames it flags (rotation beyond max_shear_px = 8) skip the
   fine pass and are rescued through the gather warp, counted beside
   gt_beyond_warp_bound; mean coarse_n_matches beside n_matches.

The seven runs above pass rescue_escalate=False, so their digits compare
across PRs. Then the routes of the step-3 slice, each with its own
launch counts:
10. e2e_banded: config 2 (1000 frames) through the banded matcher,
    match_radius = the largest ground-truth displacement of the reference
    keypoints, rounded up, plus 2 px (printed); RMSE <= 0.05 px, the
    config-2 launches, mean matches and peak memory beside the dense
    line's;
11. e2e_escalate_affine, e2e_escalate_pyramid: config 2 and the pyramid
    row at the defaults: the out-of-bound escalation must trip once (its
    frame and the batch that tripped it printed); the batches after it
    take the warp="jnp" backend, so K7 launches only before it; RMSE <=
    0.05 px;
12. e2e_homography_separable (config 4 scene, 128 frames; K1/K6 5, no
    K7), e2e_translation_matrix (config 1 scene, 128 frames; K1/K2 5, K7
    8, no K3), e2e_rigid3d_wide_blur (config 5 scene, blur_sigma=3.0,
    16 volumes: K10 3, no K9, the plain detection route): RMSE <= 0.05
    px; e2e_piecewise_affine (config 3, patch_model="affine", 128
    frames: field RMSE <= 0.15 px, K8 20); e2e_piecewise_wide_grid
    (config 3 scene, an 80x80 grid, 64 frames in batches of 8: the flow
    route, no K8; its pixels within TOL of max|frame| of the same route
    on the CPU on the run's fields, and within WIDE_GRID_GATHER_LIMIT of
    the gather warp of the same fields (the reference's own flow route's
    figures); the dense-flow RMSE against the truth printed).

The line before the last holds the kernels table; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [translation|affine|homography|piecewise|rigid3d|pyramid]

instead runs the device and build phases and then profiles six batches
(32 frames; 8 volumes for rigid3d) of that config's batch program (host
wall time, device busy time and idle share, the kcmc.* stage ranges,
the top device operations), for PERF.md's breakdown.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
# float32 instructions/s: 67e12 counts a fused multiply-add as two
# operations; an unfused multiply or add is one instruction of its own
F32_ISSUE = F32_FLOPS / 2
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
TOL = 1e-5
# e2e_piecewise_wide_grid: the flow route's gap to the gather warp of the
# same fields, as shares of max|frame| (max) and of the frames' RMS
# (RMS), away from an 8-px border. The reference's own flow route
# (kcmc_tpu.ops.warp_field.warp_batch_flow, on the CPU) gives 0.4700 and
# 0.1257 on this phase's fields: the two-pass split's O(|r| |grad r|)
# term on 6.4-px cells whose field gradient passes 1 px/px. The limits
# are those figures rounded up.
WIDE_GRID_GATHER_LIMIT = {"max": 0.5, "rms": 0.15}
# config 2 of BASELINE.json, as the JAX package's bench.py defines it
# (CONFIG_ROWS["affine@2k"], _build_stack)
CFG2 = dict(max_keypoints=4096, nms_size=3, harris_window_sigma=1.2, cand_tile=4)
CFG2_SCENE = dict(model="affine", max_drift=10.0, seed=0, n_blobs=12000,
                  sigma_range=(0.7, 1.4))
# configs 4 and 3 of BASELINE.json: CONFIG_ROWS["homography"] and
# ["piecewise"] of the JAX package's bench.py, the default config each
CFG4_SCENE = dict(model="homography", max_drift=10.0, seed=0)
# config 5 of BASELINE.json: bench.py's rigid3d row at --size 512
VOL_SHAPE = (32, 256, 256)
# the JAX package's bench.py pyramid row: ("similarity", {"n_octaves": 3})
PYRAMID = dict(n_octaves=3)
PYRAMID_SCENE = dict(model="similarity", max_drift=10.0, seed=0)


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


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Mean milliseconds per call of fn replayed from a CUDA graph of
    `reps` calls: device time without the host's launch gaps (event_ms
    includes them where a call's host time exceeds its device time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def sass_counts(lib, opcodes=("FCHK", "HGMMA")) -> dict | None:
    """Per kernel of the built library `lib` (summed over a template's
    instantiations), its SASS instructions of each opcode (cuobjdump
    -sass): FCHK is an IEEE division's slow-path check, one per division
    sequence; HGMMA a warpgroup MMA; MUFU.RCP a reciprocal, which a
    runtime integer division also takes. None where cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    def kernel_name(ln: str) -> str:
        # the mangled name's length-prefixed source name ending in _kernel
        # (the length's digits may follow other digits: a hash, a scope)
        for m in re.finditer(r"\d+", ln):
            for k in range(len(m.group())):
                name = ln[m.end():m.end() + int(m.group()[k:])]
                if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                    return name
        return ln.split()[-1]

    counts: dict[str, dict[str, int]] = {}
    kernel = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = kernel_name(ln)
            # every instantiation of a template kernel adds to its name
            counts.setdefault(kernel, dict.fromkeys(opcodes, 0))
        elif kernel is not None:
            words = ln.replace(";", " ").split()
            for op in opcodes:
                counts[kernel][op] += sum(w == op or w.startswith(op + ".") for w in words)
    return counts


def bound_ms(n_bytes: float, n_ops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / rate
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def field_warp_ops(B: int, H: int, W: int, gh: int, gw: int) -> int:
    """Float operations that the piecewise field warp's function needs
    (pallas_warp_field.py:82-188), each term counted once at the
    granularity it varies on. A row coordinate with its two hat weights
    is 14 operations, a two-term row interpolation 3 more. Per column:
    its live cells and hat weights (14). Per frame, cell row, column and
    channel: the column-interpolated residual (3). Per output row: its
    row coordinate and weights (14). Per canvas pixel (one canvas row per
    output row; each is read by the two output pixels around it): two
    consumer-row fixed-point steps (17 + 1 each), the x-phase row
    interpolation (17) and the floored two-tap x-lerp (6). Per output
    pixel: the two-channel residual (6), its floor (2), the y-lerp (4)
    and the in-frame test (9). Per frame: the mean and the residual
    bound over the cells (8 per cell)."""
    per_canvas_px = 2 * (17 + 1) + 17 + 6
    per_out_px = 6 + 2 + 4 + 9
    return (W * 14 + B * gh * W * 2 * 3 + H * 14
            + B * H * W * (per_canvas_px + per_out_px) + B * gh * gw * 8)


def tiled_stack(n_frames: int, scene: dict):
    """A 64-frame 512x512 drift stack tiled to n_frames (the JAX
    package's bench.py tiling), with its tiled ground truth."""
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    data = make_drift_stack(n_frames=min(n_frames, 64), shape=(512, 512), **scene)
    reps = -(-n_frames // len(data.stack))
    stack = np.tile(data.stack, (reps, 1, 1))[:n_frames]
    return stack, np.tile(data.transforms, (reps, 1, 1))[:n_frames]


def config3_stack(n_frames: int):
    """Config 3's 64-frame piecewise stack tiled to n_frames, and the
    untiled 64-frame data (its ground-truth fields)."""
    from kcmc_tpu_torch.utils.synthetic import make_piecewise_stack

    data = make_piecewise_stack(n_frames=min(n_frames, 64), shape=(512, 512), seed=0)
    reps = -(-n_frames // len(data.stack))
    return np.tile(data.stack, (reps, 1, 1))[:n_frames], data


def volume_stack(n_frames: int):
    """Config 5's 16 distinct volumes of rigid 3D drift tiled to
    n_frames, with the tiled ground truth."""
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack_3d

    data = make_drift_stack_3d(n_frames=min(n_frames, 16), shape=VOL_SHAPE, seed=0)
    reps = -(-n_frames // len(data.stack))
    stack = np.tile(data.stack, (reps, 1, 1, 1))[:n_frames]
    return stack, np.tile(data.transforms, (reps, 1, 1))[:n_frames]


def structure_ops_per_voxel(window_taps: int, blur_taps: int) -> int:
    """Float operations per voxel of K9's function: three central
    differences (a subtraction and a halving each), six products, the
    six entries windowed along three axes (t products and t - 1 sums per
    pass), the blur along three axes, and the response (14 for the 3x3
    determinant, 2 for the trace, 4 for det - k tr^3)."""
    return 3 * 2 + 6 + 6 * 3 * (2 * window_taps - 1) + 3 * (2 * blur_taps - 1) + 14 + 2 + 4


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libs": info,
          # IEEE division slow-path checks (one per division sequence) and
          # warpgroup MMAs in the SASS of K7 and K5; reciprocals (the
          # runtime integer divisions) in K2/K6's, K4's and K10's
          "sass": {**{n: sass_counts(cuda_build.target(n)) for n in ("warp_matrix", "select")},
                   **{n: sass_counts(cuda_build.target(n), ("MUFU.RCP",))
                      for n in ("patch", "moments", "patch3d")}}})


def _frames(n, shape, seed):
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    s = make_drift_stack(n_frames=n, shape=shape, model="translation", seed=seed)
    return torch.as_tensor(s.stack, device="cuda").contiguous()


def _check_k1(frames, **kw) -> float:
    """K1 bit-identical to its plain version on all four fields over
    whole frames."""
    from kcmc_tpu_torch.ops.cuda_detect import detect_response, detect_response_plain

    got = detect_response(frames, smooth_sigma=2.0, **kw)
    want = detect_response_plain(frames, smooth_sigma=2.0, **kw)
    torch.cuda.synchronize()
    for g, w, field in zip(got, want, ("nms", "ox", "oy", "smooth")):
        if not torch.equal(g, w):
            raise AssertionError(f"K1: {field} not bit-identical to its plain version "
                                 f"at {tuple(frames.shape)}, {kw}")
    return 0.0


def _k1_times(frames, **kw) -> dict:
    """K1's event and CUDA-graph times at one shape and parameter set."""
    from kcmc_tpu_torch.ops.cuda_detect import detect_response

    def call():
        return detect_response(frames, smooth_sigma=2.0, **kw)
    return {"event_ms": event_ms(call, 20), "graph_ms": graph_ms(call)}


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
    t1 = _k1_times(frames)
    rows.append({
        "name": "detect_response", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/detect.cu",
        "replaces": "kcmc_tpu/ops/pallas_detect.py:346",
        "max_abs_err": err1,
        "ms": t1["event_ms"],
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

    def k2_call():
        return cuda_patch.extract_blended(padded, xy, P)
    rows.append({
        "name": "extract_blended", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/patch.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:524",
        "max_abs_err": err2,
        "ms": event_ms(k2_call, 20), "graph_ms": graph_ms(k2_call),
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
          "max_abs_err": {r["name"]: r["max_abs_err"] for r in rows},
          "k1_graph_ms": t1["graph_ms"]})
    return rows


def _check_k7(frames, M, max_px: int, what: str) -> float:
    """K7 bit-identical to its plain version, ok flags included."""
    from kcmc_tpu_torch.ops import cuda_warp_matrix

    out, ok = cuda_warp_matrix.warp_batch_matrix(frames, M, max_px=max_px)
    ref, ref_ok = cuda_warp_matrix.warp_batch_matrix_plain(frames, M, max_px)
    if not torch.equal(out, ref) or not torch.equal(ok, ref_ok):
        e = float((out - ref).abs().max())
        raise AssertionError(f"K7: not bit-identical (max error {e}) or ok flags differ at {what}")
    return 0.0


def _grid_sample_ms(frames, M) -> tuple[float, float]:
    """One grid_sample call (bilinear, zeros, align_corners) on the
    maps' dense source grid, which is built before timing: (eager ms,
    CUDA-graph ms)."""
    B, H, W = frames.shape
    ys = torch.arange(H, device="cuda", dtype=torch.float32)[:, None].expand(H, W)
    xs = torch.arange(W, device="cuda", dtype=torch.float32)[None, :].expand(H, W)

    def c(i, j):
        return M[:, i, j, None, None]

    den = c(2, 0) * xs + c(2, 1) * ys + c(2, 2)
    sx = (c(0, 0) * xs + c(0, 1) * ys + c(0, 2)) / den
    sy = (c(1, 0) * xs + c(1, 1) * ys + c(1, 2)) / den
    grid = torch.stack([sx * (2.0 / (W - 1)) - 1.0, sy * (2.0 / (H - 1)) - 1.0], dim=-1)

    def call():
        return torch.nn.functional.grid_sample(
            frames[:, None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
    return event_ms(call, 20), graph_ms(call)


def _projective_maps(n, shape, seed, persp=2e-6):
    """_affine_maps with a perspective row (g, h) of size ~persp."""
    M = _affine_maps(n, shape, seed, rot=0.005)
    g = torch.Generator(device="cuda").manual_seed(seed)
    M[:, 2, :2] = (torch.rand((n, 2), device="cuda", generator=g) - 0.5) * (2 * persp)
    return M.contiguous()


def _affine_maps(n, shape, seed, rot=0.05, shear=0.02, shift=10.0):
    """n random affine maps about the frame centre (config 2's range)."""
    g = np.random.default_rng(seed)
    H, W = shape
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    M = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        th = g.uniform(-rot, rot)
        L = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        L = L @ (np.eye(2) + g.uniform(-shear, shear, (2, 2)))
        M[i, :2, :2] = L
        M[i, :2, 2] = g.uniform(-shift, shift, 2) + c - L @ c
    return torch.as_tensor(M, device="cuda").contiguous()


def phase_kernels_affine() -> tuple[list[dict], dict]:
    """K4, K5 and K7 at config 2's shapes, fed by the bins-first route
    on 32 config-2 frames; K1 and K2 checked at the path's parameters."""
    from kcmc_tpu_torch.backends.torch_backend import TorchBackend
    from kcmc_tpu_torch.config import CorrectorConfig
    from kcmc_tpu_torch.ops import cuda_moments, cuda_patch, cuda_select, cuda_warp_matrix
    from kcmc_tpu_torch.ops import describe as D
    from kcmc_tpu_torch.ops.cuda_moments import band_structure
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.patterns import MOMENTS, N_ORIENT_BINS, ROT_RADIUS

    B, H, W = 32, 512, 512
    stack, gt = tiled_stack(B, CFG2_SCENE)
    frames = torch.as_tensor(stack, device="cuda").contiguous()
    extra = {}
    extra["k1_affine_err"] = _check_k1(frames, nms_size=3, window_sigma=1.2)
    extra["k1_affine"] = {"params": "nms_size=3, window_sigma=1.2, smooth_sigma=2.0",
                          **_k1_times(frames, nms_size=3, window_sigma=1.2)}
    kps, smooth = detect_keypoints_batch(
        frames, max_keypoints=4096, threshold=1e-4, nms_size=3, smooth_sigma=2.0,
        window_sigma=1.2, cand_tile=4,
    )
    r = ROT_RADIUS
    P = 2 * r + 2
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    padded = D.edge_pad((smooth - mu).to(torch.bfloat16), r + 1).contiguous()
    rows = []

    # K4 moment_maps: identical by bits at (32, 544, 544), at 1024x1024
    # and at an odd 3x230x301 of +-0.0 with a constant region (partial
    # tiles on both axes)
    gen = torch.Generator(device="cuda").manual_seed(11)
    big = torch.randn((2, 1024 + 2 * (r + 1), 1024 + 2 * (r + 1)), device="cuda",
                      generator=gen).to(torch.bfloat16)
    odd = torch.randn((3, 230, 301), device="cuda", generator=gen)
    odd = torch.where(odd.abs() < 1.0, torch.copysign(torch.zeros_like(odd), odd), odd)
    odd[1] = -0.0
    odd[2, :100, :150] = 2.5
    for p_in, what in ((padded, "config 2"), (big, "1024x1024"),
                       (odd.to(torch.bfloat16), "3x230x301 signed zeros")):
        got = cuda_moments.moment_maps(p_in)
        want = cuda_moments.moment_maps_plain(p_in)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            raise AssertionError(f"K4: not bit-identical to its plain version at {what}")
    del big, odd
    n_map = B * (padded.shape[1] - 14) * (padded.shape[2] - 14)
    widths = sorted({w for w, _ in band_structure()})
    ops_px = sum(6 * w for w in widths) + len(band_structure()) + 2 * 14
    b4, by4 = bound_ms(padded.numel() * 2 + 2 * n_map * 4, n_map * ops_px)
    torch.backends.cudnn.allow_tf32 = False
    kern = torch.as_tensor(
        np.stack([MOMENTS[..., 0] * MOMENTS[..., 2], MOMENTS[..., 1] * MOMENTS[..., 2]])[:, None],
        device="cuda",
    )
    pf = padded.float()[:, None]
    lib4 = event_ms(lambda: torch.nn.functional.conv2d(pf, kern), 10)
    lib_maps = torch.nn.functional.conv2d(pf, kern)
    m10, m01 = cuda_moments.moment_maps(padded)
    extra["k4_vs_conv_max_abs"] = float(max((lib_maps[:, 0] - m10).abs().max(),
                                            (lib_maps[:, 1] - m01).abs().max()))
    # the card's write rate on K4's outputs: one fill of both maps (72 MB)
    extra["k4_fill_ms"] = event_ms(lambda: (m10.zero_(), m01.zero_()), 20)
    rows.append({
        "name": "moment_maps", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/moments.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:1276",
        "max_abs_err": 0.0,
        "ms": event_ms(lambda: cuda_moments.moment_maps(padded), 20),
        "graph_ms": graph_ms(lambda: cuda_moments.moment_maps(padded)),
        "plain_ms": event_ms(lambda: cuda_moments.moment_maps_plain(padded), 3, 1),
        "bound_ms": b4, "bound_by": by4, "library_ms": lib4,
    })
    del pf, lib_maps

    # the route up to K5: bins, aligned runs, K2 at P=32 on sorted slots
    m10, m01 = D._moments_at_keypoints(padded, kps.xy, r)
    bins = D._quantize_bins(torch.atan2(m01, m10))
    nb = N_ORIENT_BINS
    keys = torch.where(kps.valid, bins, torch.full_like(bins, nb))
    src, _, aends = D._aligned_runs(keys, nb + 1, D.RUN_ALIGN)
    Kp = src.shape[1]
    K = kps.xy.shape[1]
    safe = torch.clamp(src, max=K - 1)
    xy_s = torch.gather(kps.xy, 1, safe[..., None].expand(B, Kp, 2))
    xy_s = torch.where((src < K)[..., None], xy_s, torch.zeros((), device="cuda")).contiguous()
    pb = cuda_patch.extract_blended(padded, xy_s, P)
    if not torch.equal(pb.view(torch.int16),
                       cuda_patch.extract_blended_plain(padded, xy_s, P).view(torch.int16)):
        raise AssertionError("K2: not bit-identical to its plain version at P=32, Kp=4368")
    flat = pb.reshape(B, Kp, -1).contiguous()
    s_blk = (torch.arange(Kp // D.RUN_ALIGN, device="cuda") * D.RUN_ALIGN).expand(B, -1)
    ibin = torch.searchsorted(aends, s_blk.contiguous(), side="right").to(torch.int32)
    ibin[0, -1] = nb  # a sentinel block, clamped to the last matrix
    ibin = ibin.contiguous()
    sel = D.sel_rot("cuda")
    got = cuda_select.binned_select_rows(flat, ibin, sel, D.RUN_ALIGN)
    want = cuda_select.binned_select_rows_plain(flat, ibin, sel, D.RUN_ALIGN)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("K5: not bit-identical with the one-hot selection stack")
    dense = torch.randn(sel.shape, device="cuda", generator=gen).to(torch.bfloat16)
    gd = cuda_select.binned_select_rows(flat[:4], ibin[:4].contiguous(), dense, 16).float()
    wd = cuda_select.binned_select_rows_plain(flat[:4], ibin[:4], dense, 16).float()
    mag = torch.maximum(gd.abs(), wd.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    err5 = float((gd - wd).abs().max())
    if not ((gd - wd).abs() <= ulp + 1e-5 * wd.abs().max()).all():
        raise AssertionError(f"K5: dense selection beyond one bf16 ulp (max error {err5})")
    extra["k5_dense_max_abs"] = err5
    extra["k5_sorted_slots"] = Kp
    extra["mean_valid_keypoints"] = float(kps.valid.sum(dim=1).float().mean())
    L, V = flat.shape[2], sel.shape[2]
    flops5 = 2.0 * B * Kp * L * V
    b5, by5 = bound_ms(flat.numel() * 2 + sel.numel() * 2 + ibin.numel() * 4
                       + B * Kp * V * 2, flops5, BF16_TC_FLOPS)
    rows2d = flat.reshape(B * Kp, L)
    lib5 = event_ms(lambda: torch.matmul(rows2d, sel[0]), 10)
    ms5 = event_ms(lambda: cuda_select.binned_select_rows(flat, ibin, sel, 16), 20)
    extra["k5_tflops"] = flops5 / (ms5 * 1e-3) / 1e12
    rows.append({
        "name": "binned_select_rows", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/select.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:1169",
        "max_abs_err": 0.0,
        "ms": ms5,
        "plain_ms": event_ms(
            lambda: cuda_select.binned_select_rows_plain(flat, ibin, sel, 16), 3, 1),
        "bound_ms": b5, "bound_by": by5, "library_ms": lib5,
    })
    del pb, flat, rows2d, dense, got, want, gd, wd

    # K7 warp_batch_matrix at max_px = _matrix_resid_px(512^2) = 18 on
    # config 2's ground-truth maps (affine: the exact affine branch), three
    # of them out of its envelope, and on config 4's projective ones
    backend = TorchBackend(CorrectorConfig(model="affine", **CFG2), device="cuda")
    mpx = backend._matrix_resid_px((H, W))
    gt_rel = gt @ np.linalg.inv(gt[0])
    M = torch.as_tensor(gt_rel.astype(np.float32), device="cuda").contiguous()
    err7 = _check_k7(frames, M, mpx, "512x512")
    Mx = M.clone()
    th = 0.1  # ~25 px at the corners: beyond the bound
    c = (W - 1) / 2.0
    Mx[1, :2, :2] = torch.tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Mx[1, :2, 2] = torch.tensor([c - c * np.cos(th) + c * np.sin(th),
                                 c - c * np.sin(th) - c * np.cos(th)])
    Mx[2, 0, 2] = 140.5  # beyond +-PAD
    Mx[3, 2, 2] = 0.0  # degenerate
    Mx[4, 2, 0] = 1e-30  # projective by a hair: the division path
    out, ok = cuda_warp_matrix.warp_batch_matrix(frames, Mx.contiguous(), max_px=mpx)
    err7 = max(err7, _check_k7(frames, Mx.contiguous(), mpx, "512x512, out of envelope"))
    if ok[1:4].any() or float(out[1:4].abs().max()) != 0.0 or not bool(ok[0]):
        raise AssertionError("K7: frames out of the envelope must be zeroed and flagged")
    stack4, gt4 = tiled_stack(B, CFG4_SCENE)
    frames4 = torch.as_tensor(stack4, device="cuda").contiguous()
    M4 = torch.as_tensor((gt4 @ np.linalg.inv(gt4[0])).astype(np.float32),
                         device="cuda").contiguous()
    mpx4 = TorchBackend(CorrectorConfig(model="homography"), device="cuda")._matrix_resid_px((H, W))
    err7 = max(err7, _check_k7(frames4, M4, mpx4, "512x512, config 4 projective"))
    for side, n in ((1024, 8), (2048, 2)):
        fr = _frames(n, (side, side), seed=side)
        mp = backend._matrix_resid_px((side, side))
        err7 = max(err7, _check_k7(fr, _affine_maps(n, (side, side), side, rot=0.005),
                                   mp, f"{side}x{side}"))
        err7 = max(err7, _check_k7(fr, _projective_maps(n, (side, side), side + 1),
                                   mp, f"{side}x{side}, projective"))
        del fr
    px = B * H * W
    b7, by7 = bound_ms(2 * px * 4 + M.numel() * 4 + B, px * 126)
    lib7 = _grid_sample_ms(frames, M)
    rows.append({
        "name": "warp_batch_matrix", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/warp_matrix.cu",
        "replaces": "kcmc_tpu/ops/pallas_warp_field.py:526",
        "max_abs_err": err7,
        "ms": event_ms(lambda: cuda_warp_matrix.warp_batch_matrix(frames, M, max_px=mpx), 20),
        "plain_ms": event_ms(
            lambda: cuda_warp_matrix.warp_batch_matrix_plain(frames, M, mpx), 3, 1),
        "bound_ms": b7, "bound_by": by7, "library_ms": lib7[0],
    })
    # device time without launch gaps (CUDA-graph replay), and the same
    # kernel on config 4's projective maps (the division path)
    lib7p = _grid_sample_ms(frames4, M4)
    k7p = lambda: cuda_warp_matrix.warp_batch_matrix(frames4, M4, max_px=mpx4)  # noqa: E731
    extra["k7_graph_ms"] = {
        "affine": graph_ms(lambda: cuda_warp_matrix.warp_batch_matrix(frames, M, max_px=mpx)),
        "affine_library": lib7[1], "projective": graph_ms(k7p), "projective_library": lib7p[1]}
    extra["k7_projective"] = {
        "maps": "config 4 ground truth, 32 frames of 512x512", "max_px": mpx4,
        "ms": event_ms(k7p, 20),
        "plain_ms": event_ms(
            lambda: cuda_warp_matrix.warp_batch_matrix_plain(frames4, M4, mpx4), 3, 1),
        "bound_ms": b7, "library_ms": lib7p[0],
    }
    extra["k7_ok_frames"] = {
        "affine": int(cuda_warp_matrix.warp_batch_matrix(frames, M, mpx)[1].sum()),
        "projective": int(cuda_warp_matrix.warp_batch_matrix(frames4, M4, mpx4)[1].sum())}
    del frames4, stack4
    extra["k7_max_px"] = mpx
    extra["library"] = {"warp_batch_matrix": "grid_sample (bilinear, zeros) on the maps' "
                        "dense source grid, built before timing"}
    extra["bound_rates"] = {"moment_maps": "float32 67 TFLOP/s",
                            "binned_select_rows": "bf16 tensor 989 TFLOP/s",
                            "warp_batch_matrix": "float32 67 TFLOP/s"}
    return rows, extra


def phase_kernels_fields() -> tuple[list[dict], dict]:
    """K6 at config 4's shapes, fed by the path's own keypoints on 32
    config-4 frames, and K8 at config 3's, on its ground-truth fields."""
    from kcmc_tpu_torch.ops import cuda_patch, cuda_warp_field
    from kcmc_tpu_torch.ops import describe as D
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.patterns import MOMENT_RADIUS, ROT_RADIUS
    from kcmc_tpu_torch.ops.piecewise import upsample_field

    B, H, W, K = 32, 512, 512, 512
    r = ROT_RADIUS
    P = 2 * r + 2
    extra = {}
    rows = []

    # K6 extract_blended with moments: bit-identical patches (also to
    # K2), moments and bins, at config 4 and at 2048x2048
    stack, _ = tiled_stack(B, CFG4_SCENE)
    frames = torch.as_tensor(stack, device="cuda").contiguous()
    kps, smooth = detect_keypoints_batch(frames, max_keypoints=K, threshold=1e-4,
                                         smooth_sigma=2.0)
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    padded = D.edge_pad((smooth - mu).to(torch.bfloat16), r + 1).contiguous()
    xy = kps.xy.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(12)
    big = torch.randn((2, 2048 + 2 * (r + 1), 2048 + 2 * (r + 1)), device="cuda",
                      generator=gen).to(torch.bfloat16)
    xyb = (16 + torch.rand((2, K, 2), device="cuda", generator=gen) * (2048 - 32)).contiguous()
    for p_in, x_in, what in ((padded, xy, "config 4"), (big, xyb, "2048x2048")):
        pb, m10, m01 = cuda_patch.extract_blended(p_in, x_in, P, with_moments=True)
        wpb, w10, w01 = cuda_patch.extract_blended_plain(p_in, x_in, P, with_moments=True)
        k2 = cuda_patch.extract_blended(p_in, x_in, P)
        if not (torch.equal(pb.view(torch.int16), wpb.view(torch.int16))
                and torch.equal(pb.view(torch.int16), k2.view(torch.int16))):
            raise AssertionError(f"K6: patches not bit-identical to the plain version and K2 at {what}")
        if not (torch.equal(m10.view(torch.int32), w10.view(torch.int32))
                and torch.equal(m01.view(torch.int32), w01.view(torch.int32))):
            raise AssertionError(f"K6: moments not bit-identical to the plain version at {what}")
        if not torch.equal(D._quantize_bins(torch.atan2(m01, m10)),
                           D._quantize_bins(torch.atan2(w01, w10))):
            raise AssertionError(f"K6: orientation bins differ at {what}")
    del big, xyb
    extra["k6_mean_valid_keypoints"] = float(kps.valid.sum(dim=1).float().mean())
    n_out = B * K * (P - 1) ** 2
    n_disc = sum(1 for dy in range(-MOMENT_RADIUS, MOMENT_RADIUS + 1)
                 for dx in range(-MOMENT_RADIUS, MOMENT_RADIUS + 1)
                 if dx * dx + dy * dy <= MOMENT_RADIUS ** 2)
    b6, by6 = bound_ms(padded.numel() * 2 + xy.numel() * 4 + n_out * 2 + 2 * B * K * 4,
                       n_out * 9 + B * K * 4 * n_disc)

    def k6_call():
        return cuda_patch.extract_blended(padded, xy, P, with_moments=True)
    rows.append({
        "name": "extract_blended_moments", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/patch.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:524",
        "max_abs_err": 0.0,
        "ms": event_ms(k6_call, 20), "graph_ms": graph_ms(k6_call),
        "plain_ms": event_ms(
            lambda: cuda_patch.extract_blended_plain(padded, xy, P, with_moments=True), 3, 1),
        "bound_ms": b6, "bound_by": by6, "library_ms": None,
    })
    del frames, smooth, padded

    # K8 warp_batch_field at max_px = max_flow_px = 6 on config 3's
    # fields relative to frame 0 (what the path estimates)
    stack3, data3 = config3_stack(B)
    fr = torch.as_tensor(stack3, device="cuda").contiguous()
    fields = torch.as_tensor(data3.fields[:B] - data3.fields[0], device="cuda").contiguous()

    def check(frames_, fields_, what):
        out, ok = cuda_warp_field.warp_batch_field(frames_, fields_, max_px=6)
        ref, ref_ok = cuda_warp_field.warp_batch_field_plain(frames_, fields_, 6)
        if not torch.equal(out, ref) or not torch.equal(ok, ref_ok):
            e = float((out - ref).abs().max())
            raise AssertionError(f"K8: not bit-identical (max error {e}) or ok flags differ "
                                 f"at {what}")
        return 0.0, out, ok

    err8, _, ok = check(fr, fields, "512x512")
    extra["k8_config3_ok"] = int(ok.sum())
    fx = fields.clone()
    fx[1, :4] += 20.0  # residual beyond the bound
    fx[2] += 300.0  # mean beyond +-PAD
    e, out, ok = check(fr, fx.contiguous(), "512x512, out of envelope")
    err8 = max(err8, e)
    if ok[1:3].any() or float(out[1:3].abs().max()) != 0.0:
        raise AssertionError("K8: frames out of the envelope must be zeroed and flagged")
    g8 = torch.Generator(device="cuda").manual_seed(8)
    for shape, grid, n in (((1024, 1024), (8, 8), 8), ((200, 160), (6, 5), 4)):
        f_big = _frames(n, shape, seed=shape[0])
        fld = ((torch.rand((n,) + grid + (2,), device="cuda", generator=g8) - 0.5) * 4.0
               + torch.tensor([3.3, -2.2], device="cuda")).contiguous()
        err8 = max(err8, check(f_big, fld, f"{shape[0]}x{shape[1]}, grid {grid}")[0])
        del f_big
    px = B * H * W
    b8, by8 = bound_ms(2 * px * 4 + fields.numel() * 4 + B,
                       field_warp_ops(B, H, W, *fields.shape[1:3]))
    flows = upsample_field(fields, (H, W))  # (B, H, W, 2), outside the timing
    ys = torch.arange(H, device="cuda", dtype=torch.float32)[None, :, None]
    xs = torch.arange(W, device="cuda", dtype=torch.float32)[None, None, :]
    grid = torch.stack([(xs + flows[..., 0]) * (2.0 / (W - 1)) - 1.0,
                        (ys + flows[..., 1]) * (2.0 / (H - 1)) - 1.0], dim=-1).contiguous()

    def lib8_call():
        return torch.nn.functional.grid_sample(
            fr[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def k8_call():
        return cuda_warp_field.warp_batch_field(fr, fields, max_px=6)
    lib8 = event_ms(lib8_call, 20)
    ms8 = event_ms(k8_call, 20)
    extra["k8_graph_ms"] = {"kernel": graph_ms(k8_call), "library": graph_ms(lib8_call)}
    # the largest grids the wrapper takes: every block's prologue sums all
    # gh * gw cells in order, and the strips take the general path
    f78 = ((torch.rand((B, 78, 78, 2), device="cuda", generator=g8) - 0.5) * 4.0
           + torch.tensor([3.3, -2.2], device="cuda")).contiguous()
    err8 = max(err8, check(fr, f78, "512x512, grid (78, 78)")[0])
    extra["k8_78x78_ms"] = {
        "event_ms": event_ms(lambda: cuda_warp_field.warp_batch_field(fr, f78, max_px=6), 20),
        "graph_ms": graph_ms(lambda: cuda_warp_field.warp_batch_field(fr, f78, max_px=6))}
    extra["k8_target_met"] = ms8 <= lib8  # event_ms at or below grid_sample's
    rows.append({
        "name": "warp_batch_field", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/warp_field.cu",
        "replaces": "kcmc_tpu/ops/pallas_warp_field.py:289",
        "max_abs_err": err8,
        "ms": ms8,
        "plain_ms": event_ms(lambda: cuda_warp_field.warp_batch_field_plain(fr, fields, 6), 3, 1),
        "bound_ms": b8, "bound_by": by8, "library_ms": lib8,
    })
    extra["bound_rates"] = {"extract_blended_moments": "float32 67 TFLOP/s",
                            "warp_batch_field": "float32 67 TFLOP/s"}
    extra["library"] = {"warp_batch_field": "grid_sample on the dense grid of the upsampled "
                        "field (the upsample not timed)"}
    return rows, extra


def phase_kernels_volumes() -> tuple[list[dict], dict]:
    """K9 and K10 at config 5's shapes: 8 volumes of 32x256x256 (the
    path's batch), K=512 keypoints from the path's own detection."""
    from kcmc_tpu_torch.ops import cuda_detect3d, cuda_patch3d
    from kcmc_tpu_torch.ops.cuda_detect import gauss_taps
    from kcmc_tpu_torch.ops.describe3d import PXY, PZ, edge_pad_3d
    from kcmc_tpu_torch.ops.detect3d import detect_keypoints_3d_batch

    B, K = 8, 512
    D, H, W = VOL_SHAPE
    stack, _ = volume_stack(B)
    vols = torch.as_tensor(stack, device="cuda").contiguous()
    gen = torch.Generator(device="cuda").manual_seed(5)
    offset = (vols * 50.0 + 100.0
              + 2.0 * torch.randn(vols.shape, device="cuda", generator=gen)).contiguous()
    odd = (torch.rand((2, 24, 200, 136), device="cuda", generator=gen) * 10.0).contiguous()
    extra = {}
    rows = []

    # K9 response_fields_3d: response and blur identical by bits to the
    # plain version's
    for what, v in (("zero_background", vols), ("camera_offset", offset), ("24x200x136", odd)):
        got = cuda_detect3d.response_fields_3d(v, smooth_sigma=2.0)
        want = cuda_detect3d.response_fields_3d_plain(v, smooth_sigma=2.0)
        torch.cuda.synchronize()
        for g, w, field in zip(got, want, ("response", "blur")):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                e = float((g - w).abs().max())
                raise AssertionError(f"K9: {field} not bit-identical (max error {e}) at {what}")
    del offset, odd
    n_vox = B * D * H * W
    ops9 = structure_ops_per_voxel(len(gauss_taps(1.5)), len(gauss_taps(2.0)))
    b9, by9 = bound_ms(3 * n_vox * 4, n_vox * ops9)

    def k9_call():
        return cuda_detect3d.response_fields_3d(vols, smooth_sigma=2.0)
    rows.append({
        "name": "response_fields_3d", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/detect3d.cu",
        "replaces": "kcmc_tpu/ops/pallas_detect3d.py:206",
        "max_abs_err": 0.0,
        "ms": event_ms(k9_call, 10), "graph_ms": graph_ms(k9_call, reps=10, iters=5),
        "plain_ms": event_ms(
            lambda: cuda_detect3d.response_fields_3d_plain(vols, smooth_sigma=2.0), 2, 1),
        "bound_ms": b9, "bound_by": by9, "library_ms": None,
    })

    # K10 extract_blended_3d on the path's keypoints and blur
    kps, smooth = detect_keypoints_3d_batch(vols, max_keypoints=K, border=8, smooth_sigma=2.0)
    padded = edge_pad_3d(smooth).contiguous()
    xyz = kps.xy.contiguous()
    got = cuda_patch3d.extract_blended_3d(padded, xyz, PZ, PXY)
    want = cuda_patch3d.extract_blended_3d_plain(padded, xyz, PZ, PXY)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("K10: not bit-identical to its plain version at config 5")
    err10 = float((got - want).abs().max())
    # keypoints in the clamped band (negative, and past every far edge) and
    # inside, at the path's size and at two of the general instantiation
    Bp, Dp, Hp, Wp = padded.shape
    gen = torch.Generator(device="cuda").manual_seed(10)
    span = torch.tensor([Wp + 16.0, Hp + 16.0, Dp + 12.0], device="cuda")
    edge = (torch.rand((B, 64, 3), device="cuda", generator=gen) * span - 8.0).contiguous()
    for pz, pxy in ((PZ, PXY), (5, 13), (16, 33)):
        g10 = cuda_patch3d.extract_blended_3d(padded, edge, pz, pxy)
        w10 = cuda_patch3d.extract_blended_3d_plain(padded, edge, pz, pxy)
        if not torch.equal(g10.view(torch.int32), w10.view(torch.int32)):
            raise AssertionError(f"K10: not bit-identical at ({pz}, {pxy}), clamped band")
    del g10, w10
    extra["k10_mean_valid_keypoints"] = float(kps.valid.sum(dim=1).float().mean())
    # distinct input voxels: the union of the slabs these keypoints read
    org = torch.floor(xyz).long() + 1
    zi = (org[..., 2, None] + torch.arange(PZ, device="cuda")).clamp(0, Dp - 1)
    yi = (org[..., 1, None] + torch.arange(PXY, device="cuda")).clamp(0, Hp - 1)
    xi = (org[..., 0, None] + torch.arange(PXY, device="cuda")).clamp(0, Wp - 1)
    bi = torch.arange(B, device="cuda")[:, None, None, None, None]
    flat = ((bi * Dp + zi[..., :, None, None]) * Hp + yi[..., None, :, None]) * Wp \
        + xi[..., None, None, :]
    read = torch.zeros(B * Dp * Hp * Wp, dtype=torch.bool, device="cuda")
    read[flat.reshape(-1)] = True
    n_read = int(read.sum())
    extra["k10_input_voxels_read"] = n_read
    del read, flat
    n_out = got.numel()
    # the card's write rate on K10's output: one fill of it (41 MB)
    extra["k10_fill_ms"] = event_ms(lambda: got.zero_(), 20)
    lerps = PZ * (PXY - 1) * PXY + PZ * (PXY - 1) ** 2 + (PZ - 1) * (PXY - 1) ** 2
    b10, by10 = bound_ms(n_read * 4 + xyz.numel() * 4 + n_out * 4,
                         B * K * (lerps * 3 + 6))
    # yardstick: one 5-D grid_sample (trilinear, border = edge clamp,
    # align_corners) on a precomputed grid of every output's position
    d = [torch.arange(n, device="cuda", dtype=torch.float32) for n in (PZ - 1, PXY - 1, PXY - 1)]
    px = xyz[..., 0, None, None, None] + 1.0 + d[2][None, None, :]
    py = xyz[..., 1, None, None, None] + 1.0 + d[1][None, :, None]
    pz = xyz[..., 2, None, None, None] + 1.0 + d[0][:, None, None]
    shape = (B, K, PZ - 1, PXY - 1, PXY - 1)
    grid = torch.stack([(px * (2.0 / (Wp - 1)) - 1.0).expand(shape),
                        (py * (2.0 / (Hp - 1)) - 1.0).expand(shape),
                        (pz * (2.0 / (Dp - 1)) - 1.0).expand(shape)], dim=-1)
    grid = grid.reshape(B, K * (PZ - 1), PXY - 1, PXY - 1, 3).contiguous()

    def lib_call():
        return torch.nn.functional.grid_sample(
            padded[:, None], grid, mode="bilinear", padding_mode="border", align_corners=True)

    extra["k10_vs_grid_sample_max_abs"] = float(
        (lib_call().reshape(shape) - want).abs().max())
    rows.append({
        "name": "extract_blended_3d", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/patch3d.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:1033",
        "max_abs_err": err10,
        "ms": event_ms(lambda: cuda_patch3d.extract_blended_3d(padded, xyz, PZ, PXY), 20),
        "graph_ms": graph_ms(lambda: cuda_patch3d.extract_blended_3d(padded, xyz, PZ, PXY)),
        "plain_ms": event_ms(
            lambda: cuda_patch3d.extract_blended_3d_plain(padded, xyz, PZ, PXY), 3, 1),
        "bound_ms": b10, "bound_by": by10, "library_ms": event_ms(lib_call, 20),
    })
    # each operation one rounded instruction: the float32 issue rate
    extra["issue_floor_ms"] = {"response_fields_3d": n_vox * ops9 / F32_ISSUE * 1e3}
    extra["bound_rates"] = {"response_fields_3d": "float32 67 TFLOP/s (issue floor: 33.5 T "
                                                   "instructions/s, one per rounded operation)",
                            "extract_blended_3d": "float32 67 TFLOP/s"}
    extra["library"] = {
        "response_fields_3d": "none: no one call computes the windowed 3D structure tensor",
        "extract_blended_3d": "grid_sample, 5-D input, precomputed (B, K*7, 19, 19, 3) grid, "
                              "align_corners, border (grid build not timed)",
    }
    return rows, extra


def phase_kernels_pyramid() -> tuple[list[dict], dict]:
    """K1 and K6 at the pyramid path's octave shapes, K1 at 2048^2, and
    K11 (no path launches it) at the translation path's shapes."""
    from kcmc_tpu_torch.ops import cuda_patch
    from kcmc_tpu_torch.ops import describe as D
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.patterns import PATCH_RADIUS, ROT_RADIUS
    from kcmc_tpu_torch.ops.pyramid import build_pyramid, per_octave_k

    B = 32
    stack, _ = tiled_stack(B, PYRAMID_SCENE)
    octs = build_pyramid(torch.as_tensor(stack, device="cuda").contiguous(), 3, 1.5)
    K = per_octave_k(512, 3)[1]
    extra = {"k1_err": {}, "octave_sizes": [list(o.frames.shape[1:]) for o in octs],
             "per_octave_k": K}
    extra["k1_octave_times"] = {}
    for oc in octs[1:]:
        side = "x".join(map(str, oc.frames.shape[1:]))
        extra["k1_err"][side] = _check_k1(oc.frames)
        extra["k1_octave_times"][side] = _k1_times(oc.frames)
    extra["k1_err"]["2048x2048"] = _check_k1(_frames(2, (2048, 2048), seed=20))

    # K6 at K=176 on the 344^2 octave, on the octave's own keypoints
    fr = octs[1].frames
    kps, smooth = detect_keypoints_batch(fr, max_keypoints=K, threshold=1e-4, smooth_sigma=2.0)
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    padded6 = D.edge_pad((smooth - mu).to(torch.bfloat16), ROT_RADIUS + 1).contiguous()
    P6 = 2 * ROT_RADIUS + 2
    xy6 = kps.xy.contiguous()
    pb, m10, m01 = cuda_patch.extract_blended(padded6, xy6, P6, with_moments=True)
    wpb, w10, w01 = cuda_patch.extract_blended_plain(padded6, xy6, P6, with_moments=True)
    if not (torch.equal(pb.view(torch.int16), wpb.view(torch.int16))
            and torch.equal(m10.view(torch.int32), w10.view(torch.int32))
            and torch.equal(m01.view(torch.int32), w01.view(torch.int32))
            and torch.equal(D._quantize_bins(torch.atan2(m01, m10)),
                            D._quantize_bins(torch.atan2(w01, w10)))):
        raise AssertionError("K6: not bit-identical to its plain version at K=176 on 344x344")
    extra["k6_octave_mean_valid_keypoints"] = float(kps.valid.sum(dim=1).float().mean())

    def k6_call():
        return cuda_patch.extract_blended(padded6, xy6, P6, with_moments=True)
    extra["k6_344x344_k176_ms"] = {"event_ms": event_ms(k6_call, 20), "graph_ms": graph_ms(k6_call)}
    del octs, fr, smooth, padded6, pb, wpb, xy6

    # K11 extract_patches: the translation path's P=28 windows of its
    # padded float32 blur at its own keypoints' integer origins
    frames = _frames(B, (512, 512), seed=1)
    Kt, P = 512, 2 * PATCH_RADIUS + 2
    kps, smooth = detect_keypoints_batch(frames, max_keypoints=Kt, threshold=1e-4,
                                         smooth_sigma=2.0)
    padded = D.edge_pad(smooth, PATCH_RADIUS + 1).contiguous()
    org = torch.floor(kps.xy).to(torch.int32) + 1
    ox, oy = org[..., 0].contiguous(), org[..., 1].contiguous()
    for k in (Kt, 13):
        a, b = oy[:, :k].contiguous(), ox[:, :k].contiguous()
        if not torch.equal(cuda_patch.extract_patches(padded, a, b, P),
                           cuda_patch.extract_patches_plain(padded, a, b, P)):
            raise AssertionError(f"K11: not bit-identical to its plain version at K={k}")
    Bp, Hp, Wp = padded.shape
    ar = torch.arange(P, device="cuda")
    lin = ((torch.arange(B, device="cuda")[:, None, None, None] * Hp
            + oy.long()[..., None, None] + ar[:, None]) * Wp
           + ox.long()[..., None, None] + ar[None, :])  # (B, K, P, P)
    read = torch.zeros(Bp * Hp * Wp, dtype=torch.bool, device="cuda")
    read[lin.reshape(-1)] = True
    n_read = int(read.sum())
    extra["k11_input_pixels_read"] = n_read
    extra["k11_vs_take_equal"] = torch.equal(torch.take(padded, lin),
                                             cuda_patch.extract_patches(padded, oy, ox, P))
    del read
    n_out = B * Kt * P * P
    b11, by11 = bound_ms(n_read * 4 + 2 * B * Kt * 4 + n_out * 4, 0)
    row = {
        "name": "extract_patches", "route": "cuda",
        "source": "kcmc_tpu_torch/csrc/patches.cu",
        "replaces": "kcmc_tpu/ops/pallas_patch.py:1102",
        "max_abs_err": 0.0,
        "ms": event_ms(lambda: cuda_patch.extract_patches(padded, oy, ox, P), 20),
        "plain_ms": event_ms(lambda: cuda_patch.extract_patches_plain(padded, oy, ox, P), 3, 1),
        "bound_ms": b11, "bound_by": by11,
        "library_ms": event_ms(lambda: torch.take(padded, lin), 20),
    }
    extra["library"] = {"extract_patches": "torch.take with a precomputed (B, K, P, P) "
                        "int64 index (index build not timed)"}
    extra["e2e_launches"] = {"extract_patches": "0 on every path: no path of kcmc_tpu or "
                             "of the port calls it"}
    return [row], extra


ZERO = {"detect_response": 0, "extract_blended": 0, "warp_translation": 0,
        "moment_maps": 0, "binned_select_rows": 0, "extract_blended_moments": 0,
        "warp_batch_matrix": 0, "warp_batch_field": 0, "response_fields_3d": 0,
        "extract_blended_3d": 0, "extract_patches": 0}
WANT_LAUNCHES = {
    "translation": {**ZERO, "detect_response": 33, "extract_blended": 33,
                    "warp_translation": 64},
    "affine": {**ZERO, "detect_response": 33, "extract_blended": 33, "moment_maps": 33,
               "binned_select_rows": 33, "warp_batch_matrix": 64},
    "homography": {**ZERO, "detect_response": 33, "extract_blended_moments": 33,
                   "warp_batch_matrix": 64},
    "piecewise": {**ZERO, "detect_response": 33, "extract_blended": 33,
                  "warp_batch_field": 160},
    "rigid3d": {**ZERO, "response_fields_3d": 17, "extract_blended_3d": 17},
    # reference: 3 octaves; each of the 32 batches: 3 octaves + the fine pass
    "pyramid": {**ZERO, "detect_response": 3 + 32 * 4, "extract_blended_moments": 3 + 32 * 4},
}
PHASE = {"translation": "e2e", "affine": "e2e_affine", "homography": "e2e_homography",
         "rigid": "e2e_homography", "piecewise": "e2e_piecewise", "rigid3d": "e2e_rigid3d",
         "pyramid": "e2e_pyramid"}


_STACKS: dict = {}


def _cached(key, make):
    """A scene's stack, made once per run (phases share config 2's)."""
    if key not in _STACKS:
        _STACKS[key] = make()
    return _STACKS[key]


def path_input(model: str, n_frames: int, **overrides):
    """(stack, ground truth, corrector) of a model's cell: ground-truth
    transforms, or for piecewise the untiled 64-frame data. The
    corrector's config is the cell's with `overrides`; the out-of-bound
    escalation is off unless an override turns it on, so the cells
    compare across PRs."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    kw = {"rescue_escalate": False, **overrides}
    if model == "translation":
        data = _cached(("translation", n_frames), lambda: make_drift_stack(
            n_frames=n_frames, shape=(512, 512), model="translation", seed=0))
        return data.stack, data.transforms, MotionCorrector(model="translation", **kw)
    if model == "affine":
        return (*_cached(("affine", n_frames), lambda: tiled_stack(n_frames, CFG2_SCENE)),
                MotionCorrector(model="affine", **{**CFG2, **kw}))
    if model == "piecewise":
        return (*_cached(("piecewise", n_frames), lambda: config3_stack(n_frames)),
                MotionCorrector(model="piecewise", **kw))
    if model == "rigid3d":
        # bench.py's config-5 row: batch min(32, 8)
        return (*_cached(("rigid3d", n_frames), lambda: volume_stack(n_frames)),
                MotionCorrector(model="rigid3d", **{"batch_size": 8, **kw}))
    if model == "pyramid":
        return (*_cached(("pyramid", n_frames), lambda: tiled_stack(n_frames, PYRAMID_SCENE)),
                MotionCorrector(model="similarity", **{**PYRAMID, **kw}))
    return (*_cached((model, n_frames), lambda: tiled_stack(
        n_frames, {**CFG4_SCENE, "model": model})), MotionCorrector(model=model, **kw))


def _gt_beyond_bound(stack, gt_rel, mc) -> int:
    """Frames whose ground-truth map the path's bounded warp (K7, the
    separable chain's shear bound, or the rigid3d volume warp) zeroes
    and flags: the rescues the scene itself calls for (run after the
    launch counters are read)."""
    warp = mc.backend._resolve_batch_warp(stack.shape[1:])
    B = mc.config.batch_size
    n = 0
    for i in range(0, len(stack), B):
        fr = torch.as_tensor(stack[i:i + B], device="cuda").contiguous()
        M = torch.as_tensor(gt_rel[i:i + B].astype(np.float32), device="cuda").contiguous()
        n += int((~warp(fr, M)[1]).sum())
    return n


def counted_run(mc, stack):
    """A warm-up correct() of one batch, then the timed correct() of the
    stack with the launch counters set to 0 just before it and read just
    after: (result, seconds, launches, RuntimeWarning texts)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mc.correct(stack[:mc.config.batch_size])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    mc.backend.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res = mc.correct(stack)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = mc.backend.launch_counts()
    return res, seconds, launches, [str(w.message) for w in rec if w.category is RuntimeWarning]


def e2e_line(smi, phase, model, stack, res, seconds, launches, metric, err, extra) -> dict:
    line = {
        "phase": phase, "model": model,
        "frames": len(stack), "seconds": seconds, "frames_per_s": len(stack) / seconds,
        metric: err, "warp_rescued": int(np.sum(res.diagnostics.get("warp_rescued", 0))),
        **extra, "launches": launches,
        "mean_keypoints": float(np.mean(res.diagnostics["n_keypoints"])),
        "mean_matches": float(np.mean(res.diagnostics["n_matches"])),
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"])),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi,
    }
    emit(line)
    if res.corrected.shape != stack.shape or not np.isfinite(res.corrected).all():
        raise AssertionError(f"{phase}: corrected stack has the wrong shape or non-finite values")
    return line


def check_launches(phase, launches, want) -> None:
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches} != {want}")


def phase_e2e(smi: str, model: str, n_frames: int = 1000) -> dict:
    """One n_frames correct() of the model's cell (escalation off)."""
    from kcmc_tpu_torch.utils.metrics import field_rmse, relative_transforms, transform_rmse

    t0 = time.perf_counter()
    stack, gt, mc = path_input(model, n_frames)
    t_data = time.perf_counter() - t0
    res, seconds, launches, _ = counted_run(mc, stack)

    if model == "piecewise":
        # bench.py's metric: the first 64 (untiled) frames' fields against
        # the truth relative to frame 0
        err = field_rmse(res.fields[:len(gt.stack)], gt.fields - gt.fields[0])
        limit, metric = 0.15, "field_rmse_px"
        finite = np.isfinite(res.fields).all()
    else:
        err = transform_rmse(res.transforms, relative_transforms(gt), stack.shape[1:])
        limit, metric = 0.05, "rmse_px"
        finite = np.isfinite(res.transforms).all()
    extra = {}
    if model in ("affine", "homography", "rigid", "rigid3d", "pyramid"):
        extra["gt_beyond_warp_bound"] = _gt_beyond_bound(stack, relative_transforms(gt), mc)
    if model == "pyramid":
        extra["mean_coarse_matches"] = float(np.mean(res.diagnostics["coarse_n_matches"]))
        extra["config"] = {"model": "similarity", **PYRAMID, "octave_scale": mc.config.octave_scale,
                           "max_shear_px": mc.backend._shear_bound_px(stack.shape[1:])}
    if model == "rigid3d":
        extra["volumes_per_s"] = len(stack) / seconds
        extra["volume_shape"] = list(stack.shape[1:])
        extra["batch"] = mc.config.batch_size
    extra["data_seconds"] = t_data
    line = e2e_line(smi, PHASE[model], model, stack, res, seconds, launches, metric, err, extra)
    if not finite or err > limit:
        raise AssertionError(f"{model}: {metric} {err} exceeds {limit}")
    if model == "translation" and line["warp_rescued"]:
        raise AssertionError(f"e2e: {line['warp_rescued']} frames were not warp_ok")
    if model == "rigid":
        if not (launches["extract_blended_moments"] and launches["warp_batch_matrix"]):
            raise AssertionError(f"rigid: K6 and K7 must both launch, got {launches}")
    else:
        check_launches(model, launches, WANT_LAUNCHES[model])
    return line


def max_gt_displacement(mc, stack, gt) -> float:
    """The largest displacement, in px, of the reference frame's
    keypoints under the scene's ground-truth maps (reference -> frame)."""
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    ref = mc.backend.prepare_reference(stack[0])
    xy = ref["xy"][ref["valid"]].double().cpu().numpy()
    rel = relative_transforms(gt)
    pts = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    moved = np.einsum("tij,kj->tki", rel, pts)
    moved = moved[..., :2] / moved[..., 2:]
    return float(np.sqrt(((moved - xy[None]) ** 2).sum(-1)).max())


def phase_e2e_banded(smi: str, dense: dict) -> dict:
    """Config 2 through the banded matcher: match_radius = the scene's
    largest ground-truth keypoint displacement, rounded up, plus 2 px;
    escalation off, like the dense line printed beside it."""
    from kcmc_tpu_torch.utils.metrics import relative_transforms, transform_rmse

    stack, gt, mc = path_input("affine", 1000)
    disp = max_gt_displacement(mc, stack, gt)
    radius = float(math.ceil(disp) + 2)
    stack, gt, mc = path_input("affine", 1000, match_radius=radius)
    res, seconds, launches, _ = counted_run(mc, stack)
    err = transform_rmse(res.transforms, relative_transforms(gt), stack.shape[1:])
    geom = mc.backend._geometries[tuple(stack.shape[1:])]
    line = e2e_line(smi, "e2e_banded", "affine", stack, res, seconds, launches, "rmse_px", err, {
        "max_gt_displacement_px": disp, "match_radius": radius,
        "geometry": {"tile": geom.tile, "sub": geom.sub, "cq": geom.cq, "csub": geom.csub,
                     "n_win": geom.n_win},
        "dense": {k: dense[k] for k in ("rmse_px", "mean_matches", "mean_inliers",
                                        "peak_device_gb", "frames_per_s", "warp_rescued")},
    })
    if not np.isfinite(res.transforms).all() or err > 0.05:
        raise AssertionError(f"e2e_banded: rmse_px {err} exceeds 0.05")
    check_launches("e2e_banded", launches, WANT_LAUNCHES["affine"])
    return line


def phase_e2e_escalate(smi: str, model: str) -> dict:
    """The cell at the defaults (escalation on): the policy must trip;
    the batches after it take the warp="jnp" backend, so K7 launches only
    before it (affine) and the detect and describe kernels throughout."""
    from kcmc_tpu_torch.utils.metrics import relative_transforms, transform_rmse

    stack, gt, mc = path_input(model, 1000, rescue_escalate=True)
    res, seconds, launches, warned = counted_run(mc, stack)
    err = transform_rmse(res.transforms, relative_transforms(gt), stack.shape[1:])
    B = mc.config.batch_size
    at = res.timing["warp_escalated_at"]
    line = e2e_line(smi, f"e2e_escalate_{model}", model, stack, res, seconds, launches,
                    "rmse_px", err, {
                        "warp_escalated": res.timing["warp_escalated"],
                        "escalated_at_frame": at,
                        "tripped_by_batch": None if at is None else at // B - 1,
                        "warning": warned})
    if not res.timing["warp_escalated"] or len(warned) != 1:
        raise AssertionError(f"e2e_escalate_{model}: the escalation did not trip once: {warned}")
    if not np.isfinite(res.transforms).all() or err > 0.05:
        raise AssertionError(f"e2e_escalate_{model}: rmse_px {err} exceeds 0.05")
    want = dict(WANT_LAUNCHES[model])
    if model == "affine":
        want["warp_batch_matrix"] = 2 * (at // B)  # warp and polish re-warp per batch
    check_launches(f"e2e_escalate_{model}", launches, want)
    return line


def phase_e2e_routes(smi: str) -> dict[str, dict]:
    """The warps, patch models, grids and blurs this slice adds, each on
    its config's scene (escalation off, so every batch takes the route)."""
    from kcmc_tpu_torch.ops.piecewise import upsample_field
    from kcmc_tpu_torch.ops.warp import warp_frame_flow
    from kcmc_tpu_torch.ops.warp_field import warp_batch_flow
    from kcmc_tpu_torch.utils.metrics import field_rmse, relative_transforms, transform_rmse

    lines = {}

    def matrix_case(phase, model, n, want, **kw):
        stack, gt, mc = path_input(model, n, **kw)
        res, seconds, launches, _ = counted_run(mc, stack)
        err = transform_rmse(res.transforms, relative_transforms(gt), stack.shape[1:])
        extra = {"config": kw}
        if model != "rigid3d":
            extra["gt_beyond_warp_bound"] = _gt_beyond_bound(stack, relative_transforms(gt), mc)
        lines[phase] = e2e_line(smi, phase, model, stack, res, seconds, launches, "rmse_px",
                                err, extra)
        if not np.isfinite(res.transforms).all() or err > 0.05:
            raise AssertionError(f"{phase}: rmse_px {err} exceeds 0.05")
        check_launches(phase, launches, want)

    matrix_case("e2e_homography_separable", "homography", 128,
                {**ZERO, "detect_response": 5, "extract_blended_moments": 5}, warp="separable")
    matrix_case("e2e_translation_matrix", "translation", 128,
                {**ZERO, "detect_response": 5, "extract_blended": 5, "warp_batch_matrix": 8},
                warp="matrix")
    matrix_case("e2e_rigid3d_wide_blur", "rigid3d", 16,
                {**ZERO, "extract_blended_3d": 3}, blur_sigma=3.0)

    # config 3 with affine patch fits: field RMSE as the config-3 cell
    stack, gt, mc = path_input("piecewise", 128, patch_model="affine")
    res, seconds, launches, _ = counted_run(mc, stack)
    err = field_rmse(res.fields[:len(gt.stack)], gt.fields - gt.fields[0])
    lines["e2e_piecewise_affine"] = e2e_line(
        smi, "e2e_piecewise_affine", "piecewise", stack, res, seconds, launches,
        "field_rmse_px", err, {"config": {"patch_model": "affine"}})
    if not np.isfinite(res.fields).all() or err > 0.15:
        raise AssertionError(f"e2e_piecewise_affine: field_rmse_px {err} exceeds 0.15")
    check_launches("e2e_piecewise_affine", launches, {
        **ZERO, "detect_response": 5, "extract_blended": 5, "warp_batch_field": 4 * 5})

    # an 80x80 grid (6400 cells, beyond K8's 6144): the flow route; batch
    # 8, since the field estimate's hypothesis block is (B x 6400 cells x
    # 32 hypotheses x 512 matches), 3.4 GB a tensor at B = 8
    grid = (80, 80)
    stack, gt, mc = path_input("piecewise", 64, patch_grid=grid, batch_size=8)
    res, seconds, launches, _ = counted_run(mc, stack)
    shape = tuple(stack.shape[1:])
    # the fields' dense flows against the truth's (the grids differ)
    est = upsample_field(torch.as_tensor(res.fields[:len(gt.stack)], device="cuda"), shape)
    truth = upsample_field(torch.as_tensor(gt.fields - gt.fields[0], device="cuda"), shape)
    flow_err = float(torch.sqrt(((est - truth) ** 2).sum(-1).mean()))
    del est, truth
    # the flow route's pixels: (a) the card's against the same route on
    # the CPU, on the run's final fields (the CPU route is held to the
    # reference's flow warp by tests/test_torch_routes.py), within TOL of
    # max|frame| away from a 16-px border (where a last-place difference
    # of the flow can move a sample across the frame edge); (b) against
    # the gather warp of the same fields (warp="jnp"), within
    # WIDE_GRID_GATHER_LIMIT
    B = mc.config.batch_size
    kept = ~res.diagnostics["warp_rescued"]
    scale = float(np.abs(stack).max())
    card_cpu, gather_max, sq, n_px = 0.0, 0.0, 0.0, 0
    for i in range(0, len(stack), B):
        k = kept[i:i + B]
        fl = torch.as_tensor(res.fields[i:i + B])
        fr = torch.as_tensor(stack[i:i + B])
        cpu = warp_batch_flow(fr, upsample_field(fl, shape), max_px=mc.config.max_flow_px)[0]
        d = np.abs(cpu.numpy() - res.corrected[i:i + B])[k][:, 16:-16, 16:-16]
        card_cpu = max(card_cpu, float(d.max(initial=0.0)) / scale)
        gather = warp_frame_flow(fr.cuda(), upsample_field(fl.cuda(), shape)).cpu().numpy()
        g = (gather - res.corrected[i:i + B])[k][:, 8:-8, 8:-8]
        gather_max = max(gather_max, float(np.abs(g).max(initial=0.0)) / scale)
        sq += float((g.astype(np.float64) ** 2).sum())
        n_px += g.size
    gather_rms = float(np.sqrt(sq / max(n_px, 1)) / np.sqrt(np.mean(stack.astype(np.float64) ** 2)))
    lines["e2e_piecewise_wide_grid"] = e2e_line(
        smi, "e2e_piecewise_wide_grid", "piecewise", stack, res, seconds, launches,
        "flow_rmse_px", flow_err, {"config": {"patch_grid": list(grid), "batch_size": B},
                                   "route": mc.backend._resolve_field_warp(shape).__name__,
                                   "card_vs_cpu_rel": card_cpu, "card_vs_cpu_limit": TOL,
                                   "gather_gap_max_rel": gather_max,
                                   "gather_gap_rms_rel": gather_rms,
                                   "gather_gap_limit": WIDE_GRID_GATHER_LIMIT})
    if not np.isfinite(res.fields).all():
        raise AssertionError("e2e_piecewise_wide_grid: non-finite fields")
    if card_cpu > TOL:
        raise AssertionError(f"e2e_piecewise_wide_grid: the card's flow route is {card_cpu} "
                             f"of max|frame| from the CPU's, over {TOL}")
    if (gather_max > WIDE_GRID_GATHER_LIMIT["max"]
            or gather_rms > WIDE_GRID_GATHER_LIMIT["rms"]):
        raise AssertionError(f"e2e_piecewise_wide_grid: gap to the gather warp {gather_max} "
                             f"(max), {gather_rms} (RMS) over {WIDE_GRID_GATHER_LIMIT}")
    check_launches("e2e_piecewise_wide_grid", launches,
                   {**ZERO, "detect_response": 9, "extract_blended": 9})
    return lines


def phase_profile(smi: str, model: str, n_batches: int = 6) -> None:
    """Where the time of the model's batch program goes on the card:
    host wall time per batch (32 frames, 8 volumes; no profiler), then one
    torch.profiler pass over the same batches for device busy time, the
    per-stage ranges (kcmc.*: host time and device span) and the
    device's top kernels and copies. The profiled pass is slower than
    the timed one; the idle share compares its busy time with the
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B = 8 if model == "rigid3d" else 32
    n = B * (n_batches + 1)
    stack, _, mc = path_input(model, n)
    backend = mc.backend
    ref = backend.prepare_reference(stack[0])
    batches = [
        (stack[i * B:(i + 1) * B], np.arange(i * B, (i + 1) * B))
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
        "phase": "profile", "model": model, "batch": B, "batches": n_batches,
        "card": smi,
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
    args = sys.argv[1:]
    if "--profile" in args:
        rest = args[args.index("--profile") + 1:]
        model = rest[0] if rest else "translation"
        if model not in WANT_LAUNCHES:
            raise SystemExit(f"chip_smoke: --profile takes one of {sorted(WANT_LAUNCHES)}")
        phase_profile(smi, model)
        return 0
    rows = phase_kernels()
    for phase, fn in (("kernels_affine", phase_kernels_affine),
                      ("kernels_fields", phase_kernels_fields),
                      ("kernels_volumes", phase_kernels_volumes),
                      ("kernels_pyramid", phase_kernels_pyramid)):
        new_rows, extra = fn()
        rows += new_rows
        emit({"phase": phase, **extra, "checked": [r["name"] for r in new_rows],
              "max_abs_err": {r["name"]: r["max_abs_err"] for r in new_rows}})
    frames = {"rigid": 128, "rigid3d": 125}
    by_path = {PHASE[m] + ("_rigid" if m == "rigid" else ""): phase_e2e(smi, m, frames.get(m, 1000))
               for m in ("translation", "affine", "homography", "rigid", "piecewise",
                         "rigid3d", "pyramid")}
    by_path["e2e_banded"] = phase_e2e_banded(smi, by_path["e2e_affine"])
    for m in ("affine", "pyramid"):
        by_path[f"e2e_escalate_{m}"] = phase_e2e_escalate(smi, m)
    by_path.update(phase_e2e_routes(smi))
    for r in rows:
        r["launches"] = sum(line["launches"][r["name"]] for line in by_path.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    more = ("graph_ms",)  # the rows that have it
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys + more if k in keys or k in r} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
