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
   kernel; none, and `cached`, where the build cache held it); then
   link: the host-to-card copy rate of a 256-frame 512x512 float32
   stack from pageable and from pinned memory, beside the roofline's
   `link` figure (PCIe Gen5 x16's spec);
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
     (the raw integer-origin patch cut of the match_precision="float32"
     describe route, whose e2e launches come from e2e_float32)
     bit-identical at B=32, K=512, P=28 on (32, 540, 540) padded blur at
     the translation path's keypoint origins, and at K=13; K11's bytes
     count the union of the windows read;
   - selftest: `python -m kcmc_tpu_torch selftest` in a child process
     (started in phase 27, beside that phase's other children; its line
     prints there), its stdout JSON summary read (each kernel against
     its plain version at production sizes, the warps against the
     gather on the frames they keep, the Hamming match against XOR +
     popcount, a rigid warp="auto" run against the gather warp); every
     record printed, any record not ok or a non-zero exit fails the
     smoke;
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
    frame and the batch that tripped it printed; decided at that batch's
    drain, it takes effect three batches later); the batches after it
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

Then the options of correct() and apply_correction, each at full width
with its own launch counts (escalation off):
13. e2e_templates: config 1's scene, 512 frames, template_iters=2 over
    32 frames, rolling updates every 128 frames (3), quality_metrics;
    with device_templates on and off, transforms within 1e-3 px RMSE of
    each other; RMSE <= 0.05 px; median template_corr and coverage;
14. e2e_warm_start: config 4's scene, 256 frames, warm_start on and off
    (frames/s of both, no speed claim); RMSE <= 0.05 px each;
15. e2e_float32_translation / _homography: config 1's and config 4's
    scenes, 128 frames each, match_precision="float32": K11 once per
    batch and once for the reference, K2, K4, K5 and K6 never; K11 on the
    run's first batch equal to its plain version (torch.equal); RMSE <=
    0.05 px;
16. e2e_sanitize: config 1's scene, 256 frames, sanitize_input=True,
    every 8th frame with a NaN row and an Inf column (seeded): every
    output finite, RMSE <= 0.05 px;
17. e2e_chunked_device: config 2's scene, 256 frames: correct(end_frame=
    128) and correct(start_frame=128) bit-equal to the one-shot run; the
    stack as a CUDA tensor with device_outputs: CUDA tensors, frames with
    warp_ok bit-equal to the host run's; two stream views share the
    backend;
18. e2e_apply: apply_correction of config 2's 256 transforms to a second
    channel (K7 once per batch, the frames it flags re-warped by the
    gather; fallback count beside the registration's rescues), of
    config 3's 256 recovered fields (K8 once per batch) and of
    smooth_trajectory(sigma=15) of e2e_templates' 512 transforms (K7);
    the frames the kernel keeps equal (torch.equal) to its plain
    version, the frames it flags within TOL of max|frame| of the gather;
    each kept frame's gap to the gather under APPLY_GAP_LIMIT, and K7's
    route on two witness frames of the channel reading the reference's
    interpret-mode gap (APPLY_WITNESS).

Every e2e line above also asserts that timing["robustness"] shows no
retry, failover or failed frame. Then files and resume, at full width in
a temporary directory removed afterwards (uint16 TIFFs written by the
port's TiffWriter, the scene x 40000; escalation off):
19. e2e_file: config 1's 1000 frames; correct_file(output, checkpoint,
    checkpoint_every=256) writes correct()'s uint16 frames bit for bit
    with equal transforms, launches K1/K2/K3 = 33/33/64, RMSE <= 0.05
    px; a run killed by device:step=20:fatal and resumed has the
    uninterrupted output's sha256 (restored_frames and the resumed
    run's launches printed); frames/s beside correct()'s (no claim; also
    a repeat without a checkpoint and a run without an output), the
    decoder that ran, prefetch_wait and the writer stalls;
20. e2e_file_twopass: config 2's scene, 256 frames; a registration-only
    correct_file (emit_frames=False) whose transforms equal correct()'s
    on the frames K7 kept (it runs no gather rescue, as the reference's
    does not, so flagged frames keep their unpolished estimate; their
    gap printed), RMSE <= 0.05 px; then apply_correction_file to a
    second channel (deflate TIFF): equal to the in-memory
    apply_correction cast to uint16, bit for bit, K7 once per batch;
21. e2e_file_faults: config 1's scene, 256 frames, through the
    robustness ladder: an io_read and a device transient the retries
    absorb (output bytes equal to the clean run's); a device fault that
    exhausts the retries (one batch on the CPU failover, its transforms
    within 1e-3 px of the clean run's, the others bit-equal, RMSE <=
    0.05 px); failover_backend=None with device:step=4:always (32 frames
    marked failed and interpolated, the others' RMSE <= 0.05 px);
22. e2e_object: config 1's scene, 512 frames of uint16 in an emulated
    object-store bucket (emu://, 64-frame chunk objects on the host's
    disk): a checkpointed correct_file from one bucket to another, its
    frames bit-equal to correct_file of the same frames from a local
    TIFF with equal transforms, K1/K2/K3 17/17/32; a run killed by
    device:step=8:fatal and resumed, whose bucket (chunks and both
    manifests) equals the uninterrupted one byte for byte with fewer
    PUTs; a fault storm on the object surface (drop, stall=0.2, flip,
    truncate, throttle; object_timeout_s=2): zero loss and the same
    bucket, its retry and refetch counters printed;
23. e2e_plans: execution plans, config 1 with plan_buckets=(256, 512):
    a cold process (fresh compile_cache_dir; warmup of float32 and
    uint16 builds the kernel libraries into it), a warm one on the same
    directory (stamp_misses 0, stamp_hits the cold one's, no nvcc) and
    one without a warmup, each correcting a uint16 batch to uint16 (the
    device cast) and timed from spawn to that batch; 512 frames cropped to 500x496 through the 512
    bucket against the unbucketed run, polish off (keypoints and
    warp_ok equal, equal transforms give equal frames, the describe
    mean's corner gaps printed, as tests/plans_witness.py reads them in
    the JAX package on the CPU) and on (RMSE within 0.02 px); an exact
    512² run, an affine run (K7 on the canvas) and a 600² fallback under
    the armed retrace sentinel (violations for the fallback only). The
    phase prints its seconds.
24. e2e_overlap: the pipelined dispatch on config 1 (1000 frames,
    float32): correct() with upload_overlap on (the default) and off,
    equal sha256 and transforms, K1/K2/K3 33/33/64 each way,
    timing["pipeline"] (31 staged uploads waited on, one drain flush),
    the stalls and peak memory; e2e_file's uint16 TIFF through a serial
    correct_file, equal to e2e_file's overlapped and resumed outputs
    by sha256; and `dispatch_profile` of 224 frames each way (the copies'
    device time by direction and kind, device busy time, idle share);
25. e2e_mesh: config 1 through mesh_devices=1 and a two-shard mesh on
    cuda:0 (collective_chunks 0 and 2), config 4 through the two-shard
    mesh, each against its one-device run (integers equal, transforms
    within MESH_GAP_PX; launches per shard: K1, K2/K6 1 + 2 x 32, K3/K7
    2 x 64), a one-rank NCCL group (its gather and ring equal the
    input; a 32-frame sharded run under it) and mesh_devices beyond the
    card count raising;
26. e2e_obs: config 1 (1000 frames, float32) with trace_path,
    frame_records_path and heartbeat_s=1.0 armed and off, as interleaved
    pairs (on, off, off, on): equal sha256 and transforms, K1/K2/K3
    33/33/64 each run, the frames/s of each pair and their spread; the
    trace's dispatch_batch (32), upload.stage (31, on the upload
    worker's track) and frames_done (32) counts beside the expected,
    every name in obs/registry; 1000 records with header and summary;
    timing["latency"] and timing["stage_mean_s"]; the heartbeat's beats
    and no thread left; e2e_file's TIFF through a killed and resumed
    correct_file with frame_records_path (one record per frame, one
    kcmc_run_resume marker, e2e_file's sha256).
27. e2e_cli: the command line on e2e_file's TIFF. `python -m
    kcmc_tpu_torch info` in a child process; `correct -o --transforms`
    through `main` in this process (launches, output sha256 and
    transforms equal e2e_file's; frames/s beside e2e_file's, no claim);
    `apply` of its npz and `stabilize --sigma 15` to float32 pages
    (finite, their largest gap to correct -o printed) and `report` of
    the npz (the stage table); meanwhile two `warmup --buckets 512
    --compile-cache` children, cold then warm (stamp_misses 0), and
    `sanitize -- python -m kcmc_tpu_torch correct` (exit 0, 0
    violations, the static lock-order graph merged: a non-empty edge
    count and no runtime-only line; transforms equal the unsanitized
    run's), `check --no-cache --json` (the six analysis passes on this
    host's Python: exit 0, no new finding, its seconds), and the
    selftest child of phase 3.
28. e2e_serve: the resident serve plane on config 1 (K=512, batch 32,
    512², the 1000-frame float32 stack): two ServeClient threads send
    600 and 400 frames in uneven submits through an in-process
    ServeServer on the card, registration-only (each stream's
    transforms equal a correct() of its frames, integers equal; K1/K2/K3
    35/35/65: 32 batches, two references and the degraded rung's
    warm-up batch (no polish: one K3); no corrected frame downloaded;
    aggregate frames/s,
    request.total and request.dispatch p50/p99 from the metrics verb);
    the same drive with the client threads in a child process (the same
    checks, its frames/s and p50/p99), and one 96-frame submit's wire
    costs (encode, send_msg, recv_msg, decode) timed on the host;
    256 frames as an emitting and as a registration-only session (the
    same launches and transforms, K1/K2/K3 10/10/17 each, 256 x 512² x
    4 bytes fewer downloaded) and at serve_inflight=1 (the corrected
    frames' sha256 equal to the default window's); a `python -m
    kcmc_tpu_torch serve --journal-dir` child (ready line, the `metrics`
    CLI against it, SIGKILL mid-stream, a second child resuming the
    session to the uninterrupted transforms, SIGTERM: the `served`
    record, exit 0). Every stream must show no retry, no CPU failover
    and no frame marked failed.
29. e2e_fleet: the serve fleet on config 1 (frames of the same stack).
    In this process a FleetRouter (default health config) in front of
    two ServeServers on the card: two client threads stream 256 and 192
    frames under session ids placed on different replicas (the binding
    asserted), each bit-equal to a correct() of its frames; the probe
    failures, health transitions and migrations of the drive; then a
    128-frame stream whose replica is stopped once 64 frames are done
    (and journaled by the stop) migrates and finishes within 1e-4 px of correct(), one
    `fleet.migrate` span; K1/K2/K3 24/24/38 over both (18 batches, four
    references, each server's degraded warm-up batch). Then `python -m
    kcmc_tpu_torch router --spawn 2` on the card: a 128-frame stream
    whose replica is SIGKILLed mid-stream finishes with no frame lost
    or duplicated, `migration_failures` 0, within 1e-4 px; `top --once`
    exits 0; SIGTERM gives the `routed` record, exit 0 and no replica
    left. Also the drive's frames/s and the router's host time a frame
    (`recv_msg` + `send_msg` of one 32-frame submit) beside e2e_serve's
    wire costs. Every stream must show no retry, failover or failed
    frame.

Every e2e line of a 2D model carries `roofline`: analysis/roofline's
binding resource and fraction of peak on this card's row, for the work
stage_costs prices over the run's frames and its measured seconds.
The line before the last holds the kernels table; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [translation|affine|homography|piecewise|rigid3d|pyramid]

instead runs the device and build phases and then profiles six batches
(32 frames; 8 volumes for rigid3d) of that config's batch program (host
wall time, device busy time and idle share, the kcmc.* stage ranges,
the top device operations), for PERF.md's breakdown (for translation
also `profile_dispatch`: `dispatch_profile` of correct() over the same
frames with the upload overlap on and off), and for the 2D
matrix models utils/profiling.stage_breakdown (cumulative prefixes of
the batch program timed with CUDA events by honest_time) beside
analysis/roofline.achieved_rates.
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
# e2e_apply: K7 and K8 interpolate once with a fixed-point phase (K7) or
# in two passes (K8), so on the frames they keep they depart from the
# per-frame gather with the content's second derivative. APPLY_WITNESS is
# the reference's interpret-mode K7 route on two frames of the phase's
# channel with their ground-truth maps (its gap to the gather per frame,
# as a share of max|frame|, away from an 8-px border;
# tests/test_torch_apply.py reads it on the CPU); the card's route must
# read it within APPLY_WITNESS_TOL. Every kept frame of the phase must
# read under APPLY_GAP_LIMIT: the witness frames read 0.024 and 0.028,
# the gather of maps off by 0.05 px above 0.24.
APPLY_WITNESS = {18: 0.0239287, 25: 0.0279765}
APPLY_WITNESS_TOL = 1e-4
APPLY_GAP_LIMIT = 0.04
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
CARD = "cuda"


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
    K11 (the float32 describe route's raw cut) at the translation path's
    shapes."""
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
    extra["e2e_launches"] = {"extract_patches": "the match_precision='float32' describe "
                             "route (e2e_float32): once per batch and reference"}
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


def counted_run(mc, stack, **kw):
    """A warm-up correct() of one batch, then the timed correct() of the
    stack (with `kw`) with the launch counters set to 0 just before it
    and read just after: (result, seconds, launches, RuntimeWarning
    texts)."""
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
        res = mc.correct(stack, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = mc.backend.launch_counts()
    return res, seconds, launches, [str(w.message) for w in rec if w.category is RuntimeWarning]


ROBUST_KEYS = ("io_retries", "device_retries", "backend_failovers", "failed_frames")


def check_robust_clean(phase: str, res) -> dict:
    """The run's timing["robustness"]: no retry, failover or failed
    frame on a clean run (the ladder must never hide a device fault)."""
    rb = res.timing.get("robustness")
    if rb is None or any(rb[k] for k in ROBUST_KEYS):
        raise AssertionError(f"{phase}: the robustness ladder acted on a clean run: {rb}")
    return {k: rb[k] for k in ROBUST_KEYS}


def run_costs(cfg, n_frames: int, frame_shape, in_itemsize: int = 4,
              emit_frames: bool = True) -> dict:
    """analysis/roofline.stage_costs of n_frames 2D frames under cfg."""
    from kcmc_tpu_torch.analysis.roofline import stage_costs

    return stage_costs(
        cfg.model, tuple(frame_shape), n_frames, max_keypoints=cfg.max_keypoints,
        n_octaves=cfg.n_octaves, octave_scale=cfg.octave_scale,
        oriented=cfg.resolved_oriented(), n_hypotheses=cfg.n_hypotheses,
        refine_iters=cfg.refine_iters, patch_grid=tuple(cfg.patch_grid),
        patch_hypotheses=cfg.patch_hypotheses, in_itemsize=in_itemsize,
        emit_frames=emit_frames,
    )


def roofline(mc, n_frames: int, frame_shape, seconds: float, in_itemsize: int = 4,
             emit_frames: bool = True) -> dict:
    """analysis/roofline's verdict on a run of n_frames with mc's config
    on this card's row: the resource that binds the work stage_costs
    prices for the whole run, and the run's fraction of that resource's
    peak over its measured seconds. {} for a 3D run (stage_costs prices
    2D frames only)."""
    from kcmc_tpu_torch.analysis.roofline import detect_platform, judge

    if len(frame_shape) != 2:
        return {}
    costs = run_costs(mc.config, n_frames, frame_shape, in_itemsize, emit_frames)
    v = judge(costs, seconds, detect_platform())
    return {"roofline": {"binding": v["binding"], "fraction_of_peak": v["fraction_of_peak"]}}


def e2e_line(mc, smi, phase, model, stack, res, seconds, launches, metric, err, extra) -> dict:
    robust = check_robust_clean(phase, res)
    line = {
        "phase": phase, "model": model,
        "frames": len(stack), "seconds": seconds, "frames_per_s": len(stack) / seconds,
        metric: err, "warp_rescued": int(np.sum(res.diagnostics.get("warp_rescued", 0))),
        **extra, **roofline(mc, len(stack), stack.shape[1:], seconds, stack.dtype.itemsize),
        "launches": launches,
        "mean_keypoints": float(np.mean(res.diagnostics["n_keypoints"])),
        "mean_matches": float(np.mean(res.diagnostics["n_matches"])),
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"])),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "robustness": robust,
        "card": smi,
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
    line = e2e_line(mc, smi, PHASE[model], model, stack, res, seconds, launches, metric, err, extra)
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
    line = e2e_line(mc, smi, "e2e_banded", "affine", stack, res, seconds, launches, "rmse_px", err, {
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
    at = res.escalated_at
    line = e2e_line(mc, smi, f"e2e_escalate_{model}", model, stack, res, seconds, launches,
                    "rmse_px", err, {
                        "warp_escalated": res.timing["warp_escalated"],
                        "escalated_at_frame": at,
                        # decided at that batch's drain, with three batches
                        # in flight: it takes effect three batches later
                        "tripped_by_batch": None if at is None else at // B - 3,
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
        lines[phase] = e2e_line(mc, smi, phase, model, stack, res, seconds, launches, "rmse_px",
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
        mc, smi, "e2e_piecewise_affine", "piecewise", stack, res, seconds, launches,
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
        mc, smi, "e2e_piecewise_wide_grid", "piecewise", stack, res, seconds, launches,
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


def _launches(**nonzero) -> dict:
    return {**ZERO, **nonzero}


def _cell(model: str, n: int, **overrides):
    """The first n frames of a model's 1000-frame cell (stack, ground
    truth relative to frame 0, corrector with `overrides`)."""
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    stack, gt, mc = path_input(model, 1000, **overrides)
    return stack[:n], relative_transforms(gt[:n]), mc


def _rmse(res, gt_rel, shape) -> float:
    from kcmc_tpu_torch.utils.metrics import transform_rmse

    transforms = res.transforms
    if isinstance(transforms, torch.Tensor):
        transforms = transforms.cpu().numpy()
    return transform_rmse(transforms, gt_rel, shape)


def _check_rmse(phase: str, err: float, limit: float = 0.05) -> None:
    if not np.isfinite(err) or err > limit:
        raise AssertionError(f"{phase}: rmse_px {err} exceeds {limit}")


def phase_e2e_templates(smi: str) -> tuple[dict, np.ndarray]:
    """Config 1's scene, 512 frames, template_iters=2 over a 32-frame
    window, rolling updates every 128 frames (3 updates) and the quality
    metrics: once with the device blend, once with the host blend; the
    two runs' transforms within 1e-3 px RMSE of each other. Returns the
    line and the device run's transforms (for e2e_apply's stabilizer)."""
    n, B = 512, 32
    kw = dict(template_iters=2, template_window=32, template_update_every=128,
              quality_metrics=True)
    # refinement: 2 x (reference + one 32-frame batch); the refined
    # reference; 16 batches; 3 updates, each a new reference
    want = _launches(detect_response=2 * 2 + 1 + n // B + 3,
                     extract_blended=2 * 2 + 1 + n // B + 3,
                     warp_translation=2 * 2 + 2 * (n // B))
    runs = {}
    for dev in (True, False):
        stack, gt_rel, mc = _cell("translation", n, device_templates=dev, **kw)
        res, seconds, launches, _ = counted_run(mc, stack)
        err = _rmse(res, gt_rel, stack.shape[1:])
        runs[dev] = (res, seconds, launches, err)
        check_launches(f"e2e_templates[device_templates={dev}]", launches, want)
        _check_rmse(f"e2e_templates[device_templates={dev}]", err)
        # four segments of four batches: three staged uploads waited on
        # in each; the device blend keeps the window in flight across the
        # boundaries (one drain), the host blend drains every segment
        if res.timing["pipeline"] != {"template_updates": 3, "device_templates": dev,
                                      "drain_flushes": 1 if dev else 4,
                                      "upload_overlap": True, "upload_waits": 12}:
            raise AssertionError(f"e2e_templates: pipeline {res.timing['pipeline']}")
    res, seconds, launches, err = runs[True]
    host = runs[False][0]
    gap = _rmse(host, res.transforms, stack.shape[1:])
    line = e2e_line(mc, smi, "e2e_templates", "translation", stack, res, seconds, launches,
                    "rmse_px", err, {
                        "config": kw, "pipeline": res.timing["pipeline"],
                        "median_template_corr": float(np.median(res.diagnostics["template_corr"])),
                        "median_coverage": float(np.median(res.diagnostics["coverage"])),
                        "host_blend": {"rmse_px": runs[False][3],
                                       "frames_per_s": n / runs[False][1],
                                       "median_template_corr": float(np.median(
                                           host.diagnostics["template_corr"]))},
                        "device_vs_host_rmse_px": gap})
    if gap > 1e-3:
        raise AssertionError(f"e2e_templates: device and host blends {gap} px apart")
    return line, res.transforms


def phase_e2e_warm_start(smi: str) -> dict:
    """Config 4's scene (homography: K1, K6, K7), 256 frames, with and
    without warm_start; no speed claim, both rates printed."""
    n, B = 256, 32
    want = _launches(detect_response=n // B + 1, extract_blended_moments=n // B + 1,
                     warp_batch_matrix=2 * (n // B))
    out = {}
    for warm in (True, False):
        stack, gt_rel, mc = _cell("homography", n, warm_start=warm)
        res, seconds, launches, _ = counted_run(mc, stack)
        err = _rmse(res, gt_rel, stack.shape[1:])
        out[warm] = (res, seconds, launches, err)
        check_launches(f"e2e_warm_start[warm_start={warm}]", launches, want)
        _check_rmse(f"e2e_warm_start[warm_start={warm}]", err)
    res, seconds, launches, err = out[True]
    cold = out[False]
    return e2e_line(mc, smi, "e2e_warm_start", "homography", stack, res, seconds, launches,
                    "rmse_px", err, {
                        "cold": {"rmse_px": cold[3], "frames_per_s": n / cold[1],
                                 "mean_inliers": float(np.mean(cold[0].diagnostics["n_inliers"])),
                                 "warp_rescued": int(np.sum(cold[0].diagnostics["warp_rescued"]))}})


def phase_e2e_float32(smi: str) -> dict[str, dict]:
    """match_precision="float32" on config 1's and config 4's scenes, 128
    frames each: K11 once per batch and once for the reference, no K2,
    K4, K5 or K6; then K11 on the run's own first batch against its plain
    version by torch.equal."""
    from kcmc_tpu_torch.ops import cuda_patch
    from kcmc_tpu_torch.ops import describe as D
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch

    n, B = 128, 32
    lines = {}
    for model, warp in (("translation", {"warp_translation": 2 * (n // B)}),
                        ("homography", {"warp_batch_matrix": 2 * (n // B)})):
        stack, gt_rel, mc = _cell(model, n, match_precision="float32")
        res, seconds, launches, _ = counted_run(mc, stack)
        err = _rmse(res, gt_rel, stack.shape[1:])
        cfg = mc.config
        fr = torch.as_tensor(stack[:B], device=mc.backend.device)
        kps, smooth = detect_keypoints_batch(
            fr, max_keypoints=cfg.max_keypoints, threshold=cfg.detect_threshold,
            nms_size=cfg.nms_size, border=cfg.border, harris_k=cfg.harris_k,
            smooth_sigma=cfg.blur_sigma, window_sigma=cfg.harris_window_sigma,
            cand_tile=cfg.cand_tile)
        windows = D.float32_windows(D.centre_finite(smooth), kps.xy, cfg.resolved_oriented())
        equal = torch.equal(cuda_patch.extract_patches(*windows),
                            cuda_patch.extract_patches_plain(*windows))
        phase = f"e2e_float32_{model}"
        lines[phase] = e2e_line(mc, smi, phase, model, stack, res, seconds, launches, "rmse_px",
                                err, {"config": {"match_precision": "float32"},
                                      "k11_equal_plain": equal, "k11_patch": windows[3]})
        _check_rmse(phase, err)
        check_launches(phase, launches, _launches(
            detect_response=n // B + 1, extract_patches=n // B + 1, **warp))
        if not equal:
            raise AssertionError(f"{phase}: K11 is not bit-identical to its plain version")
    return lines


def phase_e2e_sanitize(smi: str) -> dict:
    """Config 1's scene, 256 frames, sanitize_input=True; every 8th frame
    (the reference frame 0 among them) has a NaN row and an Inf column
    at seeded places. Every output finite, RMSE within 0.05 px."""
    n, B = 256, 32
    stack, gt_rel, mc = _cell("translation", n, sanitize_input=True)
    stack = stack.copy()
    rng = np.random.default_rng(0)
    bad = np.arange(0, n, 8)
    rows = rng.integers(0, stack.shape[1], len(bad))
    cols = rng.integers(0, stack.shape[2], len(bad))
    stack[bad, rows, :] = np.nan
    stack[bad, :, cols] = np.inf
    res, seconds, launches, _ = counted_run(mc, stack)
    err = _rmse(res, gt_rel, stack.shape[1:])
    line = e2e_line(mc, smi, "e2e_sanitize", "translation", stack, res, seconds, launches,
                    "rmse_px", err, {"config": {"sanitize_input": True},
                                     "frames_with_nonfinite": len(bad)})
    if not np.isfinite(res.transforms).all():
        raise AssertionError("e2e_sanitize: non-finite transforms")
    _check_rmse("e2e_sanitize", err)
    check_launches("e2e_sanitize", launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, warp_translation=2 * (n // B)))
    return line


def phase_e2e_chunked_device(smi: str) -> tuple[dict, tuple]:
    """Config 2's scene, 256 frames, escalation off: the one-shot run;
    correct(end_frame=128) then correct(start_frame=128), transforms
    bit-equal to it; the stack as a CUDA tensor with device_outputs:
    CUDA tensors, frames with warp_ok bit-equal to the host run's; two
    stream views share the corrector's backend. Returns the line and
    (stack, one-shot result, ground truth) for e2e_apply."""
    n, B = 256, 32
    stack, gt_rel, mc = _cell("affine", n)
    res, seconds, launches, _ = counted_run(mc, stack)
    err = _rmse(res, gt_rel, stack.shape[1:])
    a = mc.correct(stack, end_frame=n // 2)
    b = mc.correct(stack, start_frame=n // 2)
    chunked_equal = np.array_equal(np.concatenate([a.transforms, b.transforms]), res.transforms)
    dev = mc.correct(torch.as_tensor(stack, device=mc.backend.device), device_outputs=True)
    ok = dev.diagnostics["warp_ok"].cpu().numpy()
    on_card = dev.corrected.device.type == CARD and dev.transforms.device.type == CARD
    dev_equal = (np.array_equal(dev.corrected.cpu().numpy()[ok], res.corrected[ok])
                 and np.array_equal(dev.transforms.cpu().numpy()[ok], res.transforms[ok]))
    views = [mc.stream_view(), mc.stream_view(reference="mean")]
    shared = all(v.backend is mc.backend for v in views)
    line = e2e_line(mc, smi, "e2e_chunked_device", "affine", stack, res, seconds, launches,
                    "rmse_px", err, {"chunked_bit_equal": chunked_equal,
                                     "device_outputs_on_card": on_card,
                                     "device_warp_ok_frames": int(ok.sum()),
                                     "device_bit_equal_on_warp_ok": dev_equal,
                                     "stream_views_share_backend": shared})
    _check_rmse("e2e_chunked_device", err)
    check_launches("e2e_chunked_device", launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, moment_maps=n // B + 1,
        binned_select_rows=n // B + 1, warp_batch_matrix=2 * (n // B)))
    if not (chunked_equal and on_card and dev_equal and shared):
        raise AssertionError(f"e2e_chunked_device: {line}")
    return line, (stack, res, gt_rel)


def phase_e2e_apply(smi: str, affine: tuple, stabilize: np.ndarray) -> dict:
    """apply_correction on the card: config 2's 256 transforms applied to
    a second channel (0.5 x the stack plus seeded noise; K7 once per
    batch), config 3's 256 recovered fields (K8 once per batch), and the
    stabilizer smooth_trajectory(sigma=15) of config 1's 512 transforms
    (K7). Each output frame the kernel kept must equal the kernel's
    plain version on the same batch (torch.equal), each frame it flagged
    the gather's (within TOL of max|frame|), and each kept frame's gap to
    the gather must stay under APPLY_GAP_LIMIT; the K7 route on the
    witness frames of the channel must read APPLY_WITNESS."""
    from kcmc_tpu_torch import apply_correction
    from kcmc_tpu_torch.ops import cuda_build
    from kcmc_tpu_torch.ops.cuda_warp_field import warp_batch_field_plain
    from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix_plain
    from kcmc_tpu_torch.ops.piecewise import upsample_field
    from kcmc_tpu_torch.ops.warp import fast_apply_matrix, warp_batch, warp_frame_flow
    from kcmc_tpu_torch.utils.trajectory import smooth_trajectory

    B = 32

    def run(stack, **kw):
        apply_correction(stack[:B], **{k: v[:B] for k, v in kw.items()})  # warm-up
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        out = apply_correction(stack, batch_size=B, **kw)
        seconds = time.perf_counter() - t0
        return out, seconds, cuda_build.launch_counts()

    def gaps(got, gather, fr):
        """Each frame's largest gap to the gather away from an 8-px
        border, as a share of its max|frame|."""
        d = (got - gather)[:, 8:-8, 8:-8].abs().amax(dim=(1, 2)).double()
        return d / fr.abs().amax(dim=(1, 2)).double()

    def check(stack, out, maps, kind):
        """(frames the kernel flags, whether the kept frames equal the
        kernel's plain version and the flagged ones the gather (within
        TOL of max|frame|: the batch's gather against the route's
        per-frame one), the kept frames' largest gap to the gather)."""
        flagged, equal, worst = 0, True, 0.0
        for i in range(0, len(stack), B):
            fr = torch.as_tensor(stack[i:i + B], device=CARD).contiguous()
            m = torch.as_tensor(maps[i:i + B], device=CARD).contiguous()
            if kind == "matrix":
                plain, ok = warp_batch_matrix_plain(fr, m, 16)
                gather = warp_batch(fr, m)
            else:
                plain, ok = warp_batch_field_plain(fr, m, 6)
                gather = warp_frame_flow(fr, upsample_field(m, tuple(fr.shape[1:])))
            got = torch.as_tensor(out[i:i + B], device=CARD)
            g = gaps(got, gather, fr)
            full = (got - gather).abs().amax(dim=(1, 2)) / fr.abs().amax(dim=(1, 2))
            equal = (equal and torch.equal(got[ok], plain[ok])
                     and bool((full[~ok] <= TOL).all()))
            flagged += int((~ok).sum())
            worst = max(worst, float(g[ok].max()) if bool(ok.any()) else 0.0)
        return flagged, equal, worst

    rng = np.random.default_rng(1)
    stack2, reg, gt2 = affine
    channel = (0.5 * stack2 + rng.normal(0, 2.0, stack2.shape)).astype(np.float32)
    out, seconds, launches = run(channel, transforms=reg.transforms)
    n = len(channel)
    flagged, equal, worst = check(channel, out, reg.transforms, "matrix")
    # the witness: the K7 route on two frames of the channel with their
    # ground-truth maps, read against the reference's interpret mode
    idx = sorted(APPLY_WITNESS)
    fr = torch.as_tensor(channel[idx], device=CARD).contiguous()
    m = torch.as_tensor(gt2[idx].astype(np.float32), device=CARD)
    witness = gaps(fast_apply_matrix(fr, m), warp_batch(fr, m), fr).tolist()
    witness_ok = all(abs(w - APPLY_WITNESS[i]) <= APPLY_WITNESS_TOL
                     for i, w in zip(idx, witness))
    # config 3's recovered fields
    stack3, _, mc3 = path_input("piecewise", 256)
    reg3 = mc3.correct(stack3)
    check_robust_clean("e2e_apply[fields]", reg3)
    fields = reg3.fields
    out3, seconds3, launches3 = run(stack3, fields=fields)
    flagged3, equal3, worst3 = check(stack3, out3, fields, "fields")
    # stabilization: the jitter-free path of config 1's drift
    stack1, _, _ = _cell("translation", len(stabilize))
    stab = smooth_trajectory(stabilize, sigma=15.0)
    out1, seconds1, launches1 = run(stack1, transforms=stab)
    flagged1, equal1, worst1 = check(stack1, out1, stab, "matrix")
    line = {
        "phase": "e2e_apply", "frames": n, "frames_per_s": n / seconds,
        "launches": {k: launches[k] + launches3[k] + launches1[k] for k in launches},
        "transforms": {"launches": launches, "k7_fallback_frames": flagged,
                       "registration_warp_rescued": int(np.sum(reg.diagnostics["warp_rescued"])),
                       "equal_to_plain_route": equal, "kept_gather_gap_rel": worst,
                       "witness_gap_rel": dict(zip(map(str, idx), witness)),
                       "witness_reference": {str(i): APPLY_WITNESS[i] for i in idx}},
        "fields": {"frames": len(stack3), "frames_per_s": len(stack3) / seconds3,
                   "launches": launches3, "k8_fallback_frames": flagged3,
                   "equal_to_plain_route": equal3, "kept_gather_gap_rel": worst3},
        "stabilize": {"frames": len(stack1), "frames_per_s": len(stack1) / seconds1,
                      "launches": launches1, "k7_fallback_frames": flagged1,
                      "equal_to_plain_route": equal1, "kept_gather_gap_rel": worst1,
                      "max_stabilizer_shift_px": float(np.abs(stab[:, :2, 2]).max())},
        "card": smi,
    }
    emit(line)
    check_launches("e2e_apply[transforms]", launches, _launches(warp_batch_matrix=n // B))
    check_launches("e2e_apply[fields]", launches3, _launches(warp_batch_field=len(stack3) // B))
    check_launches("e2e_apply[stabilize]", launches1,
                   _launches(warp_batch_matrix=len(stack1) // B))
    for what, o, ref in (("transforms", out, channel), ("fields", out3, stack3),
                         ("stabilize", out1, stack1)):
        if o.shape != ref.shape or not np.isfinite(o).all():
            raise AssertionError(f"e2e_apply[{what}]: wrong shape or non-finite values")
    if not (equal and equal3 and equal1):
        raise AssertionError("e2e_apply: a frame differs from its route's plain result "
                             "(the kernel's plain version, or the gather where it flags)")
    if max(worst, worst3, worst1) > APPLY_GAP_LIMIT:
        raise AssertionError(f"e2e_apply: a kept frame's gap to the gather exceeds "
                             f"{APPLY_GAP_LIMIT}: {worst}, {worst3}, {worst1}")
    if not witness_ok:
        raise AssertionError(f"e2e_apply: the witness frames read {witness}, the reference "
                             f"{APPLY_WITNESS} (within {APPLY_WITNESS_TOL})")
    return line


# the file phases: a float scene as the uint16 frames a camera writes
# (the JAX package's streaming tests scale by 40000)
U16_SCALE = 40000.0
# fast retries: the ladder's logic, not its sleeps
FAST_RETRY = dict(retry_backoff_s=0.01, retry_backoff_max_s=0.02)


def _u16(stack: np.ndarray) -> np.ndarray:
    return np.clip(stack * U16_SCALE, 0, 65535).astype(np.uint16)


def _write_tif(path: str, stack: np.ndarray, compression: str = "none") -> float:
    """Write a stack with the port's TiffWriter; returns seconds."""
    from kcmc_tpu_torch.io.tiff import TiffWriter

    t0 = time.perf_counter()
    with TiffWriter(path, compression=compression) as w:
        w.append_batch(stack)
    return time.perf_counter() - t0


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _build_decoder() -> tuple[float, bool]:
    """Build (or load) the native TIFF decoder before any timed file
    run, so its g++ build stays out of the frames/s: (seconds, built)."""
    from kcmc_tpu_torch.io.tiff import _get_native

    t0 = time.perf_counter()
    lib = _get_native()
    return time.perf_counter() - t0, lib is not None


def file_run(mc, path: str, **kw):
    """A correct_file run with the launch counters set to 0 just before
    it and read just after: (result, seconds, launches, RuntimeWarning
    texts)."""
    import warnings

    torch.cuda.synchronize()
    mc.backend.reset_launch_counts()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res = mc.correct_file(path, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = mc.backend.launch_counts()
    return res, seconds, launches, [str(w.message) for w in rec if w.category is RuntimeWarning]


def _stalls(res) -> dict:
    st = res.timing.get("stalls_s", {})
    return {k: st.get(k, 0.0) for k in ("prefetch_wait", "writer_backpressure", "writer_flush")}


def phase_e2e_file(smi: str, tmp: str) -> dict:
    """Config 1's 1000-frame scene as a uint16 TIFF (the port's
    TiffWriter): an uninterrupted correct_file(output, checkpoint,
    checkpoint_every=256) whose output equals correct() of the same
    uint16 stack cast to uint16, bit for bit, with equal transforms,
    launches K1/K2/K3 33/33/64 and RMSE <= 0.05 px; then a run killed by
    an injected fatal device fault at batch 20 and resumed, whose output
    has the uninterrupted run's sha256."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.io.tiff import read_stack
    from kcmc_tpu_torch.utils.faults import FatalFaultError

    n = 1000
    stack_f, gt_rel, mc = _cell("translation", n)
    stack = _u16(stack_f)
    src, out, out2 = (os.path.join(tmp, f) for f in ("config1.tif", "out.tif", "resumed.tif"))
    write_s = _write_tif(src, stack)
    decoder_build_s, decoder_built = _build_decoder()  # printed as "decoder"
    mem, mem_s, _, _ = counted_run(mc, stack, output_dtype="input")
    ckpt = dict(checkpoint_every=256)
    res, seconds, launches, _ = file_run(mc, src, output=out,
                                         checkpoint=os.path.join(tmp, "run.ckpt.npz"), **ckpt)
    robust = check_robust_clean("e2e_file", res)
    err = _rmse(res, gt_rel, stack.shape[1:])
    equal = np.array_equal(read_stack(out), mem.corrected)
    same_transforms = np.array_equal(res.transforms, mem.transforms)
    killer = MotionCorrector(model="translation", rescue_escalate=False,
                             fault_plan="device:step=20:fatal")
    try:
        killer.correct_file(src, output=out2, checkpoint=os.path.join(tmp, "kill.ckpt.npz"),
                            **ckpt)
        killed = False
    except FatalFaultError:
        killed = True
    resumed, resumed_s, resumed_launches, _ = file_run(
        mc, src, output=out2, checkpoint=os.path.join(tmp, "kill.ckpt.npz"), **ckpt)
    sha, sha2 = _sha256(out), _sha256(out2)
    # the spread of correct_file's frames/s: the same run again without
    # a checkpoint, and once without an output (frames to the host)
    _, repeat_s, _, _ = file_run(mc, src, output=os.path.join(tmp, "repeat.tif"))
    os.remove(os.path.join(tmp, "repeat.tif"))
    _, nowrite_s, _, _ = file_run(mc, src)
    line = {
        "phase": "e2e_file", "model": "translation", "frames": n, "rmse_px": err,
        "frames_per_s": n / seconds, "correct_frames_per_s": n / mem_s,
        "repeat_frames_per_s": n / repeat_s, "no_output_frames_per_s": n / nowrite_s,
        **roofline(mc, n, stack.shape[1:], seconds, stack.dtype.itemsize),
        "write_tif_s": write_s, "decoder": res.timing["feeder"]["decoder"],
        "decoder_build_s": decoder_build_s, "stalls_s": _stalls(res),
        "output_equal_to_correct": equal, "transforms_equal": same_transforms,
        "launches": launches, "robustness": robust,
        "resume": {"killed": killed, "restored_frames": resumed.timing["restored_frames"],
                   "launches": resumed_launches,
                   "frames_per_s": (n - resumed.timing["restored_frames"]) / resumed_s,
                   "sha256_equal": sha == sha2, "sha256": sha[:16]},
        "card": smi,
    }
    emit(line)
    _check_rmse("e2e_file", err)
    check_launches("e2e_file", launches, WANT_LAUNCHES["translation"])
    if not (equal and same_transforms and killed and sha == sha2):
        raise AssertionError(f"e2e_file: {line}")
    return line, res.transforms


def phase_e2e_file_twopass(smi: str, tmp: str) -> dict:
    """Config 2's scene, 256 frames as a uint16 TIFF: a registration-only
    correct_file (emit_frames=False) whose transforms equal correct()'s
    on every frame the bounded warp kept (the registration-only pass
    runs no gather rescue, as the reference's, so the frames K7 flags
    keep their unpolished estimate); then apply_correction_file of its
    transforms to a second channel (deflate TIFF), equal to the
    in-memory apply_correction cast to uint16, bit for bit, K7 once per
    batch."""
    from kcmc_tpu_torch import apply_correction, apply_correction_file
    from kcmc_tpu_torch.io.tiff import read_stack
    from kcmc_tpu_torch.ops import cuda_build
    from kcmc_tpu_torch.utils.metrics import transform_rmse

    n, B = 256, 32
    stack_f, gt_rel, mc = _cell("affine", n)
    stack = _u16(stack_f)
    rng = np.random.default_rng(2)
    channel = _u16(0.5 * stack_f + rng.normal(0, 0.005, stack_f.shape))
    src, ch2, out = (os.path.join(tmp, f) for f in ("config2.tif", "ch2.tif", "ch2_out.tif"))
    _write_tif(src, stack)
    _write_tif(ch2, channel, compression="deflate")
    mem, mem_s, _, _ = counted_run(mc, stack)
    reg, seconds, launches, _ = file_run(mc, src, emit_frames=False)
    robust = check_robust_clean("e2e_file_twopass", reg)
    ok = np.asarray(reg.diagnostics["warp_ok"], bool)
    equal_kept = np.array_equal(reg.transforms[ok], mem.transforms[ok])
    flagged_gap = (transform_rmse(reg.transforms[~ok], mem.transforms[~ok], stack.shape[1:])
                   if (~ok).any() else 0.0)
    err = _rmse(reg, gt_rel, stack.shape[1:])
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    apply_correction_file(ch2, out, transforms=reg.transforms)
    apply_s = time.perf_counter() - t0
    apply_launches = cuda_build.launch_counts()
    want = apply_correction(channel, reg.transforms, output_dtype="input")
    apply_equal = np.array_equal(read_stack(out), want)
    line = {
        "phase": "e2e_file_twopass", "model": "affine", "frames": n, "rmse_px": err,
        "frames_per_s": n / seconds, "correct_frames_per_s": n / mem_s,
        **roofline(mc, n, stack.shape[1:], seconds, stack.dtype.itemsize, emit_frames=False),
        "warp_flagged": int((~ok).sum()),
        "correct_warp_rescued": int(np.sum(mem.diagnostics["warp_rescued"])),
        "transforms_equal_on_kept": equal_kept, "flagged_transform_gap_px": flagged_gap,
        "launches": {k: launches[k] + apply_launches[k] for k in launches},
        "registration_launches": launches, "robustness": robust,
        "apply": {"launches": apply_launches, "frames_per_s": n / apply_s,
                  "equal_to_apply_correction": apply_equal},
        "card": smi,
    }
    emit(line)
    _check_rmse("e2e_file_twopass", err)
    check_launches("e2e_file_twopass", launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, moment_maps=n // B + 1,
        binned_select_rows=n // B + 1, warp_batch_matrix=2 * (n // B)))
    check_launches("e2e_file_twopass[apply]", apply_launches,
                   _launches(warp_batch_matrix=n // B))
    if not (equal_kept and apply_equal):
        raise AssertionError(f"e2e_file_twopass: {line}")
    return line


def phase_e2e_file_faults(smi: str, tmp: str) -> dict:
    """Config 1's scene, 256 frames as a uint16 TIFF, through the
    robustness ladder: (a) an io_read and a device transient the retries
    absorb: output bytes equal to the clean run's; (b) a device fault
    that exhausts the retries: one batch re-run on the failover rung,
    the NumPy oracle on the host, its transforms bit-equal to a
    `get_backend("numpy", config)` run of that batch with its own
    prepared reference and within the reference's cross-backend bound
    (0.03 px) of the clean run's, the other batches bit-equal, RMSE <=
    0.05 px; (c) failover_backend=None with device:step=4:always: 32
    frames marked failed and interpolated, the other frames' RMSE <=
    0.05 px."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.backends import get_backend
    from kcmc_tpu_torch.utils.metrics import transform_rmse

    n, B = 256, 32
    stack_f, gt_rel, mc = _cell("translation", n)
    src = os.path.join(tmp, "config1_256.tif")
    u16 = _u16(stack_f)
    _write_tif(src, u16)
    shape = stack_f.shape[1:]

    def run(tag, **kw):
        mc = MotionCorrector(model="translation", rescue_escalate=False, **FAST_RETRY, **kw)
        out = os.path.join(tmp, f"faults_{tag}.tif")
        res, seconds, launches, warned = file_run(mc, src, output=out)
        return res, out, seconds, launches, warned, mc

    clean, clean_out, clean_s, launches, _, _ = run("clean")
    check_robust_clean("e2e_file_faults[clean]", clean)
    a, a_out, _, _, _, _ = run("absorbed", fault_plan="io_read:step=1:transient, "
                                                      "device:step=3:transient:times=2")
    b, _, b_s, b_launches, b_warned, b_mc = run("failover", fault_plan="device:step=2:always")
    c, _, _, _, c_warned, _ = run("failed", fault_plan="device:step=4:always",
                                  failover_backend=None)
    fo = np.zeros(n, bool)
    fo[2 * B:3 * B] = True
    # what the failover rung must have run: the oracle on that batch
    oracle = get_backend("numpy", b_mc.config)
    t0 = time.perf_counter()
    want = oracle.process_batch(u16[fo], oracle.prepare_reference(u16[0].astype(np.float32)),
                                np.arange(2 * B, 3 * B))
    oracle_s = time.perf_counter() - t0
    failed = np.asarray(c.diagnostics.get("frames_failed", np.zeros(n, bool)))
    lines = {
        "absorbed": {**a.timing["robustness"],
                     "bytes_equal": _sha256(a_out) == _sha256(clean_out)},
        "failover": {**b.timing["robustness"], "seconds": b_s, "launches": b_launches,
                     "batch_gap_px": transform_rmse(b.transforms[fo], clean.transforms[fo], shape),
                     "oracle_bit_equal": np.array_equal(b.transforms[fo], want["transform"]),
                     "oracle_host_cpu_seconds": oracle_s,
                     "others_bit_equal": np.array_equal(b.transforms[~fo], clean.transforms[~fo]),
                     "rmse_px": _rmse(b, gt_rel, shape), "warned": len(b_warned)},
        "failed": {**c.timing["robustness"], "frames_failed": int(failed.sum()),
                   "failed_frames_at": [int(i) for i in np.nonzero(failed)[0][[0, -1]]]
                   if failed.any() else [],
                   "rmse_px_others": transform_rmse(c.transforms[~failed], gt_rel[~failed], shape),
                   "rmse_px_interpolated": (transform_rmse(c.transforms[failed], gt_rel[failed],
                                                           shape) if failed.any() else None),
                   "warned": len(c_warned)},
    }
    line = {"phase": "e2e_file_faults", "model": "translation", "frames": n,
            "clean_frames_per_s": n / clean_s, "rmse_px": _rmse(clean, gt_rel, shape),
            **roofline(mc, n, shape, clean_s, 2),
            "launches": launches, **lines, "card": smi}
    emit(line)
    check_launches("e2e_file_faults", launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, warp_translation=2 * (n // B)))
    la, lb, lc = lines["absorbed"], lines["failover"], lines["failed"]
    ok = (la["bytes_equal"] and (la["io_retries"], la["device_retries"], la["backend_failovers"],
                                 la["failed_frames"]) == (1, 2, 0, 0)
          and (lb["device_retries"], lb["backend_failovers"], lb["failover_frames"],
               lb["failed_frames"]) == (2, 1, 32, 0)
          and lb["batch_gap_px"] <= 0.03 and lb["oracle_bit_equal"] and lb["others_bit_equal"]
          and lb["rmse_px"] <= 0.05
          and (lc["failed_frames"], lc["rescued_frames"], lc["backend_failovers"]) == (32, 32, 0)
          and lc["failed_frames_at"] == [4 * B, 5 * B - 1] and lc["rmse_px_others"] <= 0.05
          and line["rmse_px"] <= 0.05)
    if not ok:
        raise AssertionError(f"e2e_file_faults: {line}")
    return line


def phase_e2e_numpy(smi: str) -> dict:
    """The NumPy oracle beside the card: config 1's scene, 64 frames at
    512², batch 32, once through MotionCorrector(backend="numpy") on the
    host and once through the default corrector on the card. Each run
    under 0.05 px RMSE from the truth, the two within 0.03 px of each
    other (the reference's cross-backend bounds, tests/test_parity.py:
    42-44), and the host run launches no kernel. Its frames/s is the
    card host's CPU, not a card figure."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.ops import cuda_build
    from kcmc_tpu_torch.utils.metrics import transform_rmse

    n, B = 64, 32
    stack, gt_rel, mc = _cell("translation", n)
    shape = stack.shape[1:]
    card, card_s, card_launches, _ = counted_run(mc, stack)
    host_mc = MotionCorrector(model="translation", backend="numpy")
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    host = host_mc.correct(stack)
    host_s = time.perf_counter() - t0
    host_launches = sum(cuda_build.launch_counts().values())
    line = {"phase": "e2e_numpy", "model": "translation", "frames": n,
            "batch": host_mc.config.batch_size, "backend": host_mc.backend_name,
            "host_cpu_seconds": host_s, "host_cpu_frames_per_s": n / host_s,
            "host_cpu_note": "the card host's CPU (numpy), not a card figure",
            "host_rmse_px": _rmse(host, gt_rel, shape), "host_launches": host_launches,
            "card_seconds": card_s, "card_frames_per_s": n / card_s,
            "card_rmse_px": _rmse(card, gt_rel, shape),
            "cross_backend_rmse_px": transform_rmse(host.transforms, card.transforms, shape),
            "launches": card_launches,
            "robustness": {"host": check_robust_clean("e2e_numpy[host]", host),
                           "card": check_robust_clean("e2e_numpy[card]", card)},
            "card": smi}
    emit(line)
    check_launches("e2e_numpy", card_launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, warp_translation=2 * (n // B)))
    _check_rmse("e2e_numpy[host]", line["host_rmse_px"])
    _check_rmse("e2e_numpy[card]", line["card_rmse_px"])
    _check_rmse("e2e_numpy[cross]", line["cross_backend_rmse_px"], 0.03)
    if host_launches or host.corrected.shape != stack.shape \
            or not np.isfinite(host.corrected).all():
        raise AssertionError(f"e2e_numpy: {line}")
    return line


def phase_e2e_resumable(smi: str, tmp: str) -> dict:
    """ResumableCorrector on the card. Config 1's scene, 256 frames at
    512², batch 32, chunk_frames=64: a run killed after two chunks (its
    corrector's correct raises, as tests/test_checkpoint.py:33-63 kills
    it) and resumed restores 128 frames; its transforms are bit-equal to
    a one-shot correct(), its frames (re-warped by K7, 8 launches) within
    1e-4 of max|frame| of the one-shot run's (K3 and the polish). Config
    5, 16 volumes of 32x256x256, batch 8, chunk_frames=8: transforms
    bit-equal to a one-shot run."""
    from kcmc_tpu_torch.utils.checkpoint import ResumableCorrector

    class Killed(RuntimeError):
        pass

    n, B, chunk = 256, 32, 64
    stack, gt_rel, mc = _cell("translation", n)
    one, one_s, _, _ = counted_run(mc, stack)
    rc = ResumableCorrector(mc, os.path.join(tmp, "resumable.ckpt.npz"), chunk_frames=chunk)
    calls = [0]

    def killed_after_two_chunks(st, **kw):
        if calls[0] >= 2:
            raise Killed("killed after two chunks")
        calls[0] += 1
        return type(mc).correct(mc, st, **kw)

    mc.correct = killed_after_two_chunks
    t0 = time.perf_counter()
    try:
        rc.correct(stack)
    except Killed:
        pass
    else:
        raise AssertionError("e2e_resumable: the killed run ran to its end")
    finally:
        del mc.correct
    killed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mc.backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = rc.correct(stack)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    launches = mc.backend.launch_counts()
    scale = float(np.abs(one.corrected).max())
    frame_gap = float(np.abs(res.corrected - one.corrected).max()) / scale

    vols, _, vmc = path_input("rigid3d", 125)
    vols = vols[:16]
    vone = vmc.correct(vols)
    t0 = time.perf_counter()
    vres = ResumableCorrector(vmc, os.path.join(tmp, "resumable3d.ckpt.npz"),
                              chunk_frames=8).correct(vols)
    torch.cuda.synchronize()
    vol_s = time.perf_counter() - t0
    line = {"phase": "e2e_resumable", "model": "translation", "frames": n, "batch": B,
            "chunk_frames": chunk, "restored_frames": res.timing["restored_frames"],
            "one_shot_seconds": one_s, "killed_seconds": killed_s,
            "resumed_seconds": resumed_s, "transforms_bit_equal":
            np.array_equal(res.transforms, one.transforms),
            "rmse_px": _rmse(res, gt_rel, stack.shape[1:]), "frame_gap_rel": frame_gap,
            "launches": launches,
            "rigid3d": {"volumes": len(vols), "volume_shape": list(vols.shape[1:]),
                        "batch": vmc.config.batch_size, "chunk_frames": 8, "seconds": vol_s,
                        "transforms_bit_equal": np.array_equal(vres.transforms, vone.transforms),
                        "restored_frames": vres.timing["restored_frames"]},
            "card": smi}
    emit(line)
    check_launches("e2e_resumable", launches, _launches(
        detect_response=2 * (chunk // B + 1), extract_blended=2 * (chunk // B + 1),
        warp_translation=2 * (2 * chunk // B), warp_batch_matrix=n // B))
    _check_rmse("e2e_resumable", line["rmse_px"])
    if not (line["restored_frames"] == 2 * chunk and line["transforms_bit_equal"]
            and frame_gap <= 1e-4 and line["rigid3d"]["transforms_bit_equal"]
            and res.corrected.shape == stack.shape and vres.corrected.shape == vols.shape
            and np.isfinite(vres.corrected).all()):
        raise AssertionError(f"e2e_resumable: {line}")
    return line


def _bucket(url: str) -> dict:
    """{key: bytes} of every object of an emulated bucket: the chunks and
    both manifest generations."""
    from kcmc_tpu_torch.io.objectstore import client_for_url

    client = client_for_url(url)
    return {k: client.get(k) for k in client.list("")}


OBJECT_STORM = ("object:step=3:drop, object:step=5:stall=0.2, object:step=7:flip, "
                "object:step=9:truncate, object:step=11:throttle")


def phase_e2e_object(smi: str, tmp: str) -> dict:
    """Config 1's scene, 512 frames as uint16 in an emulated bucket
    (put_stack, 64-frame chunk objects): a checkpointed correct_file from
    emu://.../in to emu://.../out (checkpoint_every=128) whose frames
    equal, bit for bit, correct_file of the same frames from a local TIFF,
    with equal transforms and launches K1/K2/K3 17/17/32; a run killed by
    device:step=8:fatal and resumed, whose bucket (chunks and both
    manifests) equals the uninterrupted one byte for byte with fewer
    PUTs; and a fault storm on the object surface (drop, stall=0.2, flip,
    truncate, throttle; object_timeout_s=2, io_workers=1 so every GET
    rides the consumer's armed reader) whose bucket equals it too. The
    bucket is on the host's disk: frames/s beside the local file's, no
    limit."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.io import open_stack, put_stack
    from kcmc_tpu_torch.io.objectstore import reset_url_state, stats_snapshot
    from kcmc_tpu_torch.io.tiff import read_stack
    from kcmc_tpu_torch.utils.faults import FatalFaultError

    n, B = 512, 32
    stack_f, gt_rel, mc = _cell("translation", n)
    stack = _u16(stack_f)
    src, out, resumed_url, storm_url = (f"emu://{tmp}/{k}"
                                        for k in ("in", "out", "resumed", "storm"))
    t0 = time.perf_counter()
    put_stack(src, stack, chunk_frames=mc.config.object_chunk_frames)
    put_s = time.perf_counter() - t0
    tif, tif_out = os.path.join(tmp, "object_local.tif"), os.path.join(tmp, "object_out.tif")
    _write_tif(tif, stack)
    local, local_s, _, _ = file_run(mc, tif, output=tif_out)
    ckpt = dict(checkpoint_every=128)
    res, seconds, launches, _ = file_run(mc, src, output=out,
                                         checkpoint=os.path.join(tmp, "obj.ckpt.npz"), **ckpt)
    robust = check_robust_clean("e2e_object", res)
    err = _rmse(res, gt_rel, stack.shape[1:])
    with open_stack(out) as ts:
        frames_equal = np.array_equal(ts.read(0, len(ts)), read_stack(tif_out))
    same_transforms = np.array_equal(res.transforms, local.transforms)
    full_puts = stats_snapshot(out)["puts"]
    reference = _bucket(out)

    # killed on the consumer side at batch 8, then resumed
    kill_ckpt = os.path.join(tmp, "obj_kill.ckpt.npz")
    killer = MotionCorrector(model="translation", rescue_escalate=False,
                             fault_plan="device:step=8:fatal")
    try:
        killer.correct_file(src, output=resumed_url, checkpoint=kill_ckpt, **ckpt)
        killed = False
    except FatalFaultError:
        killed = True
    puts_before = stats_snapshot(resumed_url)["puts"]
    resumed, resumed_s, resumed_launches, _ = file_run(mc, src, output=resumed_url,
                                                       checkpoint=kill_ckpt, **ckpt)
    resumed_puts = stats_snapshot(resumed_url)["puts"] - puts_before
    resumed_equal = _bucket(resumed_url) == reference

    # the fault storm, with fresh per-URL counters on the source
    reset_url_state(src)
    stormer = MotionCorrector(model="translation", rescue_escalate=False, io_workers=1,
                              fault_plan=OBJECT_STORM, object_timeout_s=2.0, **FAST_RETRY)
    storm, storm_s, _, storm_warned = file_run(stormer, src, output=storm_url)
    storm_equal = _bucket(storm_url) == reference
    with open_stack(storm_url) as ts:
        storm_frames = len(ts)
    obj = storm.timing["feeder"]["object"]
    counters = ("gets", "hedged", "hedge_wins", "retries", "throttled", "refetched", "puts")
    line = {
        "phase": "e2e_object", "model": "translation", "frames": n, "rmse_px": err,
        "frames_per_s": n / seconds, "local_file_frames_per_s": n / local_s,
        **roofline(mc, n, stack.shape[1:], seconds, stack.dtype.itemsize),
        "put_stack_s": put_s, "chunk_objects": len([k for k in reference if k.startswith("chunk-")]),
        "frames_equal_to_local_file": frames_equal, "transforms_equal": same_transforms,
        "launches": launches, "robustness": robust, "object": res.timing["feeder"]["object"],
        "resume": {"killed": killed, "restored_frames": resumed.timing["restored_frames"],
                   "launches": resumed_launches,
                   "frames_per_s": (n - resumed.timing["restored_frames"]) / resumed_s,
                   "puts": resumed_puts, "uninterrupted_puts": full_puts,
                   "bucket_equal": resumed_equal},
        "storm": {"plan": OBJECT_STORM, "frames": storm_frames, "bucket_equal": storm_equal,
                  "seconds": storm_s, "robustness": {k: storm.timing["robustness"][k]
                                                     for k in ("io_retries", "faults_injected")},
                  "ingest": {k: obj["ingest"][k] for k in counters},
                  "egress": {k: obj["egress"][k] for k in counters},
                  "warned": len(storm_warned)},
        "card": smi,
    }
    emit(line)
    _check_rmse("e2e_object", err)
    check_launches("e2e_object", launches, _launches(
        detect_response=n // B + 1, extract_blended=n // B + 1, warp_translation=2 * (n // B)))
    if not (frames_equal and same_transforms and killed and resumed_equal
            and resumed_puts < full_puts and storm_equal and storm_frames == n
            and storm.timing["robustness"]["faults_injected"] > 0):
        raise AssertionError(f"e2e_object: {line}")
    return line


# e2e_plans: the child process of the cold and warm starts. argv: mode
# ("cold", "warm" or "nowarm"), the cache directory, the JSON file it
# writes. Config 1's corrector with plan_buckets=PLAN_BUCKETS; "cold" and
# "warm" run warmup(dtypes=("float32", "uint16")) first; then one batch
# of config 1's scene cropped to PLAN_CROP, in uint16, is corrected to
# uint16 (the warmed register and cast programs).
PLAN_BUCKETS = (256, 512)
PLAN_CROP = (500, 496)
PLAN_CHILD = r"""
import json, sys, time
t_start = time.time()
mode, cache, out = sys.argv[1:4]
import numpy as np
import torch
from kcmc_tpu_torch import MotionCorrector
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils.synthetic import make_drift_stack
import_s = time.time() - t_start
data = make_drift_stack(n_frames=32, shape=(512, 512), model="translation", seed=0)
stack = np.clip(data.stack[:, :%d, :%d] * 40000, 0, 65535).astype(np.uint16)
data_s = time.time() - t_start - import_s
mc = MotionCorrector(model="translation", plan_buckets=%r, compile_cache_dir=cache,
                     rescue_escalate=False)
summary = None
if mode != "nowarm":
    summary = mc.warmup(dtypes=("float32", "uint16"))
    summary.pop("plan_cache")
t_warm = time.time()
res = mc.correct(stack, output_dtype="input")
torch.cuda.synchronize()
t_first = time.time()
pc = res.timing["plan_cache"]
json.dump({"mode": mode, "t_first": t_first, "import_s": import_s, "data_s": data_s,
           "correct_s": t_first - t_warm, "warmup": summary,
           "nvcc_runs": cuda_build.NVCC_RUNS,
           "libs_loaded": sorted({n for n, _ in cuda_build._LIBS}),
           "lib_dir": str(cuda_build.lib_dir()),
           "plan_cache": {k: pc[k] for k in ("bucket_exact", "bucket_padded", "bucket_fallback",
                                             "stamp_hits", "stamp_misses", "compile_counts")},
           "finite": bool(res.corrected.dtype == np.uint16
                          and np.isfinite(res.transforms).all())}, open(out, "w"))
""" % (PLAN_CROP + (PLAN_BUCKETS,))


def _plan_child(mode: str, cache: str, tmp: str) -> dict:
    """One cold- or warm-start process; its record plus the wall time
    from its spawn to its first corrected batch."""
    out = os.path.join(tmp, f"plan_{mode}.json")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", PLAN_CHILD, mode, cache, out], cwd=_ROOT,
                          env=_child_env(), capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"e2e_plans: the {mode} process failed:\n{proc.stderr[-4000:]}")
    with open(out) as f:
        rec = json.load(f)
    rec["start_to_first_batch_s"] = rec.pop("t_first") - t0
    return rec


def _corner_gap(a: np.ndarray, b: np.ndarray, shape) -> np.ndarray:
    """Per-frame largest displacement (px) between two (T, 3, 3) maps at
    the frame's four corners."""
    h, w = shape
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T
    pa, pb = a.astype(np.float64) @ c, b.astype(np.float64) @ c
    pa, pb = pa[:, :2] / pa[:, 2:], pb[:, :2] / pb[:, 2:]
    return np.abs(pa - pb).max(axis=(1, 2))


def _plans_run(mc, stack):
    """A warm-up correct() of one batch, then the timed correct() of the
    stack, with the launch counters and the routing counters read as
    deltas over that run: (result, seconds, launches, routing)."""
    keys = ("bucket_exact", "bucket_padded", "bucket_fallback")
    mc.correct(stack[:mc.config.batch_size])
    torch.cuda.synchronize()
    before = mc.backend.plan_cache_stats()
    mc.backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = mc.correct(stack)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mc.backend.launch_counts()
    after = mc.backend.plan_cache_stats()
    return res, seconds, launches, {k: after[k] - before[k] for k in keys}


def phase_e2e_plans(smi: str, tmp: str) -> dict:
    """Execution plans (queue 1 item 16), config 1 with
    plan_buckets=(256, 512):
    - cold: a process with a fresh compile_cache_dir runs
      warmup(dtypes=("float32", "uint16")) (its nvcc round builds the
      libraries into the cache), then corrects one uint16 batch of
      500x496 to uint16; warm: a second process on the same directory
      must report stamp_misses 0 (in its warmup and over the whole
      process: the cold one stamped its batch's register and cast
      programs), stamp_hits equal to the cold process's programs, every
      library cached and no nvcc run; nowarm: a third process on the
      same directory corrects without a warmup. Each process's time
      from its spawn to its first corrected batch is printed (no limit);
    - polish off: 512 frames of config 1's scene cropped to 500x496,
      through the 512 bucket (16 batches padded) and unbucketed: equal
      keypoint counts and warp_ok, the frames whose transforms are equal
      equal within TOL of max|frame|; the transforms' corner gaps and
      the frames whose match counts differ (the describe stage's mean
      runs over the bucket canvas, pad zeros included, as the
      reference's: tests/plans_witness.py reads the same divergence in
      the JAX package's own bucketed and unbucketed runs on the CPU)
      printed, RMSE of both <= 0.05 px within 0.005 px of
      each other (no polish: ~0.065 px each, limit 0.1), every corner gap
      under 0.05 px;
    - polish on (config 1's default): the two routes' RMSE within 0.02
      px of each other;
    - exact: 128 frames of 512x512 count only bucket_exact, transforms
      within 1e-3 px at the corners of the unbucketed run's;
    - affine: 64 frames of 512x512 affine drift cropped to 500x496
      (K1, K6, K7 on the canvas; polish on): RMSE <= 0.05 px both routes,
      within 0.02 px of each other;
    - fallback: 64 frames of 600x600 count bucket_fallback only; with the
      retrace sentinel armed after every bucketed corrector's warmup, the
      bucketed runs record no violation and the fallback run exactly
      one each for 'reference' and 'register' at 600x600.
    The line's launches are the bucketed and fallback runs'."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.analysis import sanitize
    from kcmc_tpu_torch.plans.runtime import predict_compile_keys
    from kcmc_tpu_torch.utils.metrics import relative_transforms
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    t_phase = time.perf_counter()
    cache = os.path.join(tmp, "plan_cache")
    procs = {mode: _plan_child(mode, cache, tmp) for mode in ("cold", "warm", "nowarm")}
    cold, warm = procs["cold"]["warmup"], procs["warm"]["warmup"]
    processes_s = time.perf_counter() - t_phase

    n, B = 512, 32
    full, gt_rel, _ = _cell("translation", n)
    h, w = PLAN_CROP
    crop = np.ascontiguousarray(full[:, :h, :w])
    aff = make_drift_stack(n_frames=64, shape=(512, 512), model="affine", seed=0)
    aff_crop, aff_gt = np.ascontiguousarray(aff.stack[:, :h, :w]), relative_transforms(aff.transforms)
    wide = make_drift_stack(n_frames=64, shape=(600, 600), model="translation", seed=0)
    common = dict(rescue_escalate=False)

    def corrector(model="translation", buckets=(), **kw):
        return MotionCorrector(model=model, plan_buckets=buckets, **common, **kw)

    # the unbucketed runs first: their first builds are not the ladder's
    u0, u0_s, u0_l, _ = _plans_run(corrector(transform_polish=0), crop)
    u1, u1_s, u1_l, _ = _plans_run(corrector(), crop)
    ux, _, _, _ = _plans_run(corrector(), full[:128])
    ua, _, ua_l, _ = _plans_run(corrector("affine"), aff_crop)
    p0 = corrector(transform_polish=0, buckets=PLAN_BUCKETS)
    p1 = corrector(buckets=PLAN_BUCKETS)
    pa = corrector("affine", buckets=PLAN_BUCKETS)
    for mc in (p0, p1, pa):
        mc.warmup()
    sanitize.take_violations()
    runs = {}
    with sanitize.retrace_sentinel(predicted=predict_compile_keys(p1.config), label="e2e_plans"):
        for tag, mc, stack in (("polish_off", p0, crop), ("polish_on", p1, crop),
                               ("exact", p1, full[:128]), ("affine", pa, aff_crop)):
            runs[tag] = _plans_run(mc, stack)
        bucketed_violations = sanitize.take_violations()
        runs["fallback"] = _plans_run(p1, wide.stack)
    fallback_violations = sanitize.take_violations()

    r0, r1, rx, ra, rf = (runs[k][0] for k in ("polish_off", "polish_on", "exact", "affine",
                                              "fallback"))
    rmse = {k: _rmse(runs[k][0], g, s.shape[1:]) for k, g, s in (
        ("polish_off", gt_rel, crop), ("polish_on", gt_rel, crop), ("exact", gt_rel[:128], full),
        ("affine", aff_gt, aff_crop), ("fallback", relative_transforms(wide.transforms), wide.stack))}
    rmse_plain = {"polish_off": _rmse(u0, gt_rel, crop.shape[1:]),
                  "polish_on": _rmse(u1, gt_rel, crop.shape[1:]),
                  "affine": _rmse(ua, aff_gt, aff_crop.shape[1:])}
    gap = _corner_gap(r0.transforms, u0.transforms, PLAN_CROP)
    same = np.all(r0.transforms == u0.transforms, axis=(1, 2))
    kept = same & ~r0.diagnostics["warp_rescued"] & ~u0.diagnostics["warp_rescued"]
    scale = float(np.abs(crop).max())
    kept_gap = (float(np.abs(r0.corrected[kept] - u0.corrected[kept]).max()) / scale
                if kept.any() else None)
    diag_differ = {k: int((r0.diagnostics[k] != u0.diagnostics[k]).sum())
                   for k in ("n_keypoints", "n_matches", "n_inliers", "rms_residual",
                             "warp_rescued")}
    exact_gap = float(_corner_gap(rx.transforms, ux.transforms, (512, 512)).max())
    violations = [v for v in fallback_violations]
    want_violations = {("reference", "600x600"), ("register", "600x600")}
    got_violations = sorted((v.split("'")[1], v.split(" compiled at ")[1].split("/")[0])
                            for v in violations)
    launches = dict(ZERO)
    for tag in runs:
        for k, v in runs[tag][2].items():
            launches[k] += v
    line = {
        "phase": "e2e_plans", "model": "translation", "buckets": list(PLAN_BUCKETS),
        "crop": list(PLAN_CROP),
        **{mode: {k: procs[mode][k] for k in ("start_to_first_batch_s", "correct_s", "import_s",
                                              "data_s", "nvcc_runs", "libs_loaded",
                                              "plan_cache")}
           | {k: procs[mode]["warmup"][k] for k in (
               "programs_built", "stamp_hits", "stamp_misses", "build_s", "libraries",
               "libraries_s", "compile_s")}
           for mode in ("cold", "warm")},
        "nowarm": {k: procs["nowarm"][k] for k in ("start_to_first_batch_s", "correct_s",
                                                  "import_s", "data_s", "nvcc_runs",
                                                  "plan_cache")},
        "processes_s": processes_s,
        "runs": {tag: {"frames": len(s), "seconds": runs[tag][1],
                       "frames_per_s": len(s) / runs[tag][1], "rmse_px": rmse[tag],
                       "routing": runs[tag][3],
                       "launches": {k: v for k, v in runs[tag][2].items() if v}}
                 for tag, s in (("polish_off", crop), ("polish_on", crop), ("exact", full[:128]),
                                ("affine", aff_crop), ("fallback", wide.stack))},
        "unbucketed": {"rmse_px": rmse_plain,
                       "frames_per_s": {"polish_off": n / u0_s, "polish_on": n / u1_s},
                       "launches": {"polish_off": {k: v for k, v in u0_l.items() if v},
                                    "affine": {k: v for k, v in ua_l.items() if v}}},
        "polish_off_parity": {
            "max_corner_gap_px": float(gap.max()), "frames_within_1e-3_px": int((gap <= 1e-3).sum()),
            "frames_equal_transforms": int(same.sum()), "kept_frames_gap": kept_gap,
            "frames_differing": diag_differ},
        "exact_max_corner_gap_px": exact_gap,
        "sentinel": {"bucketed_violations": len(bucketed_violations),
                     "fallback_violations": got_violations},
        "launches": launches, "seconds": time.perf_counter() - t_phase, "card": smi,
    }
    emit(line)
    for tag in rmse:
        # without the polish config 1 reads ~0.065 px on either route
        _check_rmse(f"e2e_plans {tag}", rmse[tag], 0.1 if tag == "polish_off" else 0.05)
    fails = []
    if warm["stamp_misses"] != 0 or warm["stamp_hits"] != cold["stamp_hits"] + cold["stamp_misses"]:
        fails.append("warm process stamps")
    if procs["warm"]["plan_cache"]["stamp_misses"] or procs["nowarm"]["plan_cache"]["stamp_misses"]:
        # their uint16 batch (register, cast) was stamped by the cold one
        fails.append("warm process's first batch missed a stamp")
    if procs["warm"]["nvcc_runs"] or procs["nowarm"]["nvcc_runs"] or not all(
            v["cached"] for v in warm["libraries"].values()):
        fails.append("warm process ran nvcc")
    for mode in ("cold", "warm"):
        if not set(procs[mode]["libs_loaded"]) <= set(cold["libraries"]):
            fails.append(f"{mode} process loaded a library its warmup did not build")
        if not procs[mode]["lib_dir"].startswith(cache):
            fails.append(f"{mode} process's libraries are not under the cache")
    if cold["stamp_misses"] < cold["programs_built"] or not all(
            procs[m]["finite"] for m in procs):
        fails.append("cold process")
    if diag_differ["n_keypoints"] or diag_differ["warp_rescued"]:
        fails.append("polish-off keypoints or warp_ok differ")
    if gap.max() > 0.05 or abs(rmse["polish_off"] - rmse_plain["polish_off"]) > 0.005:
        fails.append("polish-off transforms")
    if kept_gap is not None and kept_gap > TOL:
        fails.append("polish-off kept frames")
    if runs["polish_off"][3] != {"bucket_exact": 0, "bucket_padded": n // B, "bucket_fallback": 0}:
        fails.append("polish-off routing")
    if abs(rmse["polish_on"] - rmse_plain["polish_on"]) > 0.02:
        fails.append("polish-on plateau")
    if abs(rmse["affine"] - rmse_plain["affine"]) > 0.02:
        fails.append("affine plateau")
    if runs["exact"][3] != {"bucket_exact": 4, "bucket_padded": 0, "bucket_fallback": 0} \
            or exact_gap > 1e-3:
        fails.append("exact run")
    if runs["fallback"][3] != {"bucket_exact": 0, "bucket_padded": 0, "bucket_fallback": 2}:
        fails.append("fallback routing")
    if bucketed_violations or len(violations) != 2 or set(got_violations) != want_violations:
        fails.append("retrace sentinel")
    if not (runs["polish_off"][2]["detect_response"] and runs["polish_off"][2]["warp_translation"]
            and runs["affine"][2]["warp_batch_matrix"]):
        fails.append("kernel launches")
    if fails:
        raise AssertionError(f"e2e_plans: {fails}")
    return line


def phase_selftest(smi: str, tmp: str, proc: subprocess.Popen) -> dict:
    """`python -m kcmc_tpu_torch selftest` in a child process (started by
    `phase_e2e_cli` beside its other children, `_cli_child`): its stdout
    is the JSON summary (the per-check lines go to its stderr); every
    record printed, any record that is not ok, or a non-zero exit,
    fails the smoke."""
    rec = _cli_finish(tmp, proc, timeout=600)
    summary = rec["json"]
    results = summary["results"]
    bad = [r["name"] for r in results if not r["ok"]]
    line = {"phase": "selftest", "seconds": rec["seconds"], "passed": summary["passed"],
            "failed": summary["failed"], "records": results, "card": smi}
    emit(line)
    if bad or summary["failed"]:
        raise AssertionError(f"selftest: records not ok: {bad}")
    return line


def dispatch_profile(mc, stack) -> dict:
    """Where a correct() of `stack` spends the card's time, per batch: the
    wall time of an unprofiled run, then one torch.profiler pass of the
    same run for the device busy time (the union of kernel and copy
    intervals), the idle share (1 - busy / wall), and the host-to-card
    and card-to-host copies' device time with their kinds (pageable or
    pinned, from the copy's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B = mc.config.batch_size
    nb = -(-len(stack) // B)
    mc.correct(stack[:B])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc.correct(stack)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / nb
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mc.correct(stack)
        torch.cuda.synchronize()
    work = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("kcmc.")]
    busy, end = 0.0, -1.0
    for e in sorted(work, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    copies: dict[str, list] = {}
    for e in work:
        for way in ("HtoD", "DtoH"):
            if way in e.name:
                c = copies.setdefault(way, [0.0, 0, set()])
                c[0] += e.time_range.end - e.time_range.start
                c[1] += 1
                c[2].add(e.name)
    busy_ms = busy / 1e3 / nb
    return {
        "batches": nb, "wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        **{f"{way.lower()}_ms_per_batch": c[0] / 1e3 / nb for way, c in copies.items()},
        "copies": {way: {"calls_per_batch": c[1] / nb, "kinds": sorted(c[2])}
                   for way, c in copies.items()},
    }


def _digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_e2e_overlap(smi: str, tmp: str) -> dict:
    """The pipelined dispatch on config 1 (1000 frames of 512², float32
    host stack, K=512, batch 32): correct() with upload_overlap on (the
    default) and off, equal sha256 of the corrected frames and equal
    transforms, both at K1/K2/K3 33/33/64, with timing["pipeline"], the
    stalls and peak device memory of each; e2e_file's uint16 TIFF
    through a serial correct_file, whose output must have the sha256 of
    e2e_file's overlapped and its killed-and-resumed outputs; and the
    dispatch profile (copies' device time, idle share) of 224 frames
    each way."""
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    stack, gt, on = path_input("translation", 1000)
    off = path_input("translation", 1000, upload_overlap=False)[2]
    lines = {}
    for tag, mc in (("overlap", on), ("serial", off)):
        res, seconds, launches, _ = counted_run(mc, stack)
        check_launches(f"e2e_overlap:{tag}", launches, WANT_LAUNCHES["translation"])
        lines[tag] = (res, {
            "frames_per_s": len(stack) / seconds, "seconds": seconds,
            "rmse_px": _rmse(res, relative_transforms(gt), stack.shape[1:]),
            "pipeline": res.timing["pipeline"], "stalls_s": res.timing.get("stalls_s", {}),
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "robustness": check_robust_clean(f"e2e_overlap:{tag}", res),
            "launches": launches, "sha256": _digest(res.corrected)[:16]})
    (r_on, on_line), (r_off, off_line) = lines["overlap"], lines["serial"]
    same = (_digest(r_on.corrected) == _digest(r_off.corrected)
            and np.array_equal(r_on.transforms, r_off.transforms))
    src = os.path.join(tmp, "config1.tif")
    ser = path_input("translation", 1000, upload_overlap=False)[2]
    fres, fsec, flaunch, _ = file_run(ser, src, output=os.path.join(tmp, "serial.tif"))
    file_sha = {k: _sha256(os.path.join(tmp, f)) for k, f in (
        ("serial", "serial.tif"), ("overlap", "out.tif"), ("overlap_resumed", "resumed.tif"))}
    prof = {"overlap": dispatch_profile(on, stack[:224]),
            "serial": dispatch_profile(off, stack[:224])}
    line = {"phase": "e2e_overlap", "model": "translation", "frames": len(stack),
            "outputs_equal": same, "overlap": on_line, "serial": off_line,
            "file": {"serial_frames_per_s": len(stack) / fsec, "launches": flaunch,
                     "pipeline": fres.timing["pipeline"],
                     "sha256_equal": len(set(file_sha.values())) == 1,
                     "sha256": file_sha["serial"][:16]},
            "profile_224_frames": prof, "card": smi}
    emit(line)
    for tag in ("overlap", "serial"):
        _check_rmse(f"e2e_overlap:{tag}", lines[tag][1]["rmse_px"])
    if not (same and line["file"]["sha256_equal"]):
        raise AssertionError(f"e2e_overlap: outputs differ: {line}")
    if not (on_line["pipeline"]["upload_overlap"] and on_line["pipeline"]["upload_waits"] == 31
            and not off_line["pipeline"]["upload_overlap"]):
        raise AssertionError(f"e2e_overlap: pipeline {on_line['pipeline']} / {off_line['pipeline']}")
    check_launches("e2e_overlap:file", flaunch, WANT_LAUNCHES["translation"])
    total = {k: on_line["launches"][k] + off_line["launches"][k] + flaunch[k] for k in ZERO}
    return {**line, "launches": total}


def _trace_counts(trace: dict) -> dict:
    """Span, instant and counter counts of a Chrome trace, and the
    thread each upload.stage span ran on."""
    from collections import Counter

    evs = trace["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    return {"names": Counter(e["name"] for e in evs if e["ph"] != "M"),
            "upload_tracks": sorted({tracks.get(e["tid"], "?") for e in evs
                                     if e["name"] == "upload.stage"}),
            "dispatch_tracks": sorted({tracks.get(e["tid"], "?") for e in evs
                                       if e["name"] == "dispatch_batch"})}


def phase_e2e_obs(smi: str, tmp: str) -> dict:
    """The one-shot run's observability on config 1 (1000 frames of
    512², float32, K=512, batch 32): correct() with trace_path,
    frame_records_path and heartbeat_s=1.0 armed against the same run
    with them off, as interleaved pairs (on, off, off, on), each with
    the launch counters set to 0 just before it: equal sha256 and
    transforms, K1/K2/K3 33/33/64 each way. The armed run's trace: 32
    dispatch_batch spans, one upload.stage span per staged batch (the
    reference's rule: every batch after the first, kcmc_tpu/corrector.py:
    1690-1764) on the upload worker's own track, the stage spans, one
    frames_done counter per drained batch, every name in
    obs/registry.SPAN_NAMES; its records: 1000 records with the header
    and the summary; timing["latency"] and timing["stage_mean_s"]; at
    least one heartbeat and no kcmc-heartbeat thread after the run.
    Then e2e_file's uint16 TIFF through correct_file with
    frame_records_path, killed by device:step=20:fatal and resumed: one
    record per frame behind a kcmc_run_resume marker, and e2e_file's
    output sha256."""
    import threading

    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.obs import heartbeat, records, registry
    from kcmc_tpu_torch.utils.faults import FatalFaultError
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    trace_p, recs_p = os.path.join(tmp, "obs_trace.json"), os.path.join(tmp, "obs.jsonl")
    obs = dict(trace_path=trace_p, frame_records_path=recs_p, heartbeat_s=1.0)
    stack, gt, on = path_input("translation", 1000, **obs)
    off = path_input("translation", 1000)[2]
    beats = []
    emit_beat = heartbeat._default_emit

    def counting_emit(message):
        beats.append(message)
        emit_beat(message)

    heartbeat._default_emit = counting_emit
    runs = []
    try:
        for tag, mc in (("on", on), ("off", off), ("off", off), ("on", on)):
            n_beats = len(beats)
            res, seconds, launches, _ = counted_run(mc, stack)
            check_launches(f"e2e_obs:{tag}", launches, WANT_LAUNCHES["translation"])
            runs.append((tag, res, seconds, launches, len(beats) - n_beats))
    finally:
        heartbeat._default_emit = emit_beat
    shas = {_digest(r.corrected) for _, r, *_ in runs}
    same = len(shas) == 1 and all(np.array_equal(r.transforms, runs[0][1].transforms)
                                   for _, r, *_ in runs)
    fps = {t: [len(stack) / s for tag, _, s, *_ in runs if tag == t] for t in ("on", "off")}
    spread = {t: (max(v) - min(v)) / min(v) for t, v in fps.items()}
    res = runs[-1][1]  # the last armed run wrote the trace and the records
    trace = json.load(open(trace_p))
    tc = _trace_counts(trace)
    names = tc["names"]
    n_batches = -(-len(stack) // on.config.batch_size)
    header, recs, summary = records.read_jsonl(recs_p)
    leaked = [t.name for t in threading.enumerate() if t.name == "kcmc-heartbeat"]
    # e2e_file's TIFF: killed at batch 20 and resumed, with the records
    src = os.path.join(tmp, "config1.tif")
    frecs, fout, fck = (os.path.join(tmp, f) for f in ("file.jsonl", "obs_out.tif",
                                                         "obs.ckpt.npz"))
    killer = MotionCorrector(model="translation", rescue_escalate=False,
                             fault_plan="device:step=20:fatal", frame_records_path=frecs)
    try:
        killer.correct_file(src, output=fout, checkpoint=fck, checkpoint_every=256)
        killed = False
    except FatalFaultError:
        killed = True
    resumer = path_input("translation", 1000, frame_records_path=frecs)[2]
    fres, fsec, flaunch, _ = file_run(resumer, src, output=fout, checkpoint=fck,
                                      checkpoint_every=256)
    _, frec, fsum = records.read_jsonl(frecs)
    resume_markers = sum('"kind": "kcmc_run_resume"' in ln for ln in open(frecs))
    file_sha_equal = _sha256(fout) == _sha256(os.path.join(tmp, "out.tif"))
    expect = {"dispatch_batch": n_batches, "upload.stage": n_batches - 1,
              "frames_done": n_batches}
    line = {
        "phase": "e2e_obs", "model": "translation", "frames": len(stack),
        "outputs_equal": same, "sha256": sorted(shas)[0][:16],
        "launches_each": {tag: {k: v for k, v in l.items() if v} for tag, _, _, l, _ in runs},
        "frames_per_s": {"order": [t for t, *_ in runs], "on": fps["on"], "off": fps["off"],
                         "on_over_off": float(np.mean(fps["on"]) / np.mean(fps["off"])),
                         "spread": spread},
        "rmse_px": _rmse(res, relative_transforms(gt), stack.shape[1:]),
        "trace": {"spans": dict(sorted(names.items())), "expected": expect,
                  "upload_tracks": tc["upload_tracks"],
                  "dispatch_tracks": tc["dispatch_tracks"],
                  "unregistered": sorted(set(names) - registry.SPAN_NAMES),
                  "bytes": os.path.getsize(trace_p)},
        "records": {"n": len(recs), "header": bool(header), "summary": summary is not None,
                    "bytes": os.path.getsize(recs_p)},
        "latency": res.timing.get("latency"), "stage_mean_s": res.timing["stage_mean_s"],
        "heartbeat": {"beats_per_run": [b for tag, *_, b in runs], "leaked_threads": leaked,
                      "last": beats[-1] if beats else None},
        "file_resume": {"killed": killed, "restored_frames": fres.timing["restored_frames"],
                        "records": len(frec), "frames_unique": len({r["frame"] for r in frec}),
                        "resume_markers": resume_markers, "summary": fsum is not None,
                        "sha256_equal_e2e_file": file_sha_equal, "launches": flaunch},
        "card": smi,
    }
    emit(line)
    _check_rmse("e2e_obs", line["rmse_px"])
    got = {k: names.get(k, 0) for k in expect}
    if not same or got != expect or line["trace"]["unregistered"]:
        raise AssertionError(f"e2e_obs: outputs or trace wrong: {line}")
    if not (tc["upload_tracks"] and all(t.startswith("kcmc-upload") for t in tc["upload_tracks"])
            and tc["dispatch_tracks"] == ["MainThread"]):
        raise AssertionError(f"e2e_obs: spans on the wrong tracks: {tc}")
    if not {"prepare_reference", "register_batches", "drain_sync"} <= set(names):
        raise AssertionError(f"e2e_obs: stage spans missing: {sorted(names)}")
    if [r["frame"] for r in recs] != list(range(len(stack))) or not (header and summary):
        raise AssertionError(f"e2e_obs: records {line['records']}")
    totals = (res.timing.get("latency") or {}).get("totals", {})
    if {k: v["count"] for k, v in totals.items()} != dict.fromkeys(
            ("request.dispatch", "request.device", "request.drain"), len(stack)):
        raise AssertionError(f"e2e_obs: latency {totals}")
    if not all(b >= 1 for tag, *_, b in runs if tag == "on") or leaked or any(
            b for tag, *_, b in runs if tag == "off"):
        raise AssertionError(f"e2e_obs: heartbeat {line['heartbeat']}")
    if not (killed and file_sha_equal and resume_markers == 1
            and [r["frame"] for r in frec] == list(range(len(stack)))):
        raise AssertionError(f"e2e_obs: file resume {line['file_resume']}")
    total = {k: sum(l[k] for _, _, _, l, _ in runs) + flaunch[k] for k in ZERO}
    return {**line, "launches": total}


_ROOT = os.path.dirname(os.path.abspath(__file__))


def _child_env() -> dict:
    """A child process's environment: the checkout on its path, no
    ambient compile cache and no armed sanitizer."""
    env = {**os.environ, "PYTHONPATH": _ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for k in ("KCMC_COMPILE_CACHE", "KCMC_SANITIZE", "KCMC_SANITIZE_STRICT"):
        env.pop(k, None)
    return env


def _cli_child(tmp: str, tag: str, *args: str) -> subprocess.Popen:
    """`python -m kcmc_tpu_torch ARGS` started in the background, its
    stdout and stderr to files in `tmp`."""
    out = open(os.path.join(tmp, f"cli_{tag}.out"), "w")
    err = open(os.path.join(tmp, f"cli_{tag}.err"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "kcmc_tpu_torch", *args], cwd=_ROOT,
                            env=_child_env(), stdout=out, stderr=err, text=True)
    out.close()
    err.close()
    proc.tag, proc.t0 = tag, time.time()
    return proc


def _cli_finish(tmp: str, proc: subprocess.Popen, timeout: float = 300) -> dict:
    """Wait for a `_cli_child`: its exit code (non-zero fails the
    smoke), seconds from spawn to its last write (the child may have
    ended well before this wait), stdout's last line as JSON (None when
    it is not JSON) and stderr."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"e2e_cli: `{proc.tag}` ran past {timeout} s") from None
    paths = [os.path.join(tmp, f"cli_{proc.tag}.{k}") for k in ("out", "err")]
    seconds = max(os.path.getmtime(f) for f in paths) - proc.t0
    out, err = (open(f).read() for f in paths)
    if rc != 0:
        raise AssertionError(f"e2e_cli: `{proc.tag}` exited {rc}:\n{err[-4000:]}")
    try:
        last = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        last = None
    return {"seconds": seconds, "json": last, "stdout": out, "stderr": err}


def _cli_in_process(*argv: str) -> tuple[int, str, float]:
    """The command line's `main(argv)` in this process with its stdout
    captured; (exit code, stdout, seconds). The port's CLI logging is
    undone after, so later phases see advisories as warnings again."""
    import contextlib
    import io

    from kcmc_tpu_torch.__main__ import main
    from kcmc_tpu_torch.obs.log import reset_cli_logging

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        torch.cuda.synchronize()
    finally:
        reset_cli_logging()
    return rc, buf.getvalue(), time.perf_counter() - t0


def _page_stats(path: str, like: np.ndarray) -> dict:
    """A float32 TIFF's shape, finiteness and largest difference from
    `like` (correct -o's uint16 pages), read in 250-page chunks."""
    from kcmc_tpu_torch.io.tiff import TiffStack

    with TiffStack(path) as ts:
        shape = list(ts.shape)
        finite, gap = True, 0.0
        for lo in range(0, ts.n_frames, 250):
            a = ts.read(lo, lo + 250)
            finite &= bool(np.isfinite(a).all())
            gap = max(gap, float(np.abs(a - like[lo:lo + 250].astype(np.float32)).max()))
    return {"shape": shape, "dtype": str(ts.dtype), "finite": finite, "max_abs_gap": gap}


def phase_e2e_cli(smi: str, tmp: str, file_line: dict, file_transforms: np.ndarray) -> dict:
    """The command line on e2e_file's config-1 TIFF (1000 uint16 frames
    of 512²): `info` in a child process; `correct -o --transforms` in
    this process under the launch counter (launches, output sha256 and
    transforms equal e2e_file's, frames/s printed beside e2e_file's);
    `apply` of its npz and `stabilize --sigma 15` (float32 pages:
    finite, their largest gap to correct -o printed) and `report` of the
    npz, while two children run: `warmup --buckets 512 --compile-cache`
    cold and then warm (stamp_misses 0), `sanitize -- python -m
    kcmc_tpu_torch correct` (exit 0, 0 violations, the static lock-order
    graph merged with a non-empty edge count, transforms equal the
    unsanitized run's) and `check --no-cache --json` (exit 0, no new
    finding; CPU work, its seconds printed). The selftest child runs
    beside them (`phase_selftest`)."""
    from kcmc_tpu_torch.io.tiff import read_stack
    from kcmc_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    src = os.path.join(tmp, "config1.tif")
    out, npz, npz2 = (os.path.join(tmp, f) for f in ("cli_out.tif", "cli.npz", "cli_san.npz"))
    cache = os.path.join(tmp, "cli_cache")
    children = []
    try:
        children.append(_cli_child(tmp, "info", "info", src))  # no torch: light
        cuda_build.reset_launches()
        rc, stdout, seconds = _cli_in_process("correct", src, "-o", out, "--transforms", npz)
        launches = cuda_build.launch_counts()
        summary = json.loads(stdout.strip().splitlines()[-1])
        info = _cli_finish(tmp, children[0])
        # the kernel checks compare bits, so the selftest child runs here,
        # beside the children below, not alone
        children.append(_cli_child(tmp, "selftest", "selftest"))
        selftest = children[-1]
        children.append(_cli_child(tmp, "sanitize", "sanitize", "--", sys.executable, "-m",
                                   "kcmc_tpu_torch", "correct", src, "--transforms", npz2))
        san = children[-1]
        children.append(_cli_child(tmp, "warmup_cold", "warmup", "--buckets", "512",
                                   "--compile-cache", cache))
        cold = children[-1]
        children.append(_cli_child(tmp, "check", "check", "--no-cache", "--json"))
        check = children[-1]
        # in this process meanwhile: apply, stabilize and report
        cuda_build.reset_launches()
        apply_rc, apply_out, apply_s = _cli_in_process(
            "apply", src, npz, "-o", os.path.join(tmp, "cli_apply.tif"),
            "--output-dtype", "float32")
        apply_launches = cuda_build.launch_counts()
        cuda_build.reset_launches()
        stab_rc, stab_out, stab_s = _cli_in_process(
            "stabilize", src, "-o", os.path.join(tmp, "cli_stab.tif"), "--sigma", "15",
            "--output-dtype", "float32")
        stab_launches = cuda_build.launch_counts()
        report_rc, report_out, _ = _cli_in_process("report", npz)
        corrected = read_stack(out)
        pages = {"apply": _page_stats(os.path.join(tmp, "cli_apply.tif"), corrected),
                 "stabilize": _page_stats(os.path.join(tmp, "cli_stab.tif"), corrected)}
        cold_rec = _cli_finish(tmp, cold)
        children.append(_cli_child(tmp, "warmup_warm", "warmup", "--buckets", "512",
                                   "--compile-cache", cache))
        warm_rec = _cli_finish(tmp, children[-1])
        san_rec = _cli_finish(tmp, san)
        check_rec = _cli_finish(tmp, check)
        phase_selftest(smi, tmp, selftest)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    transforms = np.load(npz)["transforms"]
    san_lines = [ln for ln in san_rec["stderr"].splitlines() if ln.startswith("[kcmc sanitize]")]
    static = [int(m.group(1)) for ln in san_lines
              for m in [re.search(r"edges \((\d+) static\)", ln)] if m]
    chk = check_rec["json"] or {}
    n = len(corrected)
    line = {
        "phase": "e2e_cli", "model": "translation", "frames": n,
        "info": info["json"], "info_seconds": info["seconds"],
        "correct": {"exit_code": rc, "seconds": seconds, "frames_per_s": n / seconds,
                    "summary_frames_per_sec": summary["frames_per_sec"],
                    "e2e_file_frames_per_s": file_line["frames_per_s"],
                    "launches_equal_e2e_file": launches == file_line["launches"],
                    "sha256_equal_e2e_file": _sha256(out) == _sha256(
                        os.path.join(tmp, "out.tif")),
                    "transforms_equal_correct_file": bool(
                        np.array_equal(transforms, file_transforms)),
                    "summary_keys": sorted(summary)},
        "apply": {"exit_code": apply_rc, "seconds": apply_s, "pages": pages["apply"],
                  "launches": {k: v for k, v in apply_launches.items() if v},
                  "stdout": json.loads(apply_out)},
        "stabilize": {"exit_code": stab_rc, "seconds": stab_s, "pages": pages["stabilize"],
                      "launches": {k: v for k, v in stab_launches.items() if v},
                      "summary": json.loads(stab_out)},
        "report": {"exit_code": report_rc, "stage_table": "Stages:" in report_out,
                   "bytes": len(report_out)},
        "warmup": {"cold": cold_rec["json"], "cold_seconds": cold_rec["seconds"],
                   "warm": warm_rec["json"], "warm_seconds": warm_rec["seconds"]},
        "sanitize": {"seconds": san_rec["seconds"], "lines": san_lines,
                     "static_edges": static[-1] if static else None,
                     "transforms_equal": bool(np.array_equal(np.load(npz2)["transforms"],
                                                             transforms))},
        "check": {"seconds": check_rec["seconds"], "passes": chk.get("passes"),
                  "findings": chk.get("findings"), "baselined": chk.get("baselined"),
                  "new": chk.get("new"), "stale_baseline": chk.get("stale_baseline"),
                  "ok": chk.get("ok")},
        "seconds": time.perf_counter() - t_phase, "card": smi,
    }
    emit(line)
    c = line["correct"]
    if rc != 0 or not (c["launches_equal_e2e_file"] and c["sha256_equal_e2e_file"]
                       and c["transforms_equal_correct_file"]):
        raise AssertionError(f"e2e_cli: correct differs from e2e_file: {c}, {launches}")
    if info["json"] != {"path": src, "n_frames": n, "frame_shape": [512, 512],
                        "dtype": "uint16", "decoder": "native"}:
        raise AssertionError(f"e2e_cli: info {info['json']}")
    for tag in ("apply", "stabilize"):
        pg = line[tag]["pages"]
        if line[tag]["exit_code"] != 0 or not pg["finite"] or pg["shape"] != [n, 512, 512]:
            raise AssertionError(f"e2e_cli: {tag} {line[tag]}")
    if report_rc != 0 or not line["report"]["stage_table"]:
        raise AssertionError(f"e2e_cli: report\n{report_out[-2000:]}")
    if not (cold_rec["json"] and warm_rec["json"] and warm_rec["json"]["stamp_misses"] == 0
            and warm_rec["json"]["stamp_hits"] == cold_rec["json"]["stamp_misses"]):
        raise AssertionError(f"e2e_cli: warmup {line['warmup']}")
    if not (line["sanitize"]["transforms_equal"]
            and any(ln.endswith(" 0 violation(s)") for ln in san_lines)
            and not any("runtime-only order checking" in ln for ln in san_lines)
            and line["sanitize"]["static_edges"]):
        raise AssertionError(f"e2e_cli: sanitize {line['sanitize']}")
    c = line["check"]
    if not (c["ok"] is True and c["new"] == 0 and c["stale_baseline"] == 0
            and c["passes"] and len(c["passes"]) == 6):
        raise AssertionError(f"e2e_cli: check {c}\n{check_rec['stderr'][-2000:]}")
    total = {k: launches[k] + apply_launches[k] + stab_launches[k] for k in ZERO}
    return {**line, "launches": total}


# e2e_serve: the resident serve plane (queue 1 item 19c). Stream A's 600
# and stream B's 400 frames go out in submits of whole batches but the
# last (uneven sizes), so each stream forms ceil(n / 32) batches: 19 + 13.
SERVE_SUBMITS = {"A": (96, 64, 160, 32, 128, 120), "B": (64, 96, 32, 128, 80)}
# the serve corrector's overrides: a queue deep enough that neither
# stream reaches the degradation watermark (half of it), so every batch
# runs the full budgets the one-shot truth runs
SERVE_KW = dict(serve_queue_depth=2048)


def _serve_drive(port: int, tag: str, frames: np.ndarray, sizes, out: dict) -> None:
    """One client thread: open a registration-only session, submit the
    frames in `sizes`, read every result span, close."""
    from kcmc_tpu_torch.serve.client import ServeClient

    try:
        with ServeClient(port=port) as c:
            sid = c.open_session(tenant=tag, session_id=f"smoke-{tag}")
            lo = 0
            for n in sizes:
                c.submit(sid, frames[lo:lo + n])
                lo += n
            seen = 0
            while seen < len(frames):
                span = c.results(sid, timeout=300.0)
                seen += span["n"]
            out[tag] = c.close_session(sid)
    except BaseException as e:  # re-raised by the phase
        out[tag] = e


def _serve_clients_main(port: int, tmp: str) -> None:
    """The child process of e2e_serve's second drive
    (`python -c "import chip_smoke; chip_smoke._serve_clients_main(PORT,
    TMP)"`): the first drive's two client threads, in a process of
    their own, on the frames the parent saved to TMP/serve_{A,B}.npy.
    Writes TMP/serve_clients.npz (each stream's transforms and
    integers) and TMP/serve_clients.json (seconds from the first open
    to the last close, each stream's frames and robustness)."""
    import threading

    parts = {k: np.load(os.path.join(tmp, f"serve_{k}.npy"), mmap_mode="r") for k in ("A", "B")}
    out: dict = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_serve_drive, args=(port, k, parts[k], SERVE_SUBMITS[k], out))
               for k in ("A", "B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    seconds = time.perf_counter() - t0
    arrays, meta = {}, {"seconds": seconds}
    for k in ("A", "B"):
        got = out.get(k)
        if not isinstance(got, dict):
            meta[k] = {"error": repr(got)}
            continue
        arrays[f"{k}_transforms"] = got["transforms"]
        for d in ("n_keypoints", "n_matches", "n_inliers"):
            arrays[f"{k}_{d}"] = got["diagnostics"][d]
        meta[k] = {"frames": int(got["frames"]), "robustness": got["timing"].get("robustness")}
    np.savez(os.path.join(tmp, "serve_clients.npz"), **arrays)
    with open(os.path.join(tmp, "serve_clients.json"), "w") as f:
        json.dump(meta, f)


def _wire_split(frames: np.ndarray, tmp: str) -> dict:
    """One submit of `frames` through the serve wire's own calls, each
    timed alone on the host: the client's encode (`proto.encode_array`)
    and `proto.send_msg` (json.dumps, UTF-8, the write), the server's
    `proto.recv_msg` (readline of the line, json.loads) and
    `proto.decode_array`. The line goes through a file (the same
    buffered readline a socket's reader runs), so no step waits on
    another."""
    from kcmc_tpu_torch.serve import proto

    path = os.path.join(tmp, "serve_wire.jsonl")
    t = {}
    t0 = time.perf_counter()
    enc = proto.encode_array(frames)
    t["encode_s"] = time.perf_counter() - t0
    with open(path, "wb") as w:
        t0 = time.perf_counter()
        proto.send_msg(w, {"op": "submit_frames", "session": "smoke-W", "frames": enc})
        t["send_s"] = time.perf_counter() - t0
    del enc
    line_bytes = os.path.getsize(path)
    with open(path, "rb") as r:
        t0 = time.perf_counter()
        msg = proto.recv_msg(r)
        t["recv_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = proto.decode_array(msg["frames"])
    t["decode_s"] = time.perf_counter() - t0
    os.remove(path)
    if not np.array_equal(back, frames):
        raise AssertionError("e2e_serve: the wire did not round-trip the frames")
    n = len(frames)
    client, server = t["encode_s"] + t["send_s"], t["recv_s"] + t["decode_s"]
    return {**t, "frames": n, "line_bytes": line_bytes,
            "client_ms_per_frame": 1e3 * client / n, "server_ms_per_frame": 1e3 * server / n,
            "one_process_frames_per_s": n / (client + server),
            "server_only_frames_per_s": n / server}


def _robust_clean(where: str, rb) -> None:
    """A stream of the serve phase ran on the card's kernels alone: no
    retry, no batch on the CPU failover rung, no frame marked failed."""
    if not (isinstance(rb, dict) and rb.get("device_retries") == 0
            and rb.get("backend_failovers") == 0 and rb.get("failed_frames") == 0):
        raise AssertionError(f"e2e_serve: {where} left the card's path: robustness {rb}")


def _download_spy():
    """Count what TorchBackend._start_download copies to the host from
    the scheduler thread (the sessions' batches; the degraded rung's
    warm-up batch runs on a thread of its own): (restore function,
    {"calls", "bytes", "corrected_bytes"})."""
    import threading

    from kcmc_tpu_torch.backends.torch_backend import TorchBackend

    orig = TorchBackend._start_download
    seen = {"calls": 0, "bytes": 0, "corrected_bytes": 0}

    def spy(self, out):
        if threading.current_thread().name == "kcmc-serve-scheduler":
            seen["calls"] += 1
            for k, v in out.items():
                b = v.numel() * v.element_size()
                seen["bytes"] += b
                if k == "corrected":
                    seen["corrected_bytes"] += b
        return orig(self, out)

    TorchBackend._start_download = spy
    return (lambda: setattr(TorchBackend, "_start_download", orig)), seen


def _sched_session(mc, frames: np.ndarray, emit: bool):
    """One session of `frames` through an in-process StreamScheduler on
    `mc` (64-frame submits), launch counters set to 0 just before and
    read after the scheduler stopped (its warm-up threads joined):
    (result, launches, download counts)."""
    from kcmc_tpu_torch.serve.scheduler import StreamScheduler

    sched = StreamScheduler(mc).start()
    restore, seen = _download_spy()
    try:
        torch.cuda.synchronize()
        mc.backend.reset_launch_counts()
        s = sched.open_session(tenant="window", emit_frames=emit)
        for lo in range(0, len(frames), 64):
            sched.submit(s.sid, frames[lo:lo + 64])
        res = sched.close_session(s.sid, timeout=300)
    finally:
        restore()
        sched.stop()
    torch.cuda.synchronize()
    return res, mc.backend.launch_counts(), dict(seen)


def _serve_child(tmp: str, jdir: str, tag: str) -> tuple[subprocess.Popen, dict]:
    """`python -m kcmc_tpu_torch serve` on the card with a journal
    directory; its ready record (stdout's first line)."""
    err = open(os.path.join(tmp, f"serve_{tag}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kcmc_tpu_torch", "serve", "--port", "0",
         "--journal-dir", jdir, "--journal-every", "64", "--queue-depth", "2048"],
        cwd=_ROOT, env=_child_env(), stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    t0 = time.perf_counter()
    line = proc.stdout.readline()
    try:
        ready = json.loads(line)
    except ValueError:
        proc.kill()
        proc.wait()
        raise AssertionError(f"e2e_serve: `serve` child printed no ready record: {line!r}\n"
                             + open(os.path.join(tmp, f"serve_{tag}.err")).read()[-4000:])
    ready["spawn_to_ready_s"] = time.perf_counter() - t0
    return proc, ready


def _serve_finish(proc: subprocess.Popen, sig) -> tuple[int, str]:
    proc.send_signal(sig)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("e2e_serve: the serve child did not stop") from None
    return proc.returncode, out


def phase_e2e_serve(smi: str, tmp: str) -> dict:
    """The resident serve plane on config 1 (translation, K=512, batch
    32, 512², the 1000-frame float32 stack):

    - two ServeClient threads stream 600 and 400 frames (uneven submits
      of whole batches but the last: 19 + 13 batches) through an
      in-process ServeServer on cuda, registration-only; each session's
      transforms equal a correct() of its frames (integers equal,
      transforms within 1e-4 px), launches K1/K2/K3 counted over the
      drive (35/35/65: two references and 32 batches, plus the degraded
      rung's warm-up batch, which `serve_degrade_watermark` < 1 starts
      once per frame shape and which runs no polish, so one K3), the
      bytes downloaded (no corrected frames), the
      aggregate frames/s and `request.total` / `request.dispatch` p50
      and p99 from the metrics verb;
    - the same drive again with the two client threads in a child
      process (`_serve_clients_main`) against a second in-process
      server: the same checks, its frames/s and p50/p99 beside the
      first's; and one 96-frame submit's wire costs timed step by step
      on the host (`_wire_split`);
    - 256 frames through the in-process scheduler as an emitting and as
      a registration-only session: the same launches and transforms,
      the registration-only one downloading 256 x 512² x 4 bytes fewer;
      and the emitting session again at serve_inflight=1, the corrected
      frames' sha256 equal to the default window's (3 batches in flight
      through the pooled pinned downloads); each session K1/K2/K3
      10/10/17 (8 batches, one reference, the degraded warm-up batch);
    - a `python -m kcmc_tpu_torch serve --journal-dir` child on the
      card: its ready line (backend "torch"), the `metrics` CLI against
      it, SIGKILL after 160 frames of a 256-frame stream with a durable
      journal, a second child on the same directory resuming the
      session from its cursor to the uninterrupted transforms, then
      SIGTERM: the `served` record and exit 0.

    Every stream (both drives, the three sessions, the journaled one)
    must have run on the card alone: no retry, no CPU failover, no
    frame marked failed."""
    import signal
    import threading

    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.serve.client import ServeClient
    from kcmc_tpu_torch.serve.server import ServeServer

    t_phase = time.perf_counter()
    stack, _, mc_truth = path_input("translation", 1000)
    parts = {"A": stack[:600], "B": stack[600:]}
    truth = {k: mc_truth.correct(v) for k, v in parts.items()}
    # the in-process server: the same config (the escalation is off in
    # sessions either way)
    mc = path_input("translation", 1000, **SERVE_KW)[2]
    for k in ("A", "B"):
        np.save(os.path.join(tmp, f"serve_{k}.npy"), parts[k])

    def drive(clients: str) -> tuple[dict, dict, dict, dict, float]:
        """Streams A and B through a fresh in-process ServeServer, the
        client threads here ("threads") or in a child ("child"):
        (results per stream, metrics, stats, downloads, seconds), the
        launch counters set to 0 just before and read after the server
        stopped (its degraded warm-up thread joined)."""
        out: dict = {}
        restore, seen = _download_spy()
        try:
            with ServeServer(mc, port=0) as srv:
                torch.cuda.synchronize()
                mc.backend.reset_launch_counts()
                t0 = time.perf_counter()
                if clients == "threads":
                    threads = [threading.Thread(target=_serve_drive, name=f"kcmc-smoke-client-{k}",
                                                args=(srv.port, k, parts[k], SERVE_SUBMITS[k], out))
                               for k in ("A", "B")]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(600)
                else:
                    err = os.path.join(tmp, "serve_clients.err")
                    with open(err, "w") as ef:
                        rc = subprocess.run(
                            [sys.executable, "-c", "import sys, chip_smoke; "
                             "chip_smoke._serve_clients_main(int(sys.argv[1]), sys.argv[2])",
                             str(srv.port), tmp],
                            cwd=_ROOT, env=_child_env(), stdout=ef, stderr=ef,
                            timeout=600).returncode
                    if rc != 0:
                        raise AssertionError(f"e2e_serve: the client child exited {rc}:\n"
                                             + open(err).read()[-4000:])
                    meta = json.load(open(os.path.join(tmp, "serve_clients.json")))
                    arr = np.load(os.path.join(tmp, "serve_clients.npz"))
                    for k in ("A", "B"):
                        if "error" in meta[k]:
                            out[k] = meta[k]["error"]
                            continue
                        out[k] = {"frames": meta[k]["frames"],
                                  "transforms": arr[f"{k}_transforms"],
                                  "diagnostics": {d: arr[f"{k}_{d}"] for d in
                                                  ("n_keypoints", "n_matches", "n_inliers")},
                                  "timing": {"robustness": meta[k]["robustness"]},
                                  "client_seconds": meta["seconds"]}
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                for k in ("A", "B"):
                    if not isinstance(out.get(k), dict):
                        raise AssertionError(f"e2e_serve: stream {k} ({clients}) failed: "
                                             f"{out.get(k)!r}")
                with ServeClient(port=srv.port) as c:
                    metrics, stats = c.metrics(), c.stats()
        finally:
            restore()
        torch.cuda.synchronize()
        return out, metrics, stats, dict(seen), seconds

    def pct(metrics, seg):
        s = metrics["plane"]["totals"].get(seg) or {}
        return {"count": s.get("count"), "p50_ms": 1e3 * (s.get("p50_s") or 0.0),
                "p99_ms": 1e3 * (s.get("p99_s") or 0.0)}

    def streams_of(out):
        return {k: {
            "frames": int(out[k]["frames"]),
            "max_transform_gap_px": float(np.abs(out[k]["transforms"]
                                                 - truth[k].transforms).max()),
            "integers_equal": all(np.array_equal(out[k]["diagnostics"][d],
                                                 truth[k].diagnostics[d])
                                  for d in ("n_keypoints", "n_matches", "n_inliers")),
            "robustness": out[k]["timing"].get("robustness"),
        } for k in ("A", "B")}

    out, metrics, stats, drive_dl, seconds = drive("threads")
    launches = mc.backend.launch_counts()
    streams = streams_of(out)
    out_c, metrics_c, stats_c, drive_dl_c, seconds_c = drive("child")
    launches_c = mc.backend.launch_counts()
    streams_c = streams_of(out_c)
    wire = _wire_split(stack[:96], tmp)
    child_clients = {
        # the rate over the child's drive, from its first open to its
        # last close (seconds_drive adds the child's start)
        "seconds_drive": seconds_c, "client_seconds": out_c["A"]["client_seconds"],
        "frames_per_s": len(stack) / out_c["A"]["client_seconds"], "streams": streams_c,
        "request_total": pct(metrics_c, "request.total"),
        "request_dispatch": pct(metrics_c, "request.dispatch"),
        "downloads_drive": drive_dl_c, "batches": metrics_c["counters"]["batches"],
        "frames_done": stats_c["frames_done"], "launches_drive": launches_c,
    }

    # an emitting and a registration-only session, and the window check
    frames = stack[:256]
    r_emit, l_emit, d_emit = _sched_session(mc, frames, emit=True)
    r_reg, l_reg, d_reg = _sched_session(mc, frames, emit=False)
    mc1 = path_input("translation", 1000, serve_inflight=1, **SERVE_KW)[2]
    r_one, l_one, _ = _sched_session(mc1, frames, emit=True)
    window = {
        "sha256_inflight_3": _digest(r_emit.corrected)[:16],
        "sha256_inflight_1": _digest(r_one.corrected)[:16],
        "equal": _digest(r_emit.corrected) == _digest(r_one.corrected)
        and np.array_equal(r_emit.transforms, r_one.transforms),
    }
    reg_only = {
        "launches_equal": l_emit == l_reg,
        "transforms_equal": bool(np.array_equal(r_emit.transforms, r_reg.transforms)),
        "download_bytes_emit": d_emit["bytes"], "download_bytes_reg": d_reg["bytes"],
        "corrected_bytes_reg": d_reg["corrected_bytes"],
        "missing_bytes": d_emit["bytes"] - d_reg["bytes"],
        "want_missing_bytes": int(frames.size) * 4,
    }
    # the `serve` child: ready line, metrics CLI, SIGKILL, resume, SIGTERM
    jdir = os.path.join(tmp, "serve_journal")
    child = {}
    proc, ready = _serve_child(tmp, jdir, "first")
    try:
        rc, m_out, m_s = _cli_in_process("metrics", f"127.0.0.1:{ready['port']}")
        child["metrics_cli"] = {"rc": rc, "seconds": m_s,
                                "keys": sorted(json.loads(m_out.strip().splitlines()[-1]))}
        with ServeClient(port=ready["port"]) as c:
            sid = c.open_session(tenant="journal", session_id="smoke-J")
            c.submit(sid, frames[:96])
            c.submit(sid, frames[96:160])
            t_w = time.perf_counter()
            while True:
                j = (c.stats().get("journal") or {}).get("smoke-J") or {}
                if j.get("last_saved", -1) >= 128 or time.perf_counter() - t_w > 120:
                    break
                time.sleep(0.05)
            child["journaled_before_kill"] = j.get("last_saved")
    finally:
        proc.kill()
        proc.wait()
    child["first_ready"] = ready
    proc, ready2 = _serve_child(tmp, jdir, "second")
    try:
        with ServeClient(port=ready2["port"]) as c:
            info = c.resume_session_info("smoke-J")
            cursor = int(info["cursor"])
            c.submit("smoke-J", frames[cursor:])
            final = c.close_session("smoke-J")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    rc2, out2 = _serve_finish(proc, signal.SIGTERM)
    served = json.loads(out2.strip().splitlines()[-1])
    child.update({
        "second_ready_s": ready2["spawn_to_ready_s"], "resumed": info.get("resumed"),
        "cursor": cursor, "frames": int(final["frames"]),
        "max_transform_gap_px": float(np.abs(final["transforms"]
                                             - truth["A"].transforms[:256]).max()),
        "sigterm_rc": rc2, "served": served.get("served"),
        "robustness": final["timing"].get("robustness"),
        "served_frames_done": served.get("stats", {}).get("frames_done"),
    })
    # 32 batches and two references, plus the degraded rung's warm-up
    # batch, which runs no polish (transform_polish=0): one K3, not two
    want = {**ZERO, "detect_response": 35, "extract_blended": 35, "warp_translation": 65}
    line = {
        "phase": "e2e_serve", "model": "translation", "frames": len(stack),
        "seconds_drive": seconds, "frames_per_s": len(stack) / seconds,
        "streams": streams, "request_total": pct(metrics, "request.total"),
        "request_dispatch": pct(metrics, "request.dispatch"), "downloads_drive": drive_dl,
        "batches": metrics["counters"]["batches"], "frames_done": stats["frames_done"],
        "child_clients": child_clients, "wire_split": wire,
        "registration_only": reg_only, "window": window, "child": child,
        "launches_drive": launches, "launches_predicted": want,
        "launches_session": {"emit": l_emit, "registration_only": l_reg, "inflight_1": l_one},
        "phase_seconds": time.perf_counter() - t_phase, "card": smi,
    }
    emit(line)
    for tag, got, dl, lines in (("threads", streams, drive_dl, line),
                                ("child", streams_c, drive_dl_c, child_clients)):
        for k, s in got.items():
            if not (s["frames"] == len(parts[k]) and s["integers_equal"]
                    and s["max_transform_gap_px"] <= 1e-4):
                raise AssertionError(f"e2e_serve: stream {k} ({tag}) differs from correct(): {s}")
            _robust_clean(f"stream {k} ({tag})", s["robustness"])
        if dl["corrected_bytes"] or lines["batches"] != 32 or lines["frames_done"] != 1000:
            raise AssertionError(f"e2e_serve: downloads {dl}, batches {lines['batches']}, "
                                 f"frames {lines['frames_done']} ({tag})")
    check_launches("e2e_serve", launches, want)
    check_launches("e2e_serve (client child)", launches_c, want)
    # 8 batches and one reference, plus the degraded warm-up batch
    want_session = {**ZERO, "detect_response": 10, "extract_blended": 10,
                    "warp_translation": 17}
    for tag, got, res in (("emitting", l_emit, r_emit), ("registration-only", l_reg, r_reg),
                          ("serve_inflight=1", l_one, r_one)):
        check_launches(f"e2e_serve ({tag} session)", got, want_session)
        _robust_clean(f"the {tag} session", res.timing.get("robustness"))
    if not (reg_only["launches_equal"] and reg_only["transforms_equal"]
            and reg_only["corrected_bytes_reg"] == 0
            and reg_only["missing_bytes"] == reg_only["want_missing_bytes"]):
        raise AssertionError(f"e2e_serve: registration-only session {reg_only}")
    if not window["equal"]:
        raise AssertionError(f"e2e_serve: serve_inflight=1 differs {window}")
    if not (ready["backend"] == "torch" and child["metrics_cli"]["rc"] == 0
            and child["resumed"] and 0 < cursor < 256 and child["frames"] == 256
            and child["max_transform_gap_px"] <= 1e-4 and rc2 == 0
            and child["served"] is True):
        raise AssertionError(f"e2e_serve: serve child {child}")
    _robust_clean("the journaled session", child["robustness"])
    total = {k: launches[k] + launches_c[k] + l_emit[k] + l_reg[k] + l_one[k] for k in ZERO}
    return {**line, "launches": total}


FLEET_STREAMS = {"F1": (0, 256), "F2": (256, 448)}
FLEET_MOVED = (448, 576)  # the stream whose replica is stopped mid-stream
FLEET_KILLED = (576, 704)  # the CLI child's stream whose replica is SIGKILLed


def _fleet_drive(port: int, sid: str, frames: np.ndarray, out: dict, lo: int = 0,
                 hi: int | None = None, close: bool = True, client=None) -> None:
    """One client of e2e_fleet through a router: open `sid` (unless `lo`
    > 0: it is open) and note the replica the router bound it to in
    out[sid + "/bound"], submit frames[lo:hi] in whole batches, read
    result spans until frame `hi`, each starting where the last ended
    (no frame lost or duplicated across a migration), and close. Errors
    land in out[sid]."""
    from kcmc_tpu_torch.serve.client import ServeClient

    hi = len(frames) if hi is None else hi
    c = client or ServeClient(port=port)
    try:
        if lo == 0:
            c.open_session(tenant=sid, session_id=sid)
            out[sid + "/bound"] = c.stats()["sessions"].get(sid)
        for a in range(lo, hi, 32):
            c.submit(sid, frames[a:min(a + 32, hi)])
        seen = lo
        while seen < hi:
            span = c.results(sid, timeout=300.0)
            if int(span["first_frame"]) != seen:
                raise AssertionError(f"e2e_fleet: {sid} span at {span['first_frame']}, "
                                     f"{seen} expected: a lost or duplicated frame")
            seen += int(span["n"])
        if close:
            out[sid] = c.close_session(sid)
    except BaseException as e:  # re-raised by the phase
        out[sid] = e
    finally:
        if client is None:
            c.close()


def _fleet_journal_done(jdir: str, sid: str, frames: int, timeout: float = 120.0) -> int:
    """Wait until `sid`'s journal under `jdir` holds >= `frames` frames;
    the frames it holds."""
    from kcmc_tpu_torch.serve.journal import journal_path, load_session_journal

    jp = journal_path(jdir, sid)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        got = load_session_journal(jp) if os.path.exists(jp) else None
        if got and int(got[0]["done"]) >= frames:
            return int(got[0]["done"])
        time.sleep(0.05)
    raise AssertionError(f"e2e_fleet: {sid}'s journal never held {frames} frames")


def listening_children(ppid: int) -> dict[int, int]:
    """Listening TCP port -> pid over the child processes of `ppid`,
    from /proc (the socket inodes each child holds): the replicas that
    `router --spawn` started (tests/test_torch_fleet.py uses it too)."""
    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == ppid:
                        kids.append(int(d))
            except (OSError, IndexError, ValueError):
                continue
    inode_port = {}
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            if fields[3] == "0A":  # LISTEN
                inode_port[fields[9]] = int(fields[1].rsplit(":", 1)[1], 16)
    out = {}
    for pid in kids:
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
                if link.startswith("socket:[") and link[8:-1] in inode_port:
                    out[inode_port[link[8:-1]]] = pid
        except OSError:
            continue
    return out


def pid_alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _transitions(texts) -> list[str]:
    """The router's health transitions ("A -> B") among advisory texts."""
    return [t.split("kcmc router: replica ", 1)[1] for t in texts
            if "kcmc router: replica " in t and " -> " in t]


def phase_e2e_fleet(smi: str, tmp: str, serve_line: dict) -> dict:
    """The serve fleet on config 1 (translation, K=512, batch 32, 512²,
    frames of the 1000-frame float32 stack):

    (a) a FleetRouter (the default health config) in front of two
    in-process ServeServers on cuda:0 sharing a journal directory; two
    client threads stream 256 and 192 frames (32-frame submits) under
    session ids that rendezvous placement puts on different replicas
    (asserted), each stream bit-equal to a correct() of its frames
    (integers equal) with no retry, failover or failed frame; the
    router's probe failures, health transitions and migrations over
    the drive (0 expected, a spurious one is reported); then a third
    stream of 128 frames whose replica is stopped once its first 64 are
    done and journaled (stop() journals, then the replica dies): it migrates to the
    survivor and finishes within 1e-4 px of correct(), with one
    `fleet.migrate` span. K1/K2/K3 over (a), read after every server
    stopped: 18 batches, four references (two streams, the moved one
    on each replica) and each server's degraded warm-up batch.
    (b) `python -m kcmc_tpu_torch router --spawn 2` on the card with the
    client here: a 128-frame stream whose replica is SIGKILLed once its
    journal holds 32 frames (the router's buffered frames at the kill
    printed) finishes with no frame lost or duplicated,
    `migration_failures` 0 and the parity of (a); `top --once` on the
    router exits 0; SIGTERM gives the `routed` record and exit 0, and no
    replica process is left.
    Also: the aggregate frames/s of (a)'s drive, and the router's host
    time a frame for one 32-frame submit (its `recv_msg` and
    `send_msg`; it neither decodes nor encodes) beside e2e_serve's
    client and server wire costs."""
    import signal
    import threading
    import warnings

    from kcmc_tpu_torch.config import CorrectorConfig
    from kcmc_tpu_torch.serve.client import ServeClient
    from kcmc_tpu_torch.serve.fleet import Replica, place
    from kcmc_tpu_torch.serve.router import FleetRouter
    from kcmc_tpu_torch.serve.server import ServeServer

    t_phase = time.perf_counter()
    stack, _, mc_truth = path_input("translation", 1000)
    cut = {"F1": FLEET_STREAMS["F1"], "F2": FLEET_STREAMS["F2"], "M": FLEET_MOVED,
           "K": FLEET_KILLED}
    frames = {k: stack[a:b] for k, (a, b) in cut.items()}
    truth = {k: mc_truth.correct(v) for k, v in frames.items()}

    def parity(k, got) -> dict:
        gap = float(np.abs(got["transforms"] - truth[k].transforms).max())
        return {"frames": int(got["frames"]), "max_transform_gap_px": gap,
                "bit_equal": bool(np.array_equal(got["transforms"], truth[k].transforms)),
                "integers_equal": all(np.array_equal(got["diagnostics"][d],
                                                     truth[k].diagnostics[d])
                                      for d in ("n_keypoints", "n_matches", "n_inliers")),
                "robustness": got["timing"].get("robustness")}

    # (a) the in-process fleet
    jdir = os.path.join(tmp, "fleet_journal")
    servers = [ServeServer(path_input("translation", 1000, serve_journal_dir=jdir,
                                      **SERVE_KW)[2], port=0).start() for _ in range(2)]
    reps = [Replica("127.0.0.1", s.port) for s in servers]
    rids = [r.rid for r in reps]
    sids = {k: next(f"fleet-{k}-{i}" for i in range(1000) if place(f"fleet-{k}-{i}", rids)
                    == rids[j]) for j, k in enumerate(("F1", "F2"))}
    sids["M"] = "fleet-M"
    out: dict = {}
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            with FleetRouter(reps, port=0, config=CorrectorConfig(), journal_dir=jdir) as router:
                torch.cuda.synchronize()
                servers[0].scheduler.mc.backend.reset_launch_counts()
                t0 = time.perf_counter()
                threads = [threading.Thread(target=_fleet_drive, name=f"kcmc-smoke-fleet-{k}",
                                            args=(router.port, sids[k], frames[k], out))
                           for k in ("F1", "F2")]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
                seconds = time.perf_counter() - t0
                drive_stats = router.stats()
                for k in ("F1", "F2"):
                    if not isinstance(out.get(sids[k]), dict):
                        raise AssertionError(f"e2e_fleet: stream {k} failed: {out.get(sids[k])!r}")
                # the graceful migration: stop the moved stream's replica
                # once its first 64 frames are done and journaled (the
                # first snapshot is the first batch; stop() journals the
                # rest)
                with ServeClient(port=router.port) as c:
                    _fleet_drive(router.port, sids["M"], frames["M"], out, hi=64, close=False,
                                 client=c)
                    journaled = _fleet_journal_done(jdir, sids["M"], 32)
                    victim = router.stats()["sessions"][sids["M"]]
                    t_stop = time.perf_counter()
                    servers[rids.index(victim)].stop()
                    _fleet_drive(router.port, sids["M"], frames["M"], out, lo=64, client=c)
                    moved_s = time.perf_counter() - t_stop
                if not isinstance(out.get(sids["M"]), dict):
                    raise AssertionError(f"e2e_fleet: the moved stream failed: "
                                         f"{out.get(sids['M'])!r}")
                fleet_stats = router.stats()
                migrate = router.fleet_metrics()["plane"]["totals"].get("fleet.migrate") or {}
    finally:
        for s in servers:
            s.stop()
    torch.cuda.synchronize()
    launches = servers[0].scheduler.mc.backend.launch_counts()
    texts = [str(w.message) for w in rec]
    batches = sum(b - a for a, b in cut.values() if (a, b) != FLEET_KILLED) // 32
    refs = 4
    want = {**ZERO, "detect_response": batches + refs + 2, "extract_blended": batches + refs + 2,
            "warp_translation": 2 * batches + 2}
    streams = {k: parity(k, out[sids[k]]) for k in ("F1", "F2", "M")}
    wire = _wire_split(stack[:32], tmp)
    router_wire = {"frames": 32, "recv_s": wire["recv_s"], "send_s": wire["send_s"],
                   "router_ms_per_frame": 1e3 * (wire["recv_s"] + wire["send_s"]) / 32,
                   "client_ms_per_frame": wire["client_ms_per_frame"],
                   "server_ms_per_frame": wire["server_ms_per_frame"]}
    router_wire["e2e_serve_wire_split"] = {
        k: serve_line["wire_split"][k] for k in ("frames", "client_ms_per_frame",
                                                 "server_ms_per_frame")}
    inproc = {
        "sessions": {k: sids[k] for k in ("F1", "F2")},
        "bound": {k: out.get(sids[k] + "/bound") for k in ("F1", "F2")},
        "placed": {k: rids[j] for j, k in enumerate(("F1", "F2"))},
        "seconds_drive": seconds, "frames_per_s": 448 / seconds,
        "probes": drive_stats["probes"], "probe_failures": drive_stats["probe_failures"],
        "migrations_total_drive": drive_stats["migrations_total"],
        "transitions": _transitions(texts),
        "moved": {"journaled_at_stop": journaled, "from": victim,
                  "migrations": fleet_stats["migrations"], "fleet_migrate_spans":
                  migrate.get("count"), "seconds_after_stop": moved_s},
        "probe_failures_total": fleet_stats["probe_failures"],
        "migrations_total": fleet_stats["migrations_total"],
        "migration_failures": fleet_stats["migration_failures"],
    }

    # (b) the CLI child: router --spawn 2 on the card
    jdir_b = os.path.join(tmp, "fleet_cli_journal")
    err_path = os.path.join(tmp, "fleet_router.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kcmc_tpu_torch", "router", "--port", "0", "--spawn", "2",
             "--journal-dir", jdir_b, "--serve-args", "--journal-every 32 --queue-depth 2048"],
            cwd=_ROOT, env=_child_env(), stdout=subprocess.PIPE, stderr=err, text=True)
    kids: dict = {}
    cli: dict = {}
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        try:
            ready = json.loads(line)
        except ValueError:
            raise AssertionError(f"e2e_fleet: `router` printed no ready record: {line!r}\n"
                                 + open(err_path).read()[-4000:]) from None
        cli["spawn_to_ready_s"] = time.perf_counter() - t0
        cli["replicas"] = ready["replicas"]
        kids = {p: pid for p, pid in listening_children(proc.pid).items()
                if f"127.0.0.1:{p}" in ready["replicas"]}
        sid = "fleet-K"
        with ServeClient(port=ready["port"]) as c:
            _fleet_drive(ready["port"], sid, frames["K"], out, hi=64, close=False, client=c)
            cli["journaled_at_kill"] = _fleet_journal_done(jdir_b, sid, 32)
            st = c.stats()
            victim_b = st["sessions"][sid]
            cli["buffered_frames_at_kill"] = st["buffered_frames"].get(sid, 0)
            os.kill(kids[int(victim_b.rsplit(":", 1)[1])], signal.SIGKILL)
            t_kill = time.perf_counter()
            _fleet_drive(ready["port"], sid, frames["K"], out, lo=64, client=c)
            cli["seconds_after_kill"] = time.perf_counter() - t_kill
            if not isinstance(out.get(sid), dict):
                raise AssertionError(f"e2e_fleet: the killed replica's stream failed: "
                                     f"{out.get(sid)!r}")
            st = c.stats()
        cli.update({"migrations_total": st["migrations_total"],
                    "migration_failures": st["migration_failures"],
                    "probe_failures": st["probe_failures"], "from": victim_b,
                    "migrations": st["migrations"]})
        streams["K"] = parity("K", out[sid])
        rc_top, top_out, top_s = _cli_in_process("top", "--once", f"127.0.0.1:{ready['port']}")
        cli["top"] = {"rc": rc_top, "seconds": top_s,
                      "fleet_line": next((ln for ln in top_out.splitlines()
                                          if ln.startswith("fleet:")), None)}
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        cli["sigterm_rc"] = proc.returncode
        routed = json.loads(rest.strip().splitlines()[-1])
        cli["routed"] = routed.get("routed")
        cli["routed_sessions"] = routed.get("stats", {}).get("sessions_routed")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        left = [pid for pid in kids.values() if pid_alive(pid)]
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    cli["replicas_left"] = left
    cli["transitions"] = _transitions(open(err_path).read().splitlines())
    line = {
        "phase": "e2e_fleet", "model": "translation", "in_process": inproc, "cli": cli,
        "streams": streams, "router_wire": router_wire, "launches_drive": launches,
        "launches_predicted": want, "phase_seconds": time.perf_counter() - t_phase, "card": smi,
    }
    emit(line)
    if inproc["bound"] != inproc["placed"]:
        raise AssertionError(f"e2e_fleet: the streams were bound to {inproc['bound']}, "
                             f"placed on {inproc['placed']}")
    for k in ("F1", "F2"):
        s = streams[k]
        if not (s["frames"] == len(frames[k]) and s["bit_equal"] and s["integers_equal"]):
            raise AssertionError(f"e2e_fleet: stream {k} differs from correct(): {s}")
    for k in ("M", "K"):
        s = streams[k]
        if not (s["frames"] == len(frames[k]) and s["max_transform_gap_px"] <= 1e-4):
            raise AssertionError(f"e2e_fleet: migrated stream {k} differs from correct(): {s}")
    for k, s in streams.items():
        _robust_clean(f"e2e_fleet stream {k}", s["robustness"])
    if inproc["migrations_total_drive"] == 0:
        check_launches("e2e_fleet", launches, want)
    elif any(launches[k] < v for k, v in want.items()):
        # a spurious migration in the drive re-runs a reference and the
        # batches past its cursor: at least the prediction
        raise AssertionError(f"e2e_fleet: launches {launches} below {want}")
    if not (inproc["migrations_total"] == inproc["migrations_total_drive"] + 1
            and inproc["moved"]["fleet_migrate_spans"] == inproc["migrations_total"]
            and inproc["migration_failures"] == 0):
        raise AssertionError(f"e2e_fleet: the graceful migration {inproc}")
    if not (len(cli["replicas"]) == 2 and cli["migrations_total"] >= 1
            and cli["migration_failures"] == 0 and cli["top"]["rc"] == 0
            and cli["sigterm_rc"] == 0 and cli["routed"] is True
            and cli["routed_sessions"] == 1 and not left and len(kids) == 2):
        raise AssertionError(f"e2e_fleet: router child {cli}")
    return {**line, "launches": launches}


# A shard's transforms against the one-device run's. Translation holds
# the reference's 1e-4 px. Homography's consensus on the card depends on
# the batch it runs in (16-frame halves against the 32-frame batch: equal
# inliers, transforms 5.3e-4 px apart, detect, describe, warp and polish
# bit-equal); it is held at the homography float32 bound of
# tests/test_torch_homography.py::test_homography_consensus_identical_inliers.
MESH_GAP_PX = {"translation": 1e-4, "homography": 2e-3}


def _mesh_gap(res, one) -> dict:
    """A mesh run against the single-device run of the same stack."""
    ints = {k: bool(np.array_equal(res.diagnostics[k], one.diagnostics[k]))
            for k in ("n_keypoints", "n_matches", "n_inliers", "warp_ok")}
    return {"max_transform_gap_px": float(np.abs(res.transforms - one.transforms).max()),
            "max_frame_gap": float(np.abs(res.corrected - one.corrected).max()),
            "integers_equal": ints}


def phase_e2e_mesh(smi: str) -> dict:
    """The frame-axis mesh on the card: config 1 (1000 frames) through
    mesh_devices=1 and through an explicit two-shard mesh on cuda:0 (the
    split, the pad and the gather on the card; collective_chunks 0 and
    2), config 4 (homography: K1, K6, K7; 1000 frames) through the
    two-shard mesh, each against its single-device run: integer outputs
    equal, transforms within MESH_GAP_PX; a one-rank NCCL process group
    (initialize_multihost), its all-gather and ring, and a sharded batch
    under it; mesh_devices beyond the visible cards raises."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.parallel import initialize_multihost, make_mesh, mesh_size
    from kcmc_tpu_torch.parallel import sharded as tsharded
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    two = (torch.device("cuda", 0),) * 2
    runs = {}
    for model, cases in (("translation", (("mesh_devices_1", {"mesh_devices": 1}),
                                          ("two_shards", {"mesh": two}),
                                          ("two_shards_ring2", {"mesh": two,
                                                                "collective_chunks": 2}))),
                         ("homography", (("two_shards", {"mesh": two}),))):
        stack, gt, mc = path_input(model, 1000)
        one, one_s, one_l, _ = counted_run(mc, stack)
        runs[f"{model}:single"] = {"frames_per_s": len(stack) / one_s, "launches": one_l}
        for tag, kw in cases:
            mc = path_input(model, 1000, **kw)[2]
            res, seconds, launches, _ = counted_run(mc, stack)
            n_shards = len(mc.backend.mesh)
            want = {k: (1 + n_shards * (v - 1) if k in ("detect_response", "extract_blended",
                                                        "extract_blended_moments")
                        else n_shards * v) if v else 0
                    for k, v in WANT_LAUNCHES[model].items()}
            check_launches(f"e2e_mesh:{model}:{tag}", launches, want)
            gap = _mesh_gap(res, one)
            err = _rmse(res, relative_transforms(gt), stack.shape[1:])
            runs[f"{model}:{tag}"] = {
                "shards": n_shards, "frames_per_s": len(stack) / seconds, "rmse_px": err,
                "launches": launches, **gap,
                "robustness": check_robust_clean(f"e2e_mesh:{model}:{tag}", res),
                "warp_rescued": int(np.sum(res.diagnostics.get("warp_rescued", 0))),
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
            if (gap["max_transform_gap_px"] > MESH_GAP_PX[model]
                    or not all(gap["integers_equal"].values())):
                raise AssertionError(f"e2e_mesh {model} {tag}: {runs[f'{model}:{tag}']}")
    try:
        MotionCorrector(mesh_devices=torch.cuda.device_count() + 1)
        raised = None
    except ValueError as e:
        raised = str(e)
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0, timeout_s=120)
    try:
        x = torch.arange(512 * 2, dtype=torch.float32, device="cuda").reshape(512, 2)
        gathered = {c: bool(torch.equal(tsharded._process_all_gather(x, c), x)) for c in (0, 2)}
        mesh = make_mesh()
        stack, gt, mc = path_input("translation", 32, mesh=mesh)
        res = mc.correct(stack)
        nccl = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                "mesh": [str(d) for d in mesh], "mesh_size": mesh_size(mesh),
                "all_gather_equal": gathered,
                "rmse_px": _rmse(res, relative_transforms(gt), stack.shape[1:])}
    finally:
        dist.destroy_process_group()
    line = {"phase": "e2e_mesh", "runs": runs, "nccl_one_rank": nccl,
            "oversubscribed_mesh_raises": raised, "card": smi}
    emit(line)
    if raised is None or not all(gathered.values()):
        raise AssertionError(f"e2e_mesh: {line}")
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in ZERO}
    return {**line, "launches": total}


def phase_link(smi: str, frames: int = 256) -> dict:
    """The host-to-card copy rate of a 512x512 float32 stack of `frames`
    frames, from pageable and from pinned host memory (CUDA events
    around each copy; median of five), beside the roofline's `link`
    row (PCIe Gen5 x16's spec figure)."""
    from kcmc_tpu_torch.analysis.roofline import PEAKS, detect_platform

    host = torch.from_numpy(np.random.default_rng(0).random((frames, 512, 512), np.float32))
    n_bytes = host.numel() * 4
    dev = torch.empty(host.shape, dtype=host.dtype, device=CARD)

    def gbs(src) -> float:
        for _ in range(2):
            dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            dev.copy_(src, non_blocking=True)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        return n_bytes / (float(np.median(ms)) * 1e-3) / 1e9

    pageable = gbs(host)
    pinned = gbs(host.pin_memory())
    line = {"phase": "link", "bytes": n_bytes, "h2d_pageable_gbs": pageable,
            "h2d_pinned_gbs": pinned,
            "link_spec_gbs": PEAKS[detect_platform()]["link"] / 1e9, "card": smi}
    emit(line)
    return line


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
    if model == "translation":
        # the pipelined dispatch through correct(): the copies' device
        # time and the idle share with the upload overlap on and off
        off = path_input(model, n, upload_overlap=False)[2]
        emit({"phase": "profile_dispatch", "model": model, "batch": B, "card": smi,
              "overlap": dispatch_profile(mc, stack), "serial": dispatch_profile(off, stack)})
    if model in ("piecewise", "rigid3d"):
        return  # stage_breakdown covers the 2D matrix models
    from kcmc_tpu_torch.analysis.roofline import achieved_rates, detect_platform
    from kcmc_tpu_torch.utils.profiling import stage_breakdown

    cfg = mc.config
    over = {k: getattr(cfg, k) for k in ("max_keypoints", "nms_size", "harris_window_sigma",
                                         "cand_tile", "n_octaves")}
    scene = ({"n_blobs": CFG2_SCENE["n_blobs"], "sigma_range": CFG2_SCENE["sigma_range"]}
             if model == "affine" else {})
    rows = stage_breakdown(cfg.model, shape=stack.shape[1:], batch_size=B, iters=10,
                           device=CARD, **scene, **over)
    costs = run_costs(cfg, B, stack.shape[1:])
    emit({
        "phase": "profile_stages", "model": model, "batch": B, "card": smi,
        "timing": "honest_time (CUDA events), cumulative prefixes of the batch program",
        "stage_breakdown": rows,
        "achieved_rates": achieved_rates(costs, {k: v["incremental_ms"] / 1e3
                                                 for k, v in rows.items() if isinstance(v, dict)}),
        "platform": detect_platform(),
    })


def main() -> int:
    # outside a checkout this fails before anything is printed
    import kcmc_tpu_torch  # noqa: F401

    name, smi = phase_device()
    phase_build()
    phase_link(smi)
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
    # the options of correct() and apply_correction (queue 1 item 15a)
    by_path["e2e_templates"], config1_transforms = phase_e2e_templates(smi)
    by_path["e2e_warm_start"] = phase_e2e_warm_start(smi)
    by_path.update(phase_e2e_float32(smi))
    by_path["e2e_sanitize"] = phase_e2e_sanitize(smi)
    by_path["e2e_chunked_device"], affine = phase_e2e_chunked_device(smi)
    by_path["e2e_apply"] = phase_e2e_apply(smi, affine, config1_transforms)
    # files and resume (queue 1 item 15b), in a directory removed after
    import tempfile

    with tempfile.TemporaryDirectory(prefix="kcmc_smoke_") as tmp:
        by_path["e2e_file"], file_transforms = phase_e2e_file(smi, tmp)
        by_path["e2e_file_twopass"] = phase_e2e_file_twopass(smi, tmp)
        by_path["e2e_file_faults"] = phase_e2e_file_faults(smi, tmp)
        # the backend registry's NumPy oracle and ResumableCorrector (the
        # backend plugin seam); their own lines, outside the kernels' totals
        phase_e2e_numpy(smi)
        phase_e2e_resumable(smi, tmp)
        # object-store ingest and egress (queue 1 item 15c)
        by_path["e2e_object"] = phase_e2e_object(smi, tmp)
        # execution plans (queue 1 item 16)
        by_path["e2e_plans"] = phase_e2e_plans(smi, tmp)
        # the pipelined dispatch (queue 1 item 23), after e2e_file's TIFFs
        by_path["e2e_overlap"] = phase_e2e_overlap(smi, tmp)
        # the one-shot run's observability (queue 1 item 19a)
        by_path["e2e_obs"] = phase_e2e_obs(smi, tmp)
        # the command line and the runtime sanitizer (queue 1 item 19b)
        by_path["e2e_cli"] = phase_e2e_cli(smi, tmp, by_path["e2e_file"], file_transforms)
        # the resident serve plane (queue 1 item 19c)
        by_path["e2e_serve"] = phase_e2e_serve(smi, tmp)
        # the serve fleet (queue 1 item 19d)
        by_path["e2e_fleet"] = phase_e2e_fleet(smi, tmp, by_path["e2e_serve"])
    # the frame-axis mesh (queue 1 item 17)
    by_path["e2e_mesh"] = phase_e2e_mesh(smi)
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
