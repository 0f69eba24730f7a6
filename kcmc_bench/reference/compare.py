"""The comparison that decides `correct`.

For a sample of frames drawn from the seed, the reference works the
registration out again from the generated stack (`oracle.register`:
reference frame, keypoints, matches, consensus or field, gather warp
and polish) and the numbers compared are:

* `transform_gap_px` (matrix models): the widest RMS gap on the 9x9
  control grid, over the sampled frames and every call of the window,
  between the program's transform and the reference's;
* `field_gap_px` (piecewise): the widest, over the same samples, of
  each frame's median over the grid's patches of the patch's endpoint
  gap between the program's field and the reference's. The median over
  patches, not their RMS: the program and the reference draw their
  per-patch RANSAC hypotheses from different streams, and a patch with
  few matches can settle on another fit a few tenths of a pixel away
  (PERF.md: one patch at 0.388 px on one seed of twelve, its
  neighbours under 0.05). The widest over frames, so that a fault on
  any one sampled frame shows;
* `frame_gap`: the widest gap between the program's corrected frame and
  the warp the program says it applied (K7's or K8's function for frames
  it kept on its bounded warp, the exact gather for rescued frames and
  for batches after the escalation), of the input frame by the
  program's own transform or field, as a share of that warp's largest
  value. It follows the program from its own transforms: the
  transform gap checks the transforms themselves.

`lowp=True` runs the control in the program's place: the reference
computed in bfloat16 (`oracle`), judged by the same numbers. Imports
numpy, torch and the benchmark's own modules; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from kcmc_bench.reference import errors, oracle, warps


def sample_frames(seed: int, n_frames: int, k: int) -> np.ndarray:
    """`k` frame indices in [1, n_frames), drawn from the seed (frame 0
    is the reference frame itself)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x6B636D63])
    return np.sort(rng.choice(np.arange(1, n_frames), size=min(k, n_frames - 1), replace=False))


def route(frame_index: int, rescued: bool, escalated_at) -> str:
    """Which warp produced a frame: "bounded" (K7 or K8) or "gather"."""
    if rescued or (escalated_at is not None and frame_index >= escalated_at):
        return "gather"
    return "bounded"


def applied_warp(frame: np.ndarray, motion: np.ndarray, settings, how: str) -> np.ndarray:
    """The input frame warped by a transform (3, 3) or field (gh, gw, 2)
    as the program's route `how` does it, on the CPU."""
    fr = torch.as_tensor(np.asarray(frame, np.float32))[None]
    mo = torch.as_tensor(np.asarray(motion, np.float32))[None]
    if settings.model == "piecewise":
        if how == "bounded":
            return warps.warp_field(fr, mo, settings.max_flow_px)[0][0].numpy()
        return warps.warp_flow(fr, mo)[0].numpy()
    if how == "bounded":
        mpx = warps.matrix_resid_px(settings, tuple(frame.shape))
        return warps.warp_matrix(fr, mo, mpx)[0][0].numpy()
    return warps.warp_gather(fr, mo)[0].numpy()


def frame_gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| as a share of max |want|."""
    scale = max(float(np.max(np.abs(want))), 1e-12)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))) / scale


def motion_gap(settings, got: np.ndarray, want: np.ndarray, shape) -> float:
    """Gap (px) of one transform (RMS on the control grid) or one field
    (median endpoint gap over its patches)."""
    if settings.model == "piecewise":
        return errors.field_median_gap(got, want)
    return errors.transform_rmse(np.asarray(got)[None], np.asarray(want)[None], shape)


def reference_runs(stack: np.ndarray, frames: np.ndarray, settings, lowp: bool = False) -> dict:
    """{frame index: oracle.register output} of the sampled frames, with
    frame 0 of the stack as the reference frame."""
    ref = oracle.prepare_reference(stack[0], settings, lowp)
    return {int(i): oracle.register(stack[i], int(i), ref, settings, lowp) for i in frames}


def judge(stack: np.ndarray, samples: list[dict], reference: dict, settings) -> dict:
    """The two gap numbers over `samples`: one dict per call of the
    window, {"motion": {i: transform or field}, "corrected": {i: frame},
    "route": {i: "bounded" | "gather"}}, against `reference` (from
    `reference_runs`)."""
    key = "field" if settings.model == "piecewise" else "transform"
    shape = tuple(stack.shape[1:])
    mgaps, fgap = [], 0.0
    for call in samples:
        for i, motion in call["motion"].items():
            mgaps.append(motion_gap(settings, motion, reference[i][key], shape))
            want = applied_warp(stack[i], motion, settings, call["route"][i])
            fgap = max(fgap, frame_gap(call["corrected"][i], want))
    return {f"{key}_gap_px": max(mgaps), "frame_gap": fgap}


def control_samples(stack: np.ndarray, frames: np.ndarray, settings) -> list[dict]:
    """The control's outputs, shaped as one call of the window: the
    reference computed in bfloat16, put in the program's place (its
    frames come from the gather warp)."""
    low = reference_runs(stack, frames, settings, lowp=True)
    key = "field" if settings.model == "piecewise" else "transform"
    return [{"motion": {i: r[key] for i, r in low.items()},
             "corrected": {i: r["corrected"] for i, r in low.items()},
             "route": {i: "gather" for i in low}}]
