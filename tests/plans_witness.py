"""Polish-off parity of bucket routing at config 1's 500x496 crop, on the
CPU, in both packages (a measurement script beside the tests, not
collected by pytest).

Config 1's scene (`make_drift_stack(1000, (512, 512), "translation",
seed=0)`) is cropped to 500x496, and its first `--batches` batches of 32
frames are corrected with `transform_polish=0` four times: by the JAX
package (`backend="jax"`) and by the PyTorch port (`device="cpu"`), each
unbucketed and through `plan_buckets=(256, 512)` (every batch padded to
the 512 bucket). For each pair it prints one JSON line: the frames whose
keypoint, match and inlier counts differ, the frames with equal
transforms, and the largest displacement between the two runs'
transforms at the frame corners. The pairs are each package's bucketed
run against its unbucketed run, and the port's runs against the JAX
package's on the same route.

The describe stage subtracts each frame's finite mean, taken over the
whole canvas (pad zeros included in a bucketed run), before the bf16
quantization of the patch pixels, so bucketed and unbucketed descriptor
words may differ in a few bits; this script measures how far that moves
the registration at full frame size.

    JAX_PLATFORMS=cpu python tests/plans_witness.py --batches 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CROP = (500, 496)
BUCKETS = (256, 512)
BATCH = 32


def corner_gap(a: np.ndarray, b: np.ndarray, shape) -> np.ndarray:
    """Per-frame largest displacement (px) between two (T, 3, 3) maps at
    the frame's four corners."""
    h, w = shape
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T
    pa, pb = a.astype(np.float64) @ c, b.astype(np.float64) @ c
    pa, pb = pa[:, :2] / pa[:, 2:], pb[:, :2] / pb[:, 2:]
    return np.abs(pa - pb).max(axis=(1, 2))


def compare(name: str, a, b, ta, tb) -> dict:
    gap = corner_gap(np.asarray(a.transforms), np.asarray(b.transforms), CROP)
    rec = {
        "pair": name,
        "frames": len(gap),
        "frames_differing": {k: int((np.asarray(a.diagnostics[k])
                                     != np.asarray(b.diagnostics[k])).sum())
                             for k in ("n_keypoints", "n_matches", "n_inliers")},
        "frames_equal_transforms": int(np.all(np.asarray(a.transforms)
                                              == np.asarray(b.transforms), axis=(1, 2)).sum()),
        "max_corner_gap_px": float(gap.max()),
        "frames_within_1e-3_px": int((gap <= 1e-3).sum()),
        "seconds": [round(ta, 1), round(tb, 1)],
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    import kcmc_tpu
    import kcmc_tpu_torch
    from kcmc_tpu.utils.synthetic import make_drift_stack

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    n = BATCH * args.batches
    data = make_drift_stack(n_frames=1000, shape=(512, 512), model="translation", seed=0)
    crop = np.ascontiguousarray(data.stack[:n, :CROP[0], :CROP[1]])
    del data
    common = dict(model="translation", transform_polish=0, rescue_escalate=False,
                  batch_size=BATCH)

    def run(pkg, buckets, **kw):
        mc = pkg.MotionCorrector(plan_buckets=buckets, **common, **kw)
        t0 = time.perf_counter()
        res = mc.correct(crop)
        return res, time.perf_counter() - t0

    ref_u, tru = run(kcmc_tpu, (), backend="jax")
    ref_b, trb = run(kcmc_tpu, BUCKETS, backend="jax")
    assert ref_b.timing["plan_cache"]["bucket_padded"] == args.batches
    port_u, tpu_ = run(kcmc_tpu_torch, (), device="cpu")
    port_b, tpb = run(kcmc_tpu_torch, BUCKETS, device="cpu")
    assert port_b.timing["plan_cache"]["bucket_padded"] == args.batches
    compare("reference bucketed vs unbucketed", ref_b, ref_u, trb, tru)
    compare("port bucketed vs unbucketed", port_b, port_u, tpb, tpu_)
    compare("port vs reference, unbucketed", port_u, ref_u, tpu_, tru)
    compare("port vs reference, bucketed", port_b, ref_b, tpb, trb)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
