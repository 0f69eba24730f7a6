"""kcmc_tpu_torch — the PyTorch/CUDA port of kcmc_tpu.

Keypoint-consensus motion correction on an NVIDIA H100: detect,
describe, Hamming 2-NN match, RANSAC consensus, bilinear warp and
photometric polish, with the JAX package's Pallas kernels rewritten as
hand-written CUDA kernels for Hopper (`csrc/`). It covers translation,
rigid, similarity, affine, homography and piecewise (T, H, W) stacks,
single-scale or through the scale pyramid (`n_octaves`), and rigid3d
(T, D, H, W) z-stacks, in memory or streamed from files or
object-store buckets with checkpoints and the robustness ladder.
`python -m kcmc_tpu_torch.selftest` holds every kernel against its plain
version on the card. Imports torch and numpy only.

    from kcmc_tpu_torch import MotionCorrector
    res = MotionCorrector(model="translation").correct(stack)  # on the card
    res = MotionCorrector(device="cpu").correct(stack)  # plain versions
    res = MotionCorrector(backend="numpy").correct(stack)  # the NumPy oracle
    res = MotionCorrector(model="similarity", n_octaves=3).correct(stack)
    res = MotionCorrector(model="rigid3d", batch_size=8).correct(volumes)
    other = apply_correction(channel2, res.transforms)  # same motion
    res = MotionCorrector().correct_file("in.tif", output="out.tif",
                                         checkpoint="run.ckpt.npz")
    mc = MotionCorrector(plan_buckets=(256, 512), compile_cache_dir="cache")
    mc.warmup()  # shape buckets, warm programs, kernels kept in "cache"
"""

__version__ = "0.1.0"

__all__ = [
    "CorrectionResult",
    "CorrectorConfig",
    "MotionCorrector",
    "apply_correction",
    "apply_correction_file",
    "common_valid_region",
    "config_from_dict",
]

# Every lazy root name (the reference's, kcmc_tpu/__init__.py:22-97, and
# `config_from_dict`) by the port submodule that defines it.
_LAZY = {
    **dict.fromkeys(("available_backends", "get_backend", "register_backend"),
                    "kcmc_tpu_torch.backends"),
    **dict.fromkeys(("CorrectorConfig", "config_from_dict"), "kcmc_tpu_torch.config"),
    **dict.fromkeys(("CorrectionResult", "MotionCorrector", "apply_correction",
                     "apply_correction_file", "common_valid_region"),
                    "kcmc_tpu_torch.corrector"),
    **dict.fromkeys(("MODELS", "TransformModel", "apply_transform", "get_model"),
                    "kcmc_tpu_torch.models"),
    **dict.fromkeys(("smooth_trajectory", "interpolate_failed"),
                    "kcmc_tpu_torch.utils.trajectory"),
    **dict.fromkeys(("FaultPlan", "RetryPolicy", "classify_transient"),
                    "kcmc_tpu_torch.utils.faults"),
    "RobustnessReport": "kcmc_tpu_torch.utils.metrics",
    **dict.fromkeys(("Tracer", "FrameRecordStream", "Heartbeat", "build_manifest"),
                    "kcmc_tpu_torch.obs"),
    **dict.fromkeys(("Session", "StreamScheduler", "ServeServer", "ServeClient"),
                    "kcmc_tpu_torch.serve"),
}


def __getattr__(name):
    # Lazy package init (PEP 562): the decode-pool workers of
    # io/feeder.py spawn fresh interpreters whose only imports are
    # `kcmc_tpu_torch.io` and numpy; an eager torch import here would
    # tax every worker spawn by seconds.
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
