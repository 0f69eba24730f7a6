"""kcmc_tpu_torch — the PyTorch/CUDA port of kcmc_tpu.

Keypoint-consensus motion correction on an NVIDIA H100: detect,
describe, Hamming 2-NN match, RANSAC consensus, bilinear warp and
photometric polish, with the JAX package's Pallas kernels rewritten as
hand-written CUDA kernels for Hopper (`csrc/`). It covers translation,
rigid, similarity, affine, homography and piecewise (T, H, W) stacks,
single-scale or through the scale pyramid (`n_octaves`), and rigid3d
(T, D, H, W) z-stacks, in memory or streamed from files with
checkpoints and the robustness ladder. Imports torch and numpy only.

    from kcmc_tpu_torch import MotionCorrector
    res = MotionCorrector(model="translation").correct(stack)  # on the card
    res = MotionCorrector(device="cpu").correct(stack)  # plain versions
    res = MotionCorrector(model="similarity", n_octaves=3).correct(stack)
    res = MotionCorrector(model="rigid3d", batch_size=8).correct(volumes)
    other = apply_correction(channel2, res.transforms)  # same motion
    res = MotionCorrector().correct_file("in.tif", output="out.tif",
                                         checkpoint="run.ckpt.npz")
"""

__all__ = [
    "CorrectionResult",
    "CorrectorConfig",
    "MotionCorrector",
    "apply_correction",
    "apply_correction_file",
    "common_valid_region",
    "config_from_dict",
]


def __getattr__(name):
    # Lazy package init (PEP 562): the decode-pool workers of
    # io/feeder.py spawn fresh interpreters whose only imports are
    # `kcmc_tpu_torch.io` and numpy; an eager torch import here would
    # tax every worker spawn by seconds.
    if name in ("CorrectorConfig", "config_from_dict"):
        from kcmc_tpu_torch import config

        return getattr(config, name)
    if name in __all__:
        from kcmc_tpu_torch import corrector

        return getattr(corrector, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
