"""kcmc_tpu_torch — the PyTorch/CUDA port of kcmc_tpu.

Keypoint-consensus motion correction on an NVIDIA H100: detect,
describe, Hamming 2-NN match, RANSAC consensus, bilinear warp and
photometric polish, with the JAX package's Pallas kernels rewritten as
hand-written CUDA kernels for Hopper (`csrc/`). It covers translation,
rigid, similarity, affine, homography and piecewise (T, H, W) stacks,
single-scale or through the scale pyramid (`n_octaves`), and rigid3d
(T, D, H, W) z-stacks. Imports torch and numpy only.

    from kcmc_tpu_torch import MotionCorrector
    res = MotionCorrector(model="translation").correct(stack)  # on the card
    res = MotionCorrector(device="cpu").correct(stack)  # plain versions
    res = MotionCorrector(model="similarity", n_octaves=3).correct(stack)
    res = MotionCorrector(model="rigid3d", batch_size=8).correct(volumes)
"""

from kcmc_tpu_torch.config import CorrectorConfig, config_from_dict
from kcmc_tpu_torch.corrector import CorrectionResult, MotionCorrector

__all__ = [
    "CorrectionResult",
    "CorrectorConfig",
    "MotionCorrector",
    "config_from_dict",
]
