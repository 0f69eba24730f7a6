"""Synthetic translation/matrix drift stacks (numpy only).

A copy of `make_drift_stack` and what it calls from
`kcmc_tpu/utils/synthetic.py`, kept in the port so that scripts driving
the port (chip_smoke.py) never import the JAX package. Same seed, same
stack: `tests/test_torch_pipeline.py` checks that the two generators
agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticStack:
    """A generated workload: frames plus ground truth."""

    stack: np.ndarray  # (T, H, W) or (T, D, H, W) float32
    transforms: np.ndarray  # (T, 3, 3) / (T, 4, 4) ground-truth maps ref->frame
    fields: np.ndarray | None = None  # (T, gh, gw, 2) for piecewise configs
    reference: np.ndarray | None = None  # the undrifted scene


def _smooth_noise(rng: np.random.Generator, shape, sigma: float, axes=None) -> np.ndarray:
    """Band-limited noise: white noise blurred by a separable box-ish kernel."""
    x = rng.standard_normal(shape).astype(np.float32)
    k = max(1, int(sigma))
    if k > 1:
        kernel = np.ones(k, dtype=np.float32) / k
        for axis in axes if axes is not None else range(x.ndim):
            if x.shape[axis] >= k:
                x = np.apply_along_axis(
                    lambda v: np.convolve(v, kernel, mode="same"), axis, x
                )
    return x


def render_scene(
    rng: np.random.Generator,
    shape: tuple[int, ...],
    n_blobs: int = 400,
    sigma_range: tuple[float, float] = (1.0, 2.5),
) -> np.ndarray:
    """A corner-rich scene: many small anisotropic Gaussian blobs + texture.

    Blobs give the detector stable corners; the smooth background gives
    the warp something to interpolate. `sigma_range` bounds the blob
    radii: dense high-keypoint scenes (config 2's ~2k-matches regime)
    need sharper blobs, or neighbors at >20 blobs/1000 px^2 merge into
    texture and the detectable-corner count saturates.
    """
    nd = len(shape)
    img = np.zeros(shape, dtype=np.float32)
    # keep blob centers off the boundary; shallow axes (z-stacks with a
    # dozen planes) get a proportional margin instead of the fixed 8
    coords = [
        rng.uniform(min(8, s / 4), s - min(8, s / 4), size=n_blobs)
        for s in shape
    ]
    amps = rng.uniform(0.4, 1.0, size=n_blobs).astype(np.float32)
    sigmas = rng.uniform(*sigma_range, size=(n_blobs, nd)).astype(np.float32)
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    # Render in chunks to bound memory for 3D scenes.
    for i in range(n_blobs):
        sl = []
        for a in range(nd):
            lo = int(max(0, coords[a][i] - 4 * sigmas[i, a]))
            hi = int(min(shape[a], coords[a][i] + 4 * sigmas[i, a] + 1))
            sl.append(slice(lo, hi))
        sl = tuple(sl)
        expo = np.zeros([s.stop - s.start for s in sl], dtype=np.float32)
        for a in range(nd):
            g = grids[a][sl] - coords[a][i]
            expo += (g / sigmas[i, a]) ** 2
        img[sl] += amps[i] * np.exp(-0.5 * expo)
    img += 0.05 * _smooth_noise(rng, shape, sigma=9)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def _warp_scene(scene: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Inverse-warp a 2D scene through homogeneous matrix M (maps ref->frame
    coordinates; we sample scene at M^-1 [x, y])."""
    H, W = scene.shape
    Minv = np.linalg.inv(M)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    w = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    sx = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / w
    sy = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / w
    return _bilinear(scene, sx, sy)


def _bilinear(scene: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    H, W = scene.shape
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx = sx - x0
    fy = sy - y0
    x0c = np.clip(x0, 0, W - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    v = (
        scene[y0c, x0c] * (1 - fx) * (1 - fy)
        + scene[y0c, x1c] * fx * (1 - fy)
        + scene[y1c, x0c] * (1 - fx) * fy
        + scene[y1c, x1c] * fx * fy
    )
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return (v * inb).astype(np.float32)


def _random_walk(rng, n, dim, step, maxdev):
    """Bounded random-walk drift trajectory, starting at 0."""
    steps = rng.normal(0, step, size=(n, dim)).astype(np.float32)
    traj = np.cumsum(steps, axis=0)
    return np.clip(traj, -maxdev, maxdev)


def make_drift_stack(
    n_frames: int = 64,
    shape: tuple[int, int] = (256, 256),
    model: str = "translation",
    noise: float = 0.01,
    max_drift: float = 12.0,
    seed: int = 0,
    n_blobs: int | None = None,
    sigma_range: tuple[float, float] = (1.0, 2.5),
) -> SyntheticStack:
    """Configs 1/2/4: a 2D stack drifting under the given transform model.

    `n_blobs` overrides the scene's feature density (default ~400 on
    512x512); `sigma_range` the blob radii. Config 2's nominal "~2k
    matches/frame" regime needs a dense, SHARP scene: n_blobs ~ 12000
    with sigma_range (0.7, 1.4) and max_keypoints=4096 sustains ~2k
    surviving matches per frame (soft default-radius blobs merge at
    that density and detection saturates near 2.4k keypoints).
    """
    allowed = ("translation", "rigid", "similarity", "affine", "homography")
    if model not in allowed:
        raise ValueError(
            f"make_drift_stack model must be one of {allowed}, got {model!r}"
            " (3D stacks: make_drift_stack_3d; non-rigid: make_piecewise_stack)"
        )
    rng = np.random.default_rng(seed)
    H, W = shape
    if n_blobs is None:
        n_blobs = max(200, H * W // 650)
    scene = render_scene(rng, shape, n_blobs=n_blobs, sigma_range=sigma_range)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    trans = _random_walk(rng, n_frames, 2, step=1.0, maxdev=max_drift)
    mats = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    if model in ("rigid", "similarity", "affine", "homography"):
        angles = _random_walk(rng, n_frames, 1, step=0.004, maxdev=0.05)[:, 0]
    if model == "similarity":
        # zoom drift: bounded random walk of the uniform scale
        scales = 1.0 + _random_walk(rng, n_frames, 1, step=0.002, maxdev=0.03)[:, 0]
    for t in range(n_frames):
        M = np.eye(3, dtype=np.float32)
        if model == "translation":
            M[:2, 2] = trans[t]
        else:
            # Compose about the image center so rotation doesn't fling
            # content out of frame.
            c, s = np.cos(angles[t]), np.sin(angles[t])
            L = np.array([[c, -s], [s, c]], dtype=np.float32)
            if model == "similarity":
                L = np.float32(scales[t]) * L
            if model == "affine":
                L = L @ (np.eye(2, dtype=np.float32) + rng.uniform(-0.02, 0.02, (2, 2)).astype(np.float32))
            M[:2, :2] = L
            M[:2, 2] = trans[t] + np.array([cx, cy], np.float32) - L @ np.array([cx, cy], np.float32)
            if model == "homography":
                M[2, :2] = rng.uniform(-2e-5, 2e-5, 2).astype(np.float32)
        mats[t] = M
    stack = np.stack([_warp_scene(scene, mats[t]) for t in range(n_frames)])
    if noise > 0:
        stack = stack + rng.normal(0, noise, stack.shape).astype(np.float32)
    return SyntheticStack(stack=stack.astype(np.float32), transforms=mats, reference=scene)
