"""Synthetic drift stacks (numpy only): matrix drift, piecewise fields
and rigid 3D drift of z-stack volumes.

A copy of `make_drift_stack`, `make_piecewise_stack`,
`make_drift_stack_3d` and what they call
from `kcmc_tpu/utils/synthetic.py`, kept in the port so that scripts
driving the port (chip_smoke.py) never import the JAX package. Same
seed, same stack: `tests/test_torch_pipeline.py` and
`tests/test_torch_piecewise.py` check that the generators agree.
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


def make_piecewise_stack(
    n_frames: int = 32,
    shape: tuple[int, int] = (256, 256),
    grid: tuple[int, int] = (8, 8),
    max_disp: float = 6.0,
    noise: float = 0.01,
    seed: int = 0,
    n_blobs: int | None = None,
) -> SyntheticStack:
    """Config 3: smooth non-rigid per-frame displacement fields on a patch grid."""
    rng = np.random.default_rng(seed)
    H, W = shape
    gh, gw = grid
    if n_blobs is None:
        n_blobs = max(200, H * W // 650)
    scene = render_scene(rng, shape, n_blobs=n_blobs)
    fields = np.zeros((n_frames, gh, gw, 2), dtype=np.float32)
    # Temporally-correlated, spatially-smooth displacement fields.
    walk = _random_walk(rng, n_frames, 2, step=0.6, maxdev=max_disp * 0.6)
    for t in range(n_frames):
        base = _smooth_noise(rng, (gh, gw, 2), sigma=3, axes=(0, 1)) * 2.0
        fields[t] = np.clip(base + walk[t], -max_disp, max_disp)
    stack = np.empty((n_frames, H, W), dtype=np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    for t in range(n_frames):
        flow = upsample_field(fields[t], shape)  # (H, W, 2) in (dx, dy)
        # frame(x) = scene(x - u(x)): sample the scene at shifted coords so
        # the *forward* field maps ref->frame (matches pipeline convention).
        stack[t] = _bilinear(scene, xs - flow[..., 0], ys - flow[..., 1])
    if noise > 0:
        stack = stack + rng.normal(0, noise, stack.shape).astype(np.float32)
    mats = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    return SyntheticStack(stack=stack.astype(np.float32), transforms=mats, fields=fields, reference=scene)


def upsample_field(field: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Bilinearly upsample a (gh, gw, 2) patch-center field to (H, W, 2).

    Patch centers sit at ((i + 0.5) * H / gh - 0.5) so the field is
    defined on a uniform cell-center grid.
    """
    gh, gw, _ = field.shape
    H, W = shape
    ys = (np.arange(H, dtype=np.float32) + 0.5) * gh / H - 0.5
    xs = (np.arange(W, dtype=np.float32) + 0.5) * gw / W - 0.5
    ys = np.clip(ys, 0, gh - 1)
    xs = np.clip(xs, 0, gw - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    f00 = field[y0][:, x0]
    f01 = field[y0][:, x1]
    f10 = field[y1][:, x0]
    f11 = field[y1][:, x1]
    return (
        f00 * (1 - fy) * (1 - fx)
        + f01 * (1 - fy) * fx
        + f10 * fy * (1 - fx)
        + f11 * fy * fx
    ).astype(np.float32)


def make_drift_stack_3d(
    n_frames: int = 16,
    shape: tuple[int, int, int] = (32, 96, 96),
    max_drift: float = 4.0,
    max_angle: float = 0.03,
    noise: float = 0.01,
    seed: int = 0,
) -> SyntheticStack:
    """Config 5: z-stack volumes under rigid 3D drift (rotation + translation)."""
    rng = np.random.default_rng(seed)
    D, H, W = shape
    scene = render_scene(rng, shape, n_blobs=max(150, D * H * W // 2000))
    center = (np.array([W, H, D], np.float32) - 1) / 2.0  # (x, y, z)
    trans = _random_walk(rng, n_frames, 3, step=0.5, maxdev=max_drift)
    angs = _random_walk(rng, n_frames, 3, step=0.003, maxdev=max_angle)
    mats = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    zs, ys, xs = np.meshgrid(
        np.arange(D, dtype=np.float32),
        np.arange(H, dtype=np.float32),
        np.arange(W, dtype=np.float32),
        indexing="ij",
    )
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
    stack = np.empty((n_frames,) + shape, dtype=np.float32)
    for t in range(n_frames):
        R = _euler(angs[t])
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = trans[t] + center - R @ center
        mats[t] = M
        Minv = np.linalg.inv(M)
        sp = pts @ Minv[:3, :3].T + Minv[:3, 3]
        stack[t] = _trilinear(scene, sp).reshape(shape)
    if noise > 0:
        stack = stack + rng.normal(0, noise, stack.shape).astype(np.float32)
    return SyntheticStack(stack=stack.astype(np.float32), transforms=mats, reference=scene)


def _euler(angles: np.ndarray) -> np.ndarray:
    ax, ay, az = angles
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return Rz @ Ry @ Rx


def _trilinear(vol: np.ndarray, pts_xyz: np.ndarray) -> np.ndarray:
    """Sample a (D, H, W) volume at (N, 3) float (x, y, z) points."""
    D, H, W = vol.shape
    x, y, z = pts_xyz[:, 0], pts_xyz[:, 1], pts_xyz[:, 2]
    x0, y0, z0 = np.floor(x).astype(np.int32), np.floor(y).astype(np.int32), np.floor(z).astype(np.int32)
    fx, fy, fz = x - x0, y - y0, z - z0
    out = np.zeros(len(pts_xyz), dtype=np.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi = np.clip(x0 + dx, 0, W - 1)
                yi = np.clip(y0 + dy, 0, H - 1)
                zi = np.clip(z0 + dz, 0, D - 1)
                wgt = (
                    (fx if dx else 1 - fx)
                    * (fy if dy else 1 - fy)
                    * (fz if dz else 1 - fz)
                )
                out += vol[zi, yi, xi] * wgt
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (z >= 0) & (z <= D - 1)
    return (out * inb).astype(np.float32)
