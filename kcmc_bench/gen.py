"""Recordings for the benchmark, made from the run's seed (numpy only).

A frozen copy of the 2D generators of `kcmc_tpu_torch/utils/synthetic.py`
(`render_scene`, `make_drift_stack`, `make_piecewise_stack`,
`upsample_field` and what they call), so that the yardstick does not
move when the program's copy does. One change: `motion_rng` and
`noise_rng` draw the motion (drift walks, affine jitter, fields) and
the sensor noise from streams of their own. Without them the copies
give the program's own bytes (tests/test_kcmc_bench_gen.py).
`recording` builds a cell's stack from the run's seed, tiled to the
recording's length as the JAX package's bench.py tiles its stacks.
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
    motion_rng: np.random.Generator | None = None,
    noise_rng: np.random.Generator | None = None,
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
    mrng = rng if motion_rng is None else motion_rng
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    trans = _random_walk(mrng, n_frames, 2, step=1.0, maxdev=max_drift)
    mats = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    if model in ("rigid", "similarity", "affine", "homography"):
        angles = _random_walk(mrng, n_frames, 1, step=0.004, maxdev=0.05)[:, 0]
    if model == "similarity":
        # zoom drift: bounded random walk of the uniform scale
        scales = 1.0 + _random_walk(mrng, n_frames, 1, step=0.002, maxdev=0.03)[:, 0]
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
                L = L @ (np.eye(2, dtype=np.float32) + mrng.uniform(-0.02, 0.02, (2, 2)).astype(np.float32))
            M[:2, :2] = L
            M[:2, 2] = trans[t] + np.array([cx, cy], np.float32) - L @ np.array([cx, cy], np.float32)
            if model == "homography":
                M[2, :2] = mrng.uniform(-2e-5, 2e-5, 2).astype(np.float32)
        mats[t] = M
    stack = np.stack([_warp_scene(scene, mats[t]) for t in range(n_frames)])
    if noise > 0:
        stack = stack + (rng if noise_rng is None else noise_rng).normal(
            0, noise, stack.shape).astype(np.float32)
    return SyntheticStack(stack=stack.astype(np.float32), transforms=mats, reference=scene)


def make_piecewise_stack(
    n_frames: int = 32,
    shape: tuple[int, int] = (256, 256),
    grid: tuple[int, int] = (8, 8),
    max_disp: float = 6.0,
    noise: float = 0.01,
    seed: int = 0,
    n_blobs: int | None = None,
    motion_rng: np.random.Generator | None = None,
    noise_rng: np.random.Generator | None = None,
) -> SyntheticStack:
    """Config 3: smooth non-rigid per-frame displacement fields on a patch grid."""
    rng = np.random.default_rng(seed)
    H, W = shape
    gh, gw = grid
    if n_blobs is None:
        n_blobs = max(200, H * W // 650)
    scene = render_scene(rng, shape, n_blobs=n_blobs)
    mrng = rng if motion_rng is None else motion_rng
    fields = np.zeros((n_frames, gh, gw, 2), dtype=np.float32)
    # Temporally-correlated, spatially-smooth displacement fields.
    walk = _random_walk(mrng, n_frames, 2, step=0.6, maxdev=max_disp * 0.6)
    for t in range(n_frames):
        base = _smooth_noise(mrng, (gh, gw, 2), sigma=3, axes=(0, 1)) * 2.0
        fields[t] = np.clip(base + walk[t], -max_disp, max_disp)
    stack = np.empty((n_frames, H, W), dtype=np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    for t in range(n_frames):
        flow = upsample_field(fields[t], shape)  # (H, W, 2) in (dx, dy)
        # frame(x) = scene(x - u(x)): sample the scene at shifted coords so
        # the *forward* field maps ref->frame (matches pipeline convention).
        stack[t] = _bilinear(scene, xs - flow[..., 0], ys - flow[..., 1])
    if noise > 0:
        stack = stack + (rng if noise_rng is None else noise_rng).normal(
            0, noise, stack.shape).astype(np.float32)
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



def recording(scene: dict, traffic: dict, seed: int):
    """(stack (T, H, W) float32, truth) of a cell: `scene` is the
    configuration's scene block, `traffic` the traffic file. The scene
    comes from the traffic's `scene_seed` and the motion from its
    `motion_seed`, the same in every run; `seed` draws the sensor
    noise. So every seed registers the same motions of the same scene
    under other noise: the same work, and other inputs. (An order drawn
    from the seed would move the frame at which the program's
    out-of-bound escalation trips, and with it the work.) The
    `distinct` frames are tiled to `frames`; `truth` is their
    SyntheticStack (transforms, or fields for a piecewise scene)."""
    shape = tuple(traffic["shape"])
    n = int(traffic["distinct"])
    n_blobs = int(round(scene["blobs_per_px"] * shape[0] * shape[1]))
    common = dict(n_frames=n, shape=shape, seed=int(traffic["scene_seed"]), n_blobs=n_blobs,
                  motion_rng=np.random.default_rng(int(traffic["motion_seed"])),
                  noise_rng=np.random.default_rng([int(seed) % (1 << 64), 1]))
    kind = scene["generator"]
    if kind == "drift":
        data = make_drift_stack(model=scene["model"], max_drift=float(scene["max_drift"]),
                                sigma_range=tuple(scene["sigma_range"]), **common)
    elif kind == "piecewise":
        data = make_piecewise_stack(grid=tuple(scene["grid"]),
                                    max_disp=float(scene["max_disp"]), **common)
    else:
        raise ValueError(f"unknown scene generator {kind!r}")
    frames = int(traffic["frames"])
    reps = -(-frames // n)
    return np.ascontiguousarray(np.tile(data.stack, (reps, 1, 1))[:frames]), data
