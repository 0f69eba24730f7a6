"""`apply_correction` and `utils/trajectory.py` of the PyTorch port
against kcmc_tpu: the CPU route (the gather) for matrices, fields and
volumes, the kernel route (`force_kernel`: K7's and K8's plain versions
with the per-frame gather for flagged frames) against the reference's
interpret mode, the input checks, and the trajectory functions."""

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu.utils import trajectory as jtraj
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.ops.cuda_warp_field import warp_batch_field
from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix
from kcmc_tpu_torch.utils import trajectory as ttraj


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(n, shape, seed):
    rng = np.random.default_rng(seed)
    img = jsynthetic.render_scene(rng, shape, n_blobs=40).astype(np.float32) * 200 + 50
    return np.stack([img] * n) + rng.normal(0, 1.0, (n,) + shape).astype(np.float32)


def _maps(n, kind, seed):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(3), (n, 1, 1))
    M[:, :2, 2] = rng.uniform(-6, 6, (n, 2))
    if kind != "translation":
        M[:, :2, :2] += rng.normal(0, 0.02, (n, 2, 2))
    if kind == "homography":
        M[:, 2, :2] = rng.normal(0, 1e-4, (n, 2))
    if kind == "beyond":  # a 0.5-rad turn: past K7's 16-px residual bound
        c, s = np.cos(0.5), np.sin(0.5)
        M[1, :2, :2] = [[c, -s], [s, c]]
    return M.astype(np.float32)


def _fields(n, seed, beyond=False):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-2.0, 2.0, (n, 4, 4, 2)).astype(np.float32)
    if beyond:  # a residual past K8's 6-px bound
        f[1, :2] += 9.0
        f[1, 2:] -= 9.0
    return f


SHAPE = (64, 80)


@pytest.mark.parametrize("kind", ["translation", "affine", "homography", "fields", "volume"])
def test_apply_matches_reference_cpu_route(kind):
    """Within 1e-5 of max|frame| of the reference's CPU route (the
    gather), in batches of 4 with a short tail."""
    if kind == "volume":
        rng = np.random.default_rng(7)
        stack = rng.normal(100, 10, (3, 8, 24, 20)).astype(np.float32)
        M = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        M[:, :3, 3] = rng.uniform(-2, 2, (3, 3))
        kw = {"transforms": M}
    elif kind == "fields":
        stack = _stack(6, SHAPE, 1)
        kw = {"fields": _fields(6, 2)}
    else:
        stack = _stack(6, SHAPE, 1)
        kw = {"transforms": _maps(6, kind, 3)}
    want = kcmc_tpu.apply_correction(stack, batch_size=4, **kw)
    got = kcmc_tpu_torch.apply_correction(stack, batch_size=4, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == stack.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(stack).max()


@pytest.mark.parametrize("kind", ["matrix", "fields"])
def test_force_kernel_matches_interpret_mode(kind):
    """The kernel route on the CPU: K7 (max_px 16) or K8 (max_px 6) plain
    versions with the exact gather for the frame they flag, against the
    reference's interpret mode within the kernels' 1e-5 of max|frame|."""
    stack = _stack(3, SHAPE, 4)
    if kind == "matrix":
        maps = _maps(3, "beyond", 5)
        want = jwarp.fast_apply_matrix(stack, maps, force_kernel=True)
        got = twarp.fast_apply_matrix(torch.as_tensor(stack), torch.as_tensor(maps),
                                      force_kernel=True).numpy()
        ok = warp_batch_matrix(torch.as_tensor(stack), torch.as_tensor(maps), max_px=16)[1]
    else:
        maps = _fields(3, 6, beyond=True)
        want = jwarp.fast_apply_fields(stack, maps, force_kernel=True)
        got = twarp.fast_apply_fields(torch.as_tensor(stack), torch.as_tensor(maps),
                                      force_kernel=True).numpy()
        ok = warp_batch_field(torch.as_tensor(stack), torch.as_tensor(maps), max_px=6)[1]
    assert ok.tolist() == [True, False, True]  # the middle frame took the gather
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(stack).max()
    # the kernel route's output is the gather's on the flagged frame
    cpu = kcmc_tpu_torch.apply_correction(stack, device="cpu", **(
        {"transforms": maps} if kind == "matrix" else {"fields": maps}))
    np.testing.assert_array_equal(got[1], cpu[1])
    # the kept frames' gap to the gather (the CPU route, held to the
    # reference's above) is the route's own: the reference's kernel
    # route shows the same, within the same 1e-5
    scale = np.abs(stack).max()
    jgap = np.abs(np.asarray(want) - cpu)[[0, 2], 8:-8, 8:-8].max() / scale
    tgap = np.abs(got - cpu)[[0, 2], 8:-8, 8:-8].max() / scale
    assert abs(tgap - jgap) <= 1e-5 and tgap > 1e-4, (tgap, jgap)


# chip_smoke.py's e2e_apply data: config 2's scene (its CFG2_SCENE), the
# second channel 0.5 x the stack plus N(0, 2) noise from seed 1, and two
# of its frames with their ground-truth maps; frame 25 is the one whose
# kept-frame gap to the gather is the largest of the phase's 256 on these
# maps. The reference's interpret-mode reading of that gap (per frame, as
# a share of max|frame|, away from an 8-px border) is APPLY_WITNESS in
# chip_smoke.py, which holds the card's K7 route to it; APPLY_GAP_LIMIT
# (0.04) is its limit for every kept frame.
APPLY_WITNESS = {18: 0.0239287, 25: 0.0279765}
APPLY_GAP_LIMIT = 0.04


def _gaps(out, gather, frames):
    d = np.abs(np.asarray(out) - gather)[:, 8:-8, 8:-8].max(axis=(1, 2))
    return d.astype(np.float64) / np.abs(frames).max(axis=(1, 2))


# slow: two 512^2 frames and the reference's interpret-mode K7 compiled at
# that size, ~9.5 s of junit time in the six-worker tier-1 run;
# chip_smoke.py holds the card to these readings on every run
@pytest.mark.slow
def test_k7_gather_gap_witness_on_config2_channel(monkeypatch):
    """K7's gap to the gather on the frames it keeps belongs to the route:
    on two 512^2 frames of chip_smoke.py's e2e_apply channel the
    reference's interpret mode reads APPLY_WITNESS, the port's plain K7
    the same within 1e-6 (its pixels differ from interpret mode's by up
    to ~5e-5 of max|frame| on this noise, against ~4e-6 on smoother
    content), both under APPLY_GAP_LIMIT; the gather of maps off by 0.05
    px reads far above it."""
    from kcmc_tpu_torch.utils import synthetic as tsynthetic
    from kcmc_tpu_torch.utils.metrics import relative_transforms

    idx = sorted(APPLY_WITNESS)
    # render only the witness frames: the frame warps draw no random
    # numbers, so the other frames' zeros leave these two as they are
    calls, warp_scene = iter(range(64)), tsynthetic._warp_scene
    monkeypatch.setattr(tsynthetic, "_warp_scene", lambda scene, M: (
        warp_scene(scene, M) if next(calls) in idx else np.zeros_like(scene)))
    data = tsynthetic.make_drift_stack(n_frames=64, shape=(512, 512), model="affine",
                                       max_drift=10.0, seed=0, n_blobs=12000,
                                       sigma_range=(0.7, 1.4))
    noise = np.random.default_rng(1).normal(0, 2.0, (idx[-1] + 1, 512, 512))
    frames = (0.5 * data.stack[idx] + noise[idx]).astype(np.float32)
    maps = relative_transforms(data.transforms)[idx].astype(np.float32)
    fr, m = torch.as_tensor(frames), torch.as_tensor(maps)
    gather = twarp.warp_batch(fr, m).numpy()
    assert warp_batch_matrix(fr, m, max_px=16)[1].all()  # K7 keeps both
    jout = np.asarray(jwarp.fast_apply_matrix(frames, maps, force_kernel=True))
    tout = twarp.fast_apply_matrix(fr, m, force_kernel=True).numpy()
    assert np.abs(tout - jout).max() <= 1e-4 * np.abs(frames).max()
    jgap, tgap = _gaps(jout, gather, frames), _gaps(tout, gather, frames)
    np.testing.assert_allclose(jgap, [APPLY_WITNESS[i] for i in idx], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgap, jgap, rtol=0, atol=1e-6)
    assert jgap.max() < APPLY_GAP_LIMIT
    off = m.clone()
    off[:, 0, 2] += 0.05
    assert _gaps(twarp.warp_batch(fr, off).numpy(), gather, frames).min() > 4 * APPLY_GAP_LIMIT


@pytest.mark.parametrize("case", ["neither", "both", "fields_on_volume", "length",
                                  "rank"])
def test_apply_input_checks_match(case):
    st2, st3 = np.zeros((2, 8, 8), np.float32), np.zeros((2, 4, 8, 8), np.float32)
    eye3, eye4 = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)), np.tile(
        np.eye(4, dtype=np.float32), (2, 1, 1))
    args = {
        "neither": (st2, {}),
        "both": (st2, {"transforms": eye3, "fields": np.zeros((2, 2, 2, 2), np.float32)}),
        "fields_on_volume": (st3, {"fields": np.zeros((2, 2, 2, 2), np.float32)}),
        "length": (st2, {"transforms": eye3[:1]}),
        "rank": (st2, {"transforms": eye4}),
    }[case]
    with pytest.raises(ValueError) as want:
        kcmc_tpu.apply_correction(args[0], **args[1])
    with pytest.raises(ValueError) as got:
        kcmc_tpu_torch.apply_correction(args[0], device="cpu", **args[1])
    assert str(got.value) == str(want.value)


def test_apply_output_dtype_and_empty():
    stack = np.clip(_stack(3, SHAPE, 8), 0, 65535).astype(np.uint16)
    M = _maps(3, "affine", 9)
    want = kcmc_tpu.apply_correction(stack, M, output_dtype="input")
    got = kcmc_tpu_torch.apply_correction(stack, M, output_dtype="input", device="cpu")
    assert got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    empty = kcmc_tpu_torch.apply_correction(stack[:0], M[:0], device="cpu")
    assert empty.shape == (0,) + SHAPE and empty.dtype == np.float32


def _trajectory(T, d, seed):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(d), (T, 1, 1))
    M[:, :d - 1, d - 1] = np.cumsum(rng.normal(0, 1, (T, d - 1)), axis=0)
    M[:, :d - 1, :d - 1] += rng.normal(0, 0.01, (T, d - 1, d - 1))
    if d == 3:
        M[:, 2, :2] = rng.normal(0, 1e-5, (T, 2))
    return M.astype(np.float32)


@pytest.mark.parametrize("what", ["transforms_2d", "transforms_3d", "fields", "short",
                                  "interpolate", "interpolate_ends", "errors"])
def test_trajectory_matches(what):
    if what == "transforms_2d":
        M = _trajectory(40, 3, 0)
        np.testing.assert_array_equal(ttraj.smooth_trajectory(M, sigma=4.0),
                                      jtraj.smooth_trajectory(M, sigma=4.0))
    elif what == "transforms_3d":
        M = _trajectory(25, 4, 1)
        np.testing.assert_array_equal(ttraj.smooth_trajectory(M, sigma=2.5),
                                      jtraj.smooth_trajectory(M, sigma=2.5))
    elif what == "fields":
        f = np.random.default_rng(2).normal(0, 1, (30, 5, 6, 2)).astype(np.float32)
        np.testing.assert_array_equal(ttraj.smooth_trajectory(fields=f, sigma=3.0),
                                      jtraj.smooth_trajectory(fields=f, sigma=3.0))
    elif what == "short":
        M = _trajectory(1, 3, 3)
        np.testing.assert_array_equal(ttraj.smooth_trajectory(M), jtraj.smooth_trajectory(M))
    elif what.startswith("interpolate"):
        M = _trajectory(20, 3, 4)
        good = np.random.default_rng(5).uniform(size=20) < 0.6
        if what == "interpolate_ends":
            good[:3] = good[-2:] = False
        np.testing.assert_array_equal(ttraj.interpolate_failed(M, good),
                                      jtraj.interpolate_failed(M, good))
    else:
        bad = [lambda m: m.smooth_trajectory(), lambda m: m.smooth_trajectory(
            np.eye(3)[None], sigma=0.0), lambda m: m.smooth_trajectory(np.zeros((2, 3, 4))),
            lambda m: m.smooth_trajectory(fields=np.zeros((2, 3, 3))),
            lambda m: m.interpolate_failed(np.tile(np.eye(3), (2, 1, 1)), [False, False]),
            lambda m: m.interpolate_failed(np.tile(np.eye(3), (2, 1, 1)), [True])]
        for call in bad:
            with pytest.raises(ValueError) as want:
                call(jtraj)
            with pytest.raises(ValueError) as got:
                call(ttraj)
            assert str(got.value) == str(want.value)
