"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every process collects the same tests. This file
imports neither jax nor kcmc_tpu, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kcmc_tpu_torch import MotionCorrector
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.ops import (
    cuda_build,
    cuda_detect,
    cuda_detect3d,
    cuda_moments,
    cuda_patch,
    cuda_patch3d,
    cuda_select,
    cuda_warp,
    cuda_warp_field,
    cuda_warp_matrix,
    warp_field,
    warp_separable,
)
from kcmc_tpu_torch.ops import describe as D
from kcmc_tpu_torch.ops.describe import sel_rot
from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
from kcmc_tpu_torch.ops.patterns import ROT_RADIUS
from kcmc_tpu_torch.ops.pyramid import build_pyramid
from kcmc_tpu_torch.utils.metrics import control_points, relative_transforms, transform_rmse
from kcmc_tpu_torch.utils.synthetic import (
    make_drift_stack,
    make_drift_stack_3d,
    make_piecewise_stack,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(n=4, shape=(160, 192), seed=0):
    return make_drift_stack(n, shape, seed=seed)


def test_k1_matches_plain_bitwise(cuda):
    fr = torch.as_tensor(_stack().stack, device=cuda)
    before = cuda_build.launch_counts()["detect_response"]
    got = cuda_detect.detect_response(fr, smooth_sigma=2.0)
    want = cuda_detect.detect_response_plain(fr, smooth_sigma=2.0)
    assert cuda_build.launch_counts()["detect_response"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2_matches_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    padded = torch.randn((3, 220, 250), device=cuda, generator=gen).to(torch.bfloat16)
    xy = torch.rand((3, 300, 2), device=cuda, generator=gen) * torch.tensor(
        [250.0 - 30, 220.0 - 30], device=cuda
    )
    got = cuda_patch.extract_blended(padded, xy.contiguous(), 28)
    want = cuda_patch.extract_blended_plain(padded, xy, 28)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_k3_matches_plain_bitwise(cuda):
    fr = torch.as_tensor(_stack(6).stack, device=cuda)
    M = torch.eye(3, device=cuda).repeat(6, 1, 1)
    M[:, 0, 2] = torch.tensor([3.25, -7.75, 140.3, 0.0, -128.0, 127.9])
    M[:, 1, 2] = torch.tensor([-1.5, 10.125, 2.0, -129.0, 127.5, -0.01])
    out, ok = cuda_warp.warp_translation(fr, M)
    want, want_ok = cuda_warp.warp_translation_plain(fr, M)
    assert torch.equal(ok, want_ok)
    assert torch.equal(out, want)


def test_slice_on_card_matches_cpu_route(cuda):
    data = _stack(8, (128, 128), seed=1)
    cuda_build.reset_launches()
    on_card = MotionCorrector(batch_size=4).correct(data.stack)
    assert cuda_build.launch_counts() == {
        "detect_response": 3, "extract_blended": 3, "warp_translation": 4,
        "moment_maps": 0, "binned_select_rows": 0, "extract_blended_moments": 0,
        "warp_batch_matrix": 0, "warp_batch_field": 0, "response_fields_3d": 0,
        "extract_blended_3d": 0, "extract_patches": 0,
    }
    on_cpu = MotionCorrector(device="cpu", batch_size=4).correct(data.stack)
    assert np.abs(on_card.transforms - on_cpu.transforms).max() <= 1e-4
    np.testing.assert_array_equal(
        on_card.diagnostics["n_inliers"], on_cpu.diagnostics["n_inliers"]
    )


def test_k4_matches_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    padded = torch.randn((3, 230, 301), device=cuda, generator=gen).to(torch.bfloat16)
    got = cuda_moments.moment_maps(padded)
    want = cuda_moments.moment_maps_plain(padded)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k5_matches_plain(cuda):
    """One-hot sel (the describe route's): bit-identical; dense sel:
    within one bf16 ulp plus float32 sum slack."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, Kp, L = 2, 96, 961
    flat = torch.randn((B, Kp, L), device=cuda, generator=gen).to(torch.bfloat16)
    ibin = torch.tensor([[0, 3, 3, 15, 16, 7], [9, 9, 9, 1, 0, 16]], dtype=torch.int32, device=cuda)
    sel = sel_rot(cuda)
    got = cuda_select.binned_select_rows(flat, ibin, sel, 16)
    want = cuda_select.binned_select_rows_plain(flat, ibin, sel, 16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    dense = torch.randn((16, L, 512), device=cuda, generator=gen).to(torch.bfloat16)
    got = cuda_select.binned_select_rows(flat, ibin, dense, 16).float()
    want = cuda_select.binned_select_rows_plain(flat, ibin, dense, 16).float()
    mag = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    assert ((got - want).abs() <= ulp + 1e-5 * want.abs().max()).all()


def test_k7_matches_plain(cuda):
    fr = torch.as_tensor(_stack(6, (200, 232)).stack, device=cuda)
    th = torch.tensor([0.0, 0.02, -0.03, 0.2, 0.01, 0.0], device=cuda)
    M = torch.eye(3, device=cuda).repeat(6, 1, 1)
    M[:, 0, 0] = torch.cos(th)
    M[:, 0, 1] = -torch.sin(th)
    M[:, 1, 0] = torch.sin(th)
    M[:, 1, 1] = torch.cos(th)
    M[:, 0, 2] = torch.tensor([0.0, 3.3, -7.5, 0.0, 150.0, 2.0], device=cuda)
    M[:, 2, 0] = torch.tensor([0.0, 1e-5, 0.0, 0.0, 0.0, 0.0], device=cuda)
    M[5, 2, 2] = 0.0
    out, ok = cuda_warp_matrix.warp_batch_matrix(fr, M.contiguous(), max_px=12)
    want, want_ok = cuda_warp_matrix.warp_batch_matrix_plain(fr, M, 12)
    assert ok.tolist() == want_ok.tolist() == [True, True, True, False, False, False]
    assert torch.equal(out, want)


def test_affine_slice_on_card_matches_cpu_route(cuda):
    data = make_drift_stack(8, (128, 128), model="affine", seed=0, sigma_range=(0.7, 1.4))
    kw = dict(model="affine", batch_size=4, max_keypoints=2048, cand_tile=4,
              nms_size=3, harris_window_sigma=1.2)
    cuda_build.reset_launches()
    on_card = MotionCorrector(**kw).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["warp_translation"] == 0
    assert all(counts[k] == 3 for k in (
        "detect_response", "extract_blended", "moment_maps", "binned_select_rows"))
    assert counts["warp_batch_matrix"] == 4
    on_cpu = MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert np.abs(on_card.transforms - on_cpu.transforms).max() <= 1e-3
    assert np.abs(on_card.diagnostics["n_inliers"].astype(int)
                  - on_cpu.diagnostics["n_inliers"]).max() <= 2


def test_k6_matches_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    padded = torch.randn((3, 220, 250), device=cuda, generator=gen).to(torch.bfloat16)
    xy = (torch.rand((3, 300, 2), device=cuda, generator=gen) * torch.tensor(
        [250.0 - 30, 220.0 - 30], device=cuda)).contiguous()
    before = cuda_build.launch_counts()
    got = cuda_patch.extract_blended(padded, xy, 32, with_moments=True)
    after = cuda_build.launch_counts()
    assert after["extract_blended_moments"] == before["extract_blended_moments"] + 1
    assert after["extract_blended"] == before["extract_blended"]
    want = cuda_patch.extract_blended_plain(padded, xy, 32, with_moments=True)
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_k8_matches_plain(cuda):
    """Bit-identical on fields inside the envelope, one beyond the
    residual bound and one beyond +-PAD, at an odd shape and grid."""
    fr = torch.as_tensor(_stack(4, (200, 160)).stack, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    f = (torch.rand((4, 6, 5, 2), device=cuda, generator=gen) - 0.5) * 4.0
    f[1] += torch.tensor([7.3, -5.1], device=cuda)
    f[2, :3] += 10.0
    f[3] += 300.0
    f = f.contiguous()
    out, ok = cuda_warp_field.warp_batch_field(fr, f, max_px=6)
    want, want_ok = cuda_warp_field.warp_batch_field_plain(fr, f, 6)
    assert ok.tolist() == want_ok.tolist() == [True, True, False, False]
    assert torch.equal(out, want)


@pytest.mark.parametrize("model", ["homography", "rigid"])
def test_matrix_slices_on_card_match_cpu_route(cuda, model):
    data = make_drift_stack(8, (128, 128), model=model, seed=0)
    cuda_build.reset_launches()
    on_card = MotionCorrector(model=model, batch_size=4).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["detect_response"] == counts["extract_blended_moments"] == 3
    assert counts["warp_batch_matrix"] == 4
    assert counts["extract_blended"] == counts["moment_maps"] == counts["warp_translation"] == 0
    on_cpu = MotionCorrector(model=model, device="cpu", batch_size=4).correct(data.stack)
    assert np.abs(on_card.transforms - on_cpu.transforms).max() <= 1e-3
    assert np.abs(on_card.diagnostics["n_inliers"].astype(int)
                  - on_cpu.diagnostics["n_inliers"]).max() <= 2


def test_piecewise_slice_on_card_matches_cpu_route(cuda):
    data = make_piecewise_stack(8, (128, 128), seed=0)
    cuda_build.reset_launches()
    on_card = MotionCorrector(model="piecewise", batch_size=4).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["detect_response"] == counts["extract_blended"] == 3
    assert counts["warp_batch_field"] == 2 * (1 + 4)
    assert counts["warp_batch_matrix"] == counts["extract_blended_moments"] == 0
    on_cpu = MotionCorrector(model="piecewise", device="cpu", batch_size=4).correct(data.stack)
    assert np.sqrt(np.mean(np.sum((on_card.fields - on_cpu.fields) ** 2, -1))) <= 1e-3


@pytest.mark.parametrize("offset", [False, True])
def test_k9_matches_plain_bitwise(cuda, offset):
    """Zero background and a camera offset, at a shape with partial
    tiles in y and x."""
    v = torch.as_tensor(make_drift_stack_3d(2, (20, 72, 88), seed=1).stack, device=cuda)
    if offset:
        gen = torch.Generator(device=cuda).manual_seed(7)
        v = v * 50.0 + 100.0 + 2.0 * torch.randn(v.shape, device=cuda, generator=gen)
    v = v.contiguous()
    before = cuda_build.launch_counts()["response_fields_3d"]
    got = cuda_detect3d.response_fields_3d(v, smooth_sigma=2.0)
    assert cuda_build.launch_counts()["response_fields_3d"] == before + 1
    want = cuda_detect3d.response_fields_3d_plain(v, smooth_sigma=2.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_detect3d.response_fields_3d(v)[1] is None


def test_k10_matches_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    padded = (torch.randn((2, 20, 60, 70), device=cuda, generator=gen) * 100.0).contiguous()
    xyz = (torch.rand((2, 200, 3), device=cuda, generator=gen)
           * torch.tensor([50.0, 40.0, 12.0], device=cuda)).contiguous()
    before = cuda_build.launch_counts()["extract_blended_3d"]
    got = cuda_patch3d.extract_blended_3d(padded, xyz, 8, 20)
    assert cuda_build.launch_counts()["extract_blended_3d"] == before + 1
    assert torch.equal(got, cuda_patch3d.extract_blended_3d_plain(padded, xyz, 8, 20))


def _px3(a, b, shape):
    """Largest displacement between two (T, 4, 4) stacks over the 9x9x9
    control grid of a (D, H, W) volume, in pixels."""
    pts = control_points(shape).astype(np.float64)

    def ap(M):
        return pts @ np.swapaxes(M[:, :3, :3], 1, 2).astype(np.float64) + M[:, None, :3, 3]

    return float(np.abs(ap(a) - ap(b)).max())


@pytest.fixture
def rigid3d_case(cuda):
    data = make_drift_stack_3d(6, (16, 64, 64), seed=2)
    return data, dict(model="rigid3d", batch_size=2, max_keypoints=256)


def test_rigid3d_slice_on_card_matches_cpu_route(rigid3d_case):
    data, kw = rigid3d_case
    cuda_build.reset_launches()
    on_card = MotionCorrector(**kw).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["response_fields_3d"] == counts["extract_blended_3d"] == 4
    assert sum(counts.values()) == 8
    assert on_card.transforms.shape == (6, 4, 4)
    on_cpu = MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert _px3(on_card.transforms, on_cpu.transforms, (16, 64, 64)) <= 1e-3
    assert np.abs(on_card.diagnostics["n_inliers"].astype(int)
                  - on_cpu.diagnostics["n_inliers"]).max() <= 2


def test_rigid3d_warps_on_card_match_cpu(cuda, rigid3d_case):
    """Pixels compared only under identical transforms: the bounded
    volume warp and the gather rescue on the card against the same
    functions on the CPU, for the ground-truth maps and for a rotation
    beyond the bound (zeroed and flagged by the bounded warp)."""
    data, kw = rigid3d_case
    M = relative_transforms(data.transforms).astype(np.float32)
    M[1, :3, :3] = np.array([[0.92, -0.39, 0.0], [0.39, 0.92, 0.0], [0.0, 0.0, 1.0]], np.float32)
    vols = torch.as_tensor(data.stack)
    Mt = torch.as_tensor(M)
    scale = float(vols.abs().max())
    out, ok = warp_field.warp_batch_rigid3d(vols.to(cuda), Mt.to(cuda), max_px=6)
    want, want_ok = warp_field.warp_batch_rigid3d(vols, Mt, max_px=6)
    assert ok.cpu().tolist() == want_ok.tolist()
    assert not bool(want_ok[1]) and bool(want_ok[0])
    assert float((out.cpu() - want).abs().max()) <= 1e-5 * scale
    card = TorchBackend(CorrectorConfig(**kw)).rescue_warp(data.stack, {"transform": M})
    cpu = TorchBackend(CorrectorConfig(**kw), device="cpu").rescue_warp(
        data.stack, {"transform": M})
    assert np.abs(card - cpu).max() <= 1e-5 * scale
    assert np.abs(card[1]).max() > 0.0


@pytest.mark.parametrize("K", [512, 13])
def test_k11_matches_plain_bitwise(cuda, K):
    """The raw patch cut at chip_smoke's shapes (32 frames of 540^2,
    P=28) and at an odd K, origins past the contract clamped alike."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    padded = torch.randn((32, 540, 540), device=cuda, generator=gen).contiguous()
    oy = torch.randint(0, 540 - 28 + 1, (32, K), device=cuda, generator=gen, dtype=torch.int32)
    ox = torch.randint(0, 540 - 28 + 1, (32, K), device=cuda, generator=gen, dtype=torch.int32)
    oy[0, 0], ox[0, 0] = 10_000, -5
    before = cuda_build.launch_counts()["extract_patches"]
    got = cuda_patch.extract_patches(padded, oy.contiguous(), ox.contiguous(), 28)
    assert cuda_build.launch_counts()["extract_patches"] == before + 1
    assert torch.equal(got, cuda_patch.extract_patches_plain(padded, oy, ox, 28))


@pytest.mark.parametrize("shape,n", [((344, 344), 4), ((232, 232), 4), ((2048, 2048), 2)])
def test_k1_at_octave_and_wide_shapes_bitwise(cuda, shape, n):
    """K1 at the pyramid's octave sizes (not multiples of its 32-px
    tile) and at 2048^2, where the reference runs column panels."""
    fr = torch.as_tensor(_stack(n, shape).stack, device=cuda)
    got = cuda_detect.detect_response(fr, smooth_sigma=2.0)
    want = cuda_detect.detect_response_plain(fr, smooth_sigma=2.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k6_at_octave_k176_bitwise(cuda):
    """K6 on the 344^2 octave of 512^2 frames at its 176 keypoints."""
    fr = torch.as_tensor(make_drift_stack(4, (512, 512), model="similarity", seed=0).stack,
                         device=cuda)
    oc = build_pyramid(fr, 3, 1.5)[1].frames
    kps, smooth = detect_keypoints_batch(oc, max_keypoints=176, threshold=1e-4,
                                         smooth_sigma=2.0)
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    padded = D.edge_pad((smooth - mu).to(torch.bfloat16), ROT_RADIUS + 1).contiguous()
    P = 2 * ROT_RADIUS + 2
    got = cuda_patch.extract_blended(padded, kps.xy.contiguous(), P, with_moments=True)
    want = cuda_patch.extract_blended_plain(padded, kps.xy, P, with_moments=True)
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_pyramid_slice_on_card_matches_cpu_route(cuda):
    """similarity, n_octaves=3: K1 and K6 on the reference's three
    octaves and on each batch's three octaves plus the fine pass, the
    separable warp in plain torch; transforms within 1e-3 px of the CPU
    route and identical counts. Pixels are compared under identical
    transforms only: the separable warp on the card and on the CPU."""
    data = make_drift_stack(8, (128, 128), model="similarity", seed=0)
    kw = dict(model="similarity", n_octaves=3, batch_size=4)
    cuda_build.reset_launches()
    on_card = MotionCorrector(**kw).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["detect_response"] == counts["extract_blended_moments"] == 3 + 2 * 4
    assert sum(counts.values()) == 2 * 11
    on_cpu = MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert transform_rmse(on_card.transforms, on_cpu.transforms, (128, 128)) <= 1e-3
    for k in ("n_keypoints", "n_matches", "coarse_n_matches", "n_inliers"):
        np.testing.assert_array_equal(on_card.diagnostics[k], on_cpu.diagnostics[k])
    fr = torch.as_tensor(data.stack)
    M = torch.as_tensor(on_cpu.transforms)
    out, ok = warp_separable.warp_batch_affine(fr.to(cuda), M.to(cuda), 8, with_ok=True)
    want, want_ok = warp_separable.warp_batch_affine(fr, M, 8, with_ok=True)
    assert ok.cpu().tolist() == want_ok.tolist()
    assert float((out.cpu() - want).abs().max()) <= 1e-5 * float(fr.abs().max())


def _k5_holds(flat, ibin, cuda):
    """K5 against its plain version: bit-identical with the one-hot
    selection stack, within one bf16 ulp with a dense one (float32 sums
    in another order)."""
    sel = sel_rot(cuda)
    before = cuda_build.launch_counts()["binned_select_rows"]
    got = cuda_select.binned_select_rows(flat, ibin, sel, 16)
    assert cuda_build.launch_counts()["binned_select_rows"] == before + 1
    want = cuda_select.binned_select_rows_plain(flat, ibin, sel, 16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    gen = torch.Generator(device=cuda).manual_seed(5)
    dense = torch.randn(sel.shape, device=cuda, generator=gen).to(torch.bfloat16)
    gd = cuda_select.binned_select_rows(flat, ibin, dense, 16).float()
    wd = cuda_select.binned_select_rows_plain(flat, ibin, dense, 16).float()
    mag = torch.maximum(gd.abs(), wd.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    assert bool(((gd - wd).abs() <= ulp + 1e-5 * wd.abs().max()).all())


@pytest.mark.parametrize("pattern", ["every_block", "one_bin"])
@pytest.mark.parametrize("Kp", [16, 48, 144, 4368])
def test_k5_tiles_and_bin_passes(cuda, Kp, pattern):
    """Kp of 1, 3, 9 and 273 row blocks (tail tiles of 1, 3, 1 and 1 row
    blocks); bins that change at every row block (every tile takes one
    pass per row block, the sentinel 16 among them) or one bin
    throughout (one pass)."""
    gen = torch.Generator(device=cuda).manual_seed(Kp)
    n = Kp // 16
    flat = torch.randn((2, Kp, 961), device=cuda, generator=gen).to(torch.bfloat16)
    if pattern == "every_block":
        ibin = (torch.arange(2 * n, device=cuda).reshape(2, n) * 7) % 17
    else:
        ibin = torch.full((2, n), 5, device=cuda)
    _k5_holds(flat, ibin.to(torch.int32).contiguous(), cuda)


def test_k5_sentinel_batch_of_one(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.randn((1, 144, 961), device=cuda, generator=gen).to(torch.bfloat16)
    ibin = torch.tensor([[16, 0, 0, 3, 3, 3, 16, 15, 2]], dtype=torch.int32, device=cuda)
    _k5_holds(flat, ibin, cuda)


def _k7_maps(n, shape, seed):
    """Affine maps about the centre (config 2's range), then: projective,
    g = 1e-30, h = -1e-30, a negative M[2, 2], a rotation beyond the
    residual bound, a centre shift beyond +-PAD and M[2, 2] = 0."""
    g = np.random.default_rng(seed)
    H, W = shape
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    M = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        th = g.uniform(-0.005, 0.005)
        A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        A = A @ (np.eye(2) + g.uniform(-0.002, 0.002, (2, 2)))
        M[i, :2, :2] = A
        M[i, :2, 2] = g.uniform(-6, 6, 2) + c - A @ c
    M[1, 2, :2] = [2e-6, -1.5e-6]
    M[2, 2, 0] = 1e-30
    M[3, 2, 1] = -1e-30
    M[4] *= -1.0
    th = 0.1
    M[5, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    M[5, :2, 2] = c - M[5, :2, :2] @ c
    M[6, 0, 2] += 140.5
    M[7, 2, 2] = 0.0
    return M.astype(np.float32)


@pytest.mark.parametrize("shape", [(120, 344), (96, 232), (80, 1000), (40, 2048)])
def test_k7_mixed_batch_bitwise(cuda, shape):
    """Affine and projective frames in one batch (the exact affine branch
    and the division path side by side), the g = 1e-30 frames on the
    division path, and frames out of the envelope zeroed and flagged,
    at the pyramid's widths and at 1000 and 2048."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    fr = torch.randn((9,) + shape, device=cuda, generator=gen)
    M = torch.as_tensor(_k7_maps(9, shape, shape[1]), device=cuda)
    out, ok = cuda_warp_matrix.warp_batch_matrix(fr, M, max_px=12)
    want, want_ok = cuda_warp_matrix.warp_batch_matrix_plain(fr, M, 12)
    assert ok.tolist() == want_ok.tolist()
    assert want_ok[[0, 1, 2, 3, 4, 8]].all() and not want_ok[5:8].any()
    assert float(out[5:8].abs().max()) == 0.0
    assert torch.equal(out, want)


def test_k5_rejects_unaligned_rows(cuda):
    """The kernel copies each row's k-slices in 16-byte chunks aligned
    down from the row's start, so `flat` itself must be 16-byte aligned."""
    base = torch.zeros((16 * 961 + 1,), dtype=torch.bfloat16, device=cuda)
    flat = base[1:].view(1, 16, 961)
    ibin = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned flat"):
        cuda_select.binned_select_rows(flat, ibin, sel_rot(cuda), 16)


def _k1_frames(n, shape, seed):
    """Noise with a flat quarter in the second frame (NMS ties, zero fits)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fr = torch.randn((n,) + shape, device="cuda", generator=gen)
    fr[1, : shape[0] // 2, : shape[1] // 2] = 0.0
    return fr


@pytest.mark.parametrize("shape", [(7, 9), (33, 65), (232, 232), (2048, 2048)])
@pytest.mark.parametrize("smooth_sigma", [None, 2.0])
@pytest.mark.parametrize("window_sigma", [1.2, 1.5, 2.5])
@pytest.mark.parametrize("nms_size", [3, 5, 7])
def test_k1_parameter_grid_bitwise(cuda, nms_size, window_sigma, smooth_sigma, shape):
    """K1 over its radii (window 4, 5, 8; blur none or 6; NMS reach 1-3),
    on frames smaller than one tile, widths that are not multiples of 4
    (the 4-byte staging path) and tiles on every frame edge."""
    fr = _k1_frames(2, shape, seed=shape[1] + nms_size)
    kw = dict(nms_size=nms_size, window_sigma=window_sigma, smooth_sigma=smooth_sigma)
    before = cuda_build.launch_counts()["detect_response"]
    got = cuda_detect.detect_response(fr, **kw)
    assert cuda_build.launch_counts()["detect_response"] == before + 1
    want = cuda_detect.detect_response_plain(fr, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_unaligned_frames_bitwise(cuda):
    """A frame batch that starts 4 bytes past a 16-byte boundary takes
    the 4-byte staging path at a width that is a multiple of 4."""
    flat = _k1_frames(2, (96, 160), seed=3).reshape(-1)
    buf = torch.empty(flat.numel() + 1, device="cuda")
    buf[1:] = flat
    fr = buf[1:].view(2, 96, 160)
    assert fr.is_contiguous() and fr.data_ptr() % 16 == 4
    for g, w in zip(cuda_detect.detect_response(fr, smooth_sigma=2.0),
                    cuda_detect.detect_response_plain(fr, smooth_sigma=2.0)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,grid,mp", [
    ((96, 120), (78, 78), 4),   # more cells than rows; a frame narrower than one strip
    ((203, 72), (8, 8), 6),     # 203 rows: the 32-row strips do not divide H
    ((61, 300), (6, 5), 18),    # canvas rows far outside each strip
])
def test_k8_strips_bitwise(cuda, shape, grid, mp):
    """K8 bit-identical with one launch per call, ok flags included, on
    fields inside the envelope and one frame beyond each bound."""
    gen = torch.Generator(device="cuda").manual_seed(shape[0])
    fr = torch.randn((4,) + shape, device="cuda", generator=gen)
    amp = mp - 1.5
    f = (torch.rand((4,) + grid + (2,), device="cuda", generator=gen) - 0.5) * (2 * amp)
    f[1] += torch.tensor([2.0, -1.0], device="cuda")
    f[2, 0] += mp + 1.0  # residual beyond the bound
    f[3] += 300.0  # mean beyond +-PAD
    f = f.contiguous()
    before = cuda_build.launch_counts()["warp_batch_field"]
    out, ok = cuda_warp_field.warp_batch_field(fr, f, max_px=mp)
    assert cuda_build.launch_counts()["warp_batch_field"] == before + 1
    want, want_ok = cuda_warp_field.warp_batch_field_plain(fr, f, mp)
    assert ok.tolist() == want_ok.tolist() == [True, True, False, False]
    assert float(out[2:].abs().max()) == 0.0
    assert torch.equal(out, want)


def _k9_vols(shape, seed):
    """Two volumes, the second with a flat corner (zero gradients)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn((2,) + shape, device="cuda", generator=gen)
    v[1, : shape[0] // 2, : shape[1] // 2] = 0.0
    return v.contiguous()


@pytest.mark.parametrize("shape", [(4, 40, 56), (24, 200, 136)])
@pytest.mark.parametrize("sr", [None, 1, 3, 5, 6])
@pytest.mark.parametrize("gr", [1, 3, 5, 6])
def test_k9_radius_grid_bitwise(cuda, gr, sr, shape):
    """K9 over its window and blur radii (blur off too, and blur radii
    below and above gr + 1), on volumes shallower than the window and
    whose H and W are no multiples of the tile: one launch, both fields
    bit-identical (by bits, so +0.0 and -0.0 too)."""
    v = _k9_vols(shape, seed=shape[1] + gr)
    ws, ss = gr / 3.0, (None if sr is None else sr / 3.0)
    before = cuda_build.launch_counts()["response_fields_3d"]
    got = cuda_detect3d.response_fields_3d(v, window_sigma=ws, smooth_sigma=ss)
    assert cuda_build.launch_counts()["response_fields_3d"] == before + 1
    want = cuda_detect3d.response_fields_3d_plain(v, window_sigma=ws, smooth_sigma=ss)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if sr is None:
        assert got[1] is None
    else:
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("K", [1, 13, 300])
@pytest.mark.parametrize("P", [16, 28, 32, 64])
def test_k2_k6_patch_sizes_bitwise(cuda, P, K):
    """K2 and K6 (P >= 17) at the specialised sides and the general one,
    on an odd Wp, a frame batch 2 bytes past a 16-byte boundary, K not a
    multiple of the keypoints per block, keypoints in the edge-clamped
    band and windows of +0.0 and -0.0: patches as bf16 bits, K6's
    patches equal to K2's, moments by bits."""
    gen = torch.Generator(device=cuda).manual_seed(P * 1000 + K)
    B, Hp, Wp = 2, 150, 211
    flat = torch.randn(B * Hp * Wp + 1, device=cuda, generator=gen).to(torch.bfloat16)
    padded = flat[1:].view(B, Hp, Wp)
    padded[0, :40] = 0.0
    padded[1, :40] = -0.0
    assert padded.is_contiguous() and padded.data_ptr() % 16 == 2
    xy = (torch.rand((B, K, 2), device=cuda, generator=gen)
          * torch.tensor([Wp + 2.0 * P, Hp + 2.0 * P], device=cuda) - P).contiguous()
    xy[0, 0] = torch.tensor([5.5, 3.25], device=cuda)  # a window from the zero band
    before = cuda_build.launch_counts()["extract_blended"]
    k2 = cuda_patch.extract_blended(padded, xy, P)
    assert cuda_build.launch_counts()["extract_blended"] == before + 1
    assert torch.equal(k2.view(torch.int16),
                       cuda_patch.extract_blended_plain(padded, xy, P).view(torch.int16))
    if P < 17:
        return
    got = cuda_patch.extract_blended(padded, xy, P, with_moments=True)
    want = cuda_patch.extract_blended_plain(padded, xy, P, with_moments=True)
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[0].view(torch.int16), k2.view(torch.int16))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("shape", [(15, 15), (16, 600), (230, 301), (544, 544), (1038, 1038)])
@pytest.mark.parametrize("B", [1, 33])
def test_k4_shapes_bitwise(cuda, B, shape):
    """K4 from a 1x1 map to 1024^2, partial tiles on both axes, B past 32;
    the last frame of +-0.0 with a constant region: both maps by bits, one
    counted launch."""
    gen = torch.Generator(device=cuda).manual_seed(B * 10000 + shape[1])
    f = torch.randn((B,) + shape, device=cuda, generator=gen)
    z = torch.where(f[-1].abs() < 1.0, torch.copysign(torch.zeros_like(f[-1]), f[-1]), f[-1])
    z[: shape[0] // 2, : shape[1] // 2] = 1.75
    f[-1] = z
    padded = f.to(torch.bfloat16)
    before = cuda_build.launch_counts()["moment_maps"]
    got = cuda_moments.moment_maps(padded)
    assert cuda_build.launch_counts()["moment_maps"] == before + 1
    want = cuda_moments.moment_maps_plain(padded)
    for g, w in zip(got, want):
        assert g.shape == (B, shape[0] - 14, shape[1] - 14)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("thin", [False, True])
@pytest.mark.parametrize("K", [1, 13, 512])
@pytest.mark.parametrize("Pz,Pxy", [(8, 20), (2, 2), (5, 13), (16, 33)])
def test_k10_sizes_bitwise(cuda, Pz, Pxy, K, thin):
    """K10 at the template size and three general ones; keypoints inside,
    at negative coordinates and past every far edge; a padded volume
    thinner than a slab (Dp < Pz); patches by bits, one counted launch."""
    gen = torch.Generator(device=cuda).manual_seed(Pz * 1000 + Pxy * 10 + K)
    B = 2
    Dp = max(Pz - 1, 1) if thin else 3 * Pz + 5
    Hp, Wp = 2 * Pxy + 11, 3 * Pxy + 7
    padded = torch.randn((B, Dp, Hp, Wp), device=cuda, generator=gen) * 100.0
    padded[1, :, : Hp // 2] = -0.0
    span = torch.tensor([Wp + 2.0 * Pxy, Hp + 2.0 * Pxy, Dp + 2.0 * Pz], device=cuda)
    lo = torch.tensor([Pxy, Pxy, Pz], device=cuda, dtype=torch.float32)
    xyz = torch.rand((B, K, 3), device=cuda, generator=gen) * span - lo
    xyz[0, 0] = torch.tensor([Wp / 2 - Pxy / 2, Hp / 2 - Pxy / 2, 0.5], device=cuda)
    xyz[1, -1] = torch.tensor([Wp - 0.25, -2.5, Dp + 0.75], device=cuda)
    xyz = xyz.contiguous()
    before = cuda_build.launch_counts()["extract_blended_3d"]
    got = cuda_patch3d.extract_blended_3d(padded, xyz, Pz, Pxy)
    assert cuda_build.launch_counts()["extract_blended_3d"] == before + 1
    want = cuda_patch3d.extract_blended_3d_plain(padded, xyz, Pz, Pxy)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# routes beyond K8's and K9's limits; the banded matcher


def test_k8_k9_raise_beyond_their_limits_on_card(cuda):
    """K8 raises for more than 6144 cells and K9 for a blur radius above
    6 on CUDA tensors: no launch, no quiet fallback."""
    fr = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="6144"):
        cuda_warp_field.warp_batch_field(fr, torch.zeros((1, 80, 80, 2), device=cuda))
    with pytest.raises(ValueError, match="max_px"):
        cuda_warp_field.warp_batch_field(fr, torch.zeros((1, 8, 8, 2), device=cuda), max_px=1025)
    vols = torch.zeros((1, 16, 32, 32), device=cuda)
    with pytest.raises(ValueError, match="radius above 6"):
        cuda_detect3d.response_fields_3d(vols, smooth_sigma=3.0)
    with pytest.raises(ValueError, match="radius above 6"):
        cuda_detect3d.response_fields_3d(vols, window_sigma=2.5)


def test_wide_grid_and_wide_blur_take_their_routes_on_card(cuda):
    """A 6400-cell piecewise grid takes the flow route and a blur_sigma
    of 3.0 the plain detection route, on the card: K8 and K9 are not
    launched, the other kernels are, and the results agree with the CPU
    route (fields within 1e-3 px RMSE; rigid3d transforms within 1e-3)."""
    data = make_piecewise_stack(2, (128, 128), seed=0)
    kw = dict(model="piecewise", batch_size=2, patch_grid=(80, 80), max_keypoints=128,
              n_hypotheses=32, patch_hypotheses=8, refine_hypotheses=4, field_polish=1,
              field_passes=2)
    cuda_build.reset_launches()
    on_card = MotionCorrector(**kw).correct(data.stack)
    counts = cuda_build.launch_counts()
    assert counts["warp_batch_field"] == 0 and counts["extract_blended"] == 2
    on_cpu = MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert np.sqrt(np.mean(np.sum((on_card.fields - on_cpu.fields) ** 2, -1))) <= 1e-3

    vols = make_drift_stack_3d(4, (16, 64, 64), seed=2)
    kw = dict(model="rigid3d", batch_size=2, max_keypoints=256, blur_sigma=3.0)
    cuda_build.reset_launches()
    on_card = MotionCorrector(**kw).correct(vols.stack)
    counts = cuda_build.launch_counts()
    assert counts["response_fields_3d"] == 0 and counts["extract_blended_3d"] == 3
    on_cpu = MotionCorrector(device="cpu", **kw).correct(vols.stack)
    assert _px3(on_card.transforms, on_cpu.transforms, (16, 64, 64)) <= 1e-3


@pytest.mark.parametrize("radius,slack", [(6.0, 2.0), (20.0, 2.0), (12.0, 1.0)])
def test_banded_match_on_card_equals_cpu(cuda, radius, slack):
    """The banded matcher on the card gives the CPU's indices, distances
    and flags exactly, on the keypoints and descriptors of a real
    detect + describe (config 2's settings at 256x256)."""
    from kcmc_tpu_torch.ops import match_banded

    data = make_drift_stack(3, (256, 256), model="affine", seed=0, sigma_range=(0.7, 1.4))
    be = TorchBackend(CorrectorConfig(model="affine", max_keypoints=1024, nms_size=3,
                                      harris_window_sigma=1.2, cand_tile=4), device=cuda)
    ref = be.prepare_reference(data.stack[0])
    kps, desc = be._detect_describe(torch.as_tensor(data.stack[1:], device=cuda))
    geom = match_banded.make_geometry((256, 256), radius, 1024, 1024, slack=slack, nms_tile=4)

    def run(dev):
        bref = match_banded.build_banded_ref(geom, ref["xy"].to(dev), ref["desc"].to(dev),
                                             ref["valid"].to(dev))
        return match_banded.banded_match(geom, bref, desc.to(dev), kps.xy.to(dev),
                                         kps.valid.to(dev))

    card, cpu = run(cuda), run("cpu")
    for f in ("idx", "dist", "second", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.valid.sum()) > 100


@pytest.mark.parametrize("model,shape,K", [("translation", (512, 512), 512),
                                           ("homography", (512, 512), 512)])
def test_k11_float32_route_bitwise(cuda, model, shape, K):
    """The float32 describe route at config 1's and config 4's shapes:
    K11 on the run's own padded mean-removed blur and keypoints,
    bit-identical to its plain version, and the route's words equal on
    card and CPU (the same K11 windows, the same plain torch after)."""
    data = make_drift_stack(4, shape, model=model, seed=0)
    fr = torch.as_tensor(data.stack, device=cuda)
    kps, smooth = detect_keypoints_batch(fr, max_keypoints=K, threshold=1e-4, smooth_sigma=2.0)
    oriented = model != "translation"
    windows = D.float32_windows(D.centre_finite(smooth), kps.xy, oriented)
    before = cuda_build.launch_counts()["extract_patches"]
    got = cuda_patch.extract_patches(*windows)
    assert cuda_build.launch_counts()["extract_patches"] == before + 1
    assert torch.equal(got, cuda_patch.extract_patches_plain(*windows))
    card = D.describe_keypoints_batch(fr, kps, smooth=smooth, oriented=oriented,
                                      precision="float32")
    cpu_kps = type(kps)(*(t.cpu() for t in kps))
    cpu = D.describe_keypoints_batch(fr.cpu(), cpu_kps, smooth=smooth.cpu(),
                                     oriented=oriented, precision="float32")
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("kind", ["matrix", "fields"])
def test_fast_apply_on_card_matches_gather(cuda, kind):
    """apply_correction's batch warps on the card: K7 (max_px 16) or K8
    (max_px 6) launched once, the flagged frame exactly the gather's,
    the frames kept equal to the CPU's kernel route (the plain
    versions) and near the gather: K7 within 1e-3 of max|frame| (its
    ~1e-4 px on affine maps; 4.2e-4 on these), K8 within 5e-3 (the
    two-pass field warp's O(|grad u|^2) term; 3.1e-3 on these)."""
    from kcmc_tpu_torch.ops import warp as W
    from kcmc_tpu_torch.ops.piecewise import upsample_field

    fr = torch.as_tensor(_stack(3, (256, 256)).stack, device=cuda)
    gen = np.random.default_rng(0)
    if kind == "matrix":
        M = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
        M[:, :2, 2] = gen.uniform(-6, 6, (3, 2))
        M[:, :2, :2] += gen.normal(0, 0.01, (3, 2, 2)).astype(np.float32)
        M[1, :2, :2] = [[np.cos(0.5), -np.sin(0.5)], [np.sin(0.5), np.cos(0.5)]]
        maps = torch.as_tensor(M, device=cuda)
        name, gather = "warp_batch_matrix", W.warp_batch(fr, maps)
        before = cuda_build.launch_counts()[name]
        got = W.fast_apply_matrix(fr, maps)
    else:
        f = gen.uniform(-2, 2, (3, 8, 8, 2)).astype(np.float32)
        f[1, :4] += 9.0
        f[1, 4:] -= 9.0
        maps = torch.as_tensor(f, device=cuda)
        name = "warp_batch_field"
        gather = W.warp_frame_flow(fr, upsample_field(maps, (256, 256)))
        before = cuda_build.launch_counts()[name]
        got = W.fast_apply_fields(fr, maps)
    assert cuda_build.launch_counts()[name] == before + 1
    assert torch.equal(got[1], gather[1])
    apply = W.fast_apply_matrix if kind == "matrix" else W.fast_apply_fields
    cpu = apply(fr.cpu(), maps.cpu(), force_kernel=True)
    assert torch.equal(got.cpu()[[0, 2]], cpu[[0, 2]])
    scale = float(fr.abs().max())
    limit = 1e-3 if kind == "matrix" else 5e-3
    assert float((got - gather)[[0, 2]].abs().max()) <= limit * scale


def test_device_stack_with_device_outputs(cuda):
    """A CUDA stack with device_outputs: CUDA tensors back, transforms
    equal to the host run's, and the frames with warp_ok equal too."""
    data = _stack(8, (128, 128), seed=2)
    mc = MotionCorrector(batch_size=4)
    host = mc.correct(data.stack)
    dev = mc.correct(torch.as_tensor(data.stack, device=cuda), device_outputs=True)
    assert dev.corrected.is_cuda and dev.transforms.is_cuda
    assert np.array_equal(dev.transforms.cpu().numpy(), host.transforms)
    ok = dev.diagnostics["warp_ok"].cpu().numpy()
    assert np.array_equal(dev.corrected.cpu().numpy()[ok], host.corrected[ok])


def test_selftest_every_record_ok(cuda):
    """`python -m kcmc_tpu_torch.selftest`'s checks: every hand kernel
    (K1-K11) against its plain version at production sizes, the warps
    against the gather, the match against XOR + popcount and a rigid
    warp="auto" run against the gather warp, all ok."""
    from kcmc_tpu_torch.selftest import run_selftest

    results = run_selftest()
    names = " ".join(r["name"] for r in results)
    for k in range(1, 12):
        assert f"K{k} " in names
    assert [r for r in results if not r["ok"]] == []


def test_honest_time_reads_cuda_event_time(cuda):
    """honest_time on the card is CUDA-event time: a kernel that spins
    the card for 4e6 clock cycles (~2 ms at the H100's 1.98 GHz) reads
    milliseconds per call, though its launch returns at once."""
    from kcmc_tpu_torch.utils.profiling import honest_time

    t = honest_time(torch.cuda._sleep, 4_000_000, iters=10, min_warmup_s=0.05)
    host = honest_time(lambda: None, iters=10, min_warmup_s=0.0, device="cpu")
    assert 5e-4 < t < 0.05
    assert host < t


@pytest.mark.parametrize("model,shape,bucket,tol", [
    ("translation", (50, 70), (64, 80), 1e-4),
    ("affine", (100, 120), (128, 128), 1e-3),
])
def test_bucketed_batch_on_card_matches_cpu_route(cuda, model, shape, bucket, tol):
    """A bucket-padded run (execution plans) on the card: K1, K2 or K6,
    and K3 or K7 on the bucket canvas, against the same bucketed run
    through the plain versions on the CPU, at the card-vs-CPU tolerances
    of the unbucketed slices above."""
    data = make_drift_stack(8, shape, model=model, max_drift=5.0, seed=1)
    kw = dict(model=model, batch_size=4, max_keypoints=128, plan_buckets=(bucket,))
    warp = "warp_translation" if model == "translation" else "warp_batch_matrix"
    before = cuda_build.launch_counts()[warp]
    mc = MotionCorrector(**kw)
    on_card = mc.correct(data.stack)
    assert cuda_build.launch_counts()[warp] > before
    on_cpu = MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert np.abs(on_card.transforms - on_cpu.transforms).max() <= tol
    assert np.abs(on_card.diagnostics["n_inliers"] - on_cpu.diagnostics["n_inliers"]).max() <= (
        0 if model == "translation" else 2)
    assert on_card.corrected.shape == data.stack.shape
    pc, pc_cpu = on_card.timing["plan_cache"], on_cpu.timing["plan_cache"]
    assert pc["bucket_padded"] == pc_cpu["bucket_padded"] == 2


def test_warmup_on_card_second_backend_builds_nothing(cuda, tmp_path):
    """warmup in a fresh cache directory builds the kernel libraries
    there and stamps every program; a second corrector on the same
    directory reports zero stamp misses and runs no nvcc."""
    from kcmc_tpu_torch.plans.cache import disable_compile_cache

    kw = dict(batch_size=4, max_keypoints=64, plan_buckets=((64, 80),),
              compile_cache_dir=str(tmp_path / "cache"))
    try:
        w1 = MotionCorrector(**kw).warmup(dtypes=("float32", "uint16"))
        # reference, register x 2 and apply; the uint16 cast (which
        # correct() runs for integer outputs) is stamped too
        assert (w1["programs_built"], w1["stamp_misses"]) == (4, 5)
        assert set(w1["libraries"]) == {"detect", "patch", "warp", "warp_matrix"}
        assert str(cuda_build.lib_dir()).startswith(str(tmp_path))
        runs = cuda_build.NVCC_RUNS
        w2 = MotionCorrector(**kw).warmup(dtypes=("float32", "uint16"))
        assert w2["stamp_misses"] == 0
        assert w2["stamp_hits"] == w1["stamp_hits"] + w1["stamp_misses"]
        assert all(v["cached"] for v in w2["libraries"].values())
        assert cuda_build.NVCC_RUNS == runs
        # with the libraries wiped, warmup rebuilds them and every program
        # that launches one misses its stamp; the cast launches none
        for lib in cuda_build.lib_dir().glob("*.so"):
            lib.unlink()
        w3 = MotionCorrector(**kw).warmup(dtypes=("float32", "uint16"))
        assert (w3["stamp_misses"], w3["stamp_hits"]) == (4, 1)
        assert cuda_build.NVCC_RUNS == runs + 4
    finally:
        disable_compile_cache()


def test_staging_slot_refilled_only_after_its_copy_event(cuda):
    """Eight uint16 batches staged back to back through the three-slot
    pinned ring, with no sync between them: every slot handed out for a
    refill has its previous copy's event complete, every staged tensor
    holds its own batch, and the slots are pinned."""
    be = TorchBackend(CorrectorConfig(), device="cuda")
    ring = be._staging
    done_at_refill = []
    orig = ring.acquire

    def acquire(shape, dtype):
        slot = orig(shape, dtype)
        done_at_refill.append(slot.event is None or slot.event.query())
        return slot

    ring.acquire = acquire
    batches = [np.full((32, 512, 512), i + 1, np.uint16) for i in range(8)]
    staged = [be.stage_upload(b) for b in batches]
    got = [s.take(torch.cuda.current_stream()) for s in staged]
    torch.cuda.synchronize()
    assert done_at_refill == [True] * 8
    for i, g in enumerate(got):
        assert g.device.type == "cuda" and g.dtype == torch.uint16
        g = g.to(torch.int32)  # CUDA has no uint16 min/max
        assert int(g.min()) == int(g.max()) == i + 1
    slots = ring._slots[((32, 512, 512), torch.uint16)]
    assert len(slots) == 3
    assert all(s.buf.is_pinned() for s in slots)


def test_downloads_are_pinned_and_materialized_at_drain(cuda):
    """process_batch_async starts the downloads into pooled pinned
    buffers; to_host waits on their event and returns the arrays the
    device outputs hold, and the buffers go back to the pool."""
    data = make_drift_stack(8, (128, 128), seed=2)
    be = TorchBackend(CorrectorConfig(batch_size=8, max_keypoints=128), device="cuda")
    ref = be.prepare_reference(data.stack[0])
    out = be.process_batch_async(data.stack, ref, np.arange(8))
    assert out.download is not None
    assert all(b.is_pinned() for b in out.download.bufs.values())
    host = be.to_host(out)
    for k, v in out.items():
        np.testing.assert_array_equal(host[k], v.cpu().numpy())
    assert out.download.bufs == {} and be._downloads._free


def test_overlap_on_card_byte_identical(cuda):
    """correct() with upload_overlap on and off on the card: the same
    bytes, and the pipeline report of the staged run."""
    data = make_drift_stack(40, (128, 128), seed=4)
    u16 = np.clip(data.stack * 40000, 0, 65535).astype(np.uint16)
    kw = dict(batch_size=8, max_keypoints=128)
    for stack in (data.stack, u16):
        on = MotionCorrector(**kw).correct(stack, output_dtype="input")
        off = MotionCorrector(upload_overlap=False, **kw).correct(stack, output_dtype="input")
        np.testing.assert_array_equal(on.corrected, off.corrected)
        np.testing.assert_array_equal(on.transforms, off.transforms)
        assert on.timing["pipeline"]["upload_overlap"] is True
        assert on.timing["pipeline"]["upload_waits"] == 4


def test_mesh_shard_runs_on_its_own_device(cuda):
    """Each shard of a mesh runs its program with its own card current
    and its tensors there (a two-shard mesh on cuda:0 where there is one
    card, cuda:0 and cuda:1 where there are two); the sharded run
    matches the single-device run (integers equal, transforms within
    1e-4 px)."""
    n = torch.cuda.device_count()
    mesh = (torch.device("cuda", 0), torch.device("cuda", 1 if n > 1 else 0))
    data = make_drift_stack(16, (128, 128), seed=5)
    kw = dict(batch_size=8, max_keypoints=100)
    one = MotionCorrector(**kw).correct(data.stack)
    mc = MotionCorrector(mesh=mesh, **kw)
    seen = []
    orig = mc.backend._local_program

    def spy(*a):
        frames = a[3]
        seen.append((torch.cuda.current_device(), frames.device.index))
        return orig(*a)

    mc.backend._local_program = spy
    mc.backend._batch_fns.clear()
    got = mc.correct(data.stack)
    assert seen == [(d.index, d.index) for d in mesh] * 2
    assert np.abs(got.transforms - one.transforms).max() <= 1e-4
    for k in ("n_keypoints", "n_matches", "n_inliers", "warp_ok"):
        np.testing.assert_array_equal(got.diagnostics[k], one.diagnostics[k])


def test_traced_run_on_card_leaves_outputs_and_launches_equal(cuda, tmp_path):
    """Config 1 (512², K=512, batch 32), 64 frames, with trace_path,
    frame_records_path and a heartbeat armed: the corrected frames'
    sha256, the transforms and the kernel launches equal the untraced
    run's (telemetry synchronizes nothing and launches nothing), and the
    artifacts hold two dispatch_batch spans and 64 records."""
    import hashlib
    import json

    from kcmc_tpu_torch.obs.records import read_jsonl

    data = make_drift_stack(64, (512, 512), model="translation", seed=0)
    got = {}
    for tag, kw in (("off", {}), ("on", dict(trace_path=str(tmp_path / "t.json"),
                                             frame_records_path=str(tmp_path / "r.jsonl"),
                                             heartbeat_s=0.5))):
        mc = MotionCorrector(model="translation", rescue_escalate=False, **kw)
        mc.correct(data.stack[:32])  # the first builds, outside the counts
        torch.cuda.synchronize()
        mc.backend.reset_launch_counts()
        res = mc.correct(data.stack)
        torch.cuda.synchronize()
        got[tag] = (hashlib.sha256(res.corrected.tobytes()).hexdigest(), res.transforms,
                    mc.backend.launch_counts())
    assert got["on"][0] == got["off"][0] and got["on"][2] == got["off"][2]
    np.testing.assert_array_equal(got["on"][1], got["off"][1])
    assert got["on"][2]["detect_response"] == 3 and got["on"][2]["warp_translation"] == 4
    names = [e["name"] for e in json.load(open(tmp_path / "t.json"))["traceEvents"]]
    assert names.count("dispatch_batch") == 2 and names.count("upload.stage") == 1
    assert len(read_jsonl(str(tmp_path / "r.jsonl"))[1]) == 64


def test_cli_correct_on_card_equals_the_in_process_run(cuda, tmp_path):
    """`python -m kcmc_tpu_torch correct` in a child process on the card
    (128², uint16 TIFF, --transforms): its transforms equal an in-process
    card correct_file of the same file bit for bit, and its summary
    names the torch backend."""
    import json
    import os
    import subprocess
    import sys

    from kcmc_tpu_torch.io import write_stack

    data = make_drift_stack(48, (128, 128), model="translation", seed=0)
    src, npz = str(tmp_path / "s.tif"), str(tmp_path / "t.npz")
    write_stack(src, np.clip(data.stack * 40000, 0, 65535).astype(np.uint16))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", "kcmc_tpu_torch", "correct", src, "--transforms", npz,
         "--batch-size", "16"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["backend"] == "torch" and summary["warp_flagged_frames"] == 0
    res = MotionCorrector(batch_size=16).correct_file(src, emit_frames=False)
    np.testing.assert_array_equal(np.load(npz)["transforms"], res.transforms)


def _serve_kw():
    return dict(model="translation", batch_size=8, max_keypoints=256)


def test_serve_two_sessions_on_card_equal_correct(cuda):
    """Two client threads through a cuda ServeServer: each session's
    transforms equal a one-shot correct() of its frames on the card
    (integers equal), and the sessions launched the kernels."""
    import threading

    from kcmc_tpu_torch.serve.client import ServeClient
    from kcmc_tpu_torch.serve.server import ServeServer

    parts = {k: make_drift_stack(n, (256, 256), seed=s).stack.astype(np.float32)
             for k, n, s in (("A", 40, 0), ("B", 27, 1))}
    truth = {k: MotionCorrector(**_serve_kw()).correct(v) for k, v in parts.items()}
    out = {}

    def drive(port, k):
        with ServeClient(port=port) as c:
            sid = c.open_session(tenant=k)
            for lo in range(0, len(parts[k]), 13):
                c.submit(sid, parts[k][lo:lo + 13])
            out[k] = c.close_session(sid)

    with ServeServer(MotionCorrector(**_serve_kw()), port=0) as srv:
        before = cuda_build.launch_counts()["warp_translation"]
        ts = [threading.Thread(target=drive, args=(srv.port, k)) for k in parts]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
    assert cuda_build.launch_counts()["warp_translation"] > before
    for k in parts:
        assert np.abs(out[k]["transforms"] - truth[k].transforms).max() <= 1e-4
        for d in ("n_keypoints", "n_matches", "n_inliers"):
            np.testing.assert_array_equal(out[k]["diagnostics"][d], truth[k].diagnostics[d])


def test_serve_drain_to_host_without_frames_on_card(cuda):
    """A registration-only batch (emit_frames=False) downloads no
    corrected frames; to_host at drain materializes the rest, equal to
    the emitting batch's."""
    b = TorchBackend(CorrectorConfig(**_serve_kw()), device=cuda)
    st = make_drift_stack(8, (256, 256), seed=2).stack.astype(np.float32)
    ref = b.prepare_reference(st[0])
    reg = b.process_batch_async(st, ref, np.arange(8), emit_frames=False)
    full = b.process_batch_async(st, ref, np.arange(8))
    assert "corrected" not in reg.download.bufs and "corrected" in full.download.bufs
    got, want = b.to_host(reg), b.to_host(full)
    assert set(want) - set(got) == {"corrected"}
    for k, v in got.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, want[k])


def test_serve_inflight_one_equals_default_window_on_card(cuda):
    """The corrected frames of an emitting session through the default
    window (three batches in flight on the pooled pinned downloads) and
    through serve_inflight=1 have one sha256."""
    import hashlib

    from kcmc_tpu_torch.serve.scheduler import StreamScheduler

    st = make_drift_stack(64, (256, 256), seed=3).stack.astype(np.float32)
    digests = []
    for depth in (3, 1):
        sched = StreamScheduler(MotionCorrector(serve_inflight=depth, **_serve_kw())).start()
        try:
            s = sched.open_session(emit_frames=True)
            for lo in range(0, 64, 24):
                sched.submit(s.sid, st[lo:lo + 24])
            res = sched.close_session(s.sid, timeout=300)
        finally:
            sched.stop()
        assert res.corrected.shape == st.shape
        digests.append(hashlib.sha256(res.corrected.tobytes()).hexdigest())
    assert digests[0] == digests[1]


def test_serve_fatal_dispatch_error_fails_the_stream_on_card(cuda, monkeypatch):
    """A kernel that cannot be built or launched fails its session's
    stream on the card (close_session raises it) although the default
    CPU failover rung is configured: no batch reruns on the CPU, the
    backend is not quarantined, and the next session runs the kernels."""
    from kcmc_tpu_torch.serve.scheduler import StreamScheduler

    orig = TorchBackend.process_batch_async
    fired = []

    def flaky(self, *a, **k):
        if not fired:
            fired.append(self)
            raise RuntimeError("cannot build or load detect.so")
        return orig(self, *a, **k)

    monkeypatch.setattr(TorchBackend, "process_batch_async", flaky)
    st = make_drift_stack(16, (256, 256), seed=4).stack.astype(np.float32)
    sched = StreamScheduler(MotionCorrector(serve_degrade_watermark=1.0, **_serve_kw())).start()
    try:
        s = sched.open_session(tenant="fatal")
        sched.submit(s.sid, st)
        with pytest.raises(RuntimeError, match="cannot build or load detect.so"):
            sched.close_session(s.sid, timeout=300)
        before = cuda_build.launch_counts()["detect_response"]
        ok = sched.open_session(tenant="after")
        sched.submit(ok.sid, st)
        res = sched.close_session(ok.sid, timeout=300)
        st_ = sched.stats()
    finally:
        sched.stop()
    assert str(fired[0].device).startswith("cuda")
    assert st_["supervisor"]["backend_rebuilds"] == 0
    # a build error leaves the context usable: the probe finds it alive
    assert st_["supervisor"]["device_lost"] is False
    assert st_["supervisor"]["failed_sessions"] == [s.sid]
    assert cuda_build.launch_counts()["detect_response"] > before
    assert res.timing["robustness"]["backend_failovers"] == 0


def test_fleet_router_over_two_card_servers_and_a_graceful_migration(cuda, tmp_path):
    """Two in-process ServeServers on the card behind a FleetRouter: a
    64-frame stream equals a one-shot correct() of its frames on the
    card; a second stream whose replica is stopped mid-stream (it
    journals, then dies) migrates to the survivor and finishes within
    1e-4 px of correct(), with one `fleet.migrate` span."""
    import os
    import time

    from kcmc_tpu_torch.serve.client import ServeClient
    from kcmc_tpu_torch.serve.fleet import Replica
    from kcmc_tpu_torch.serve.journal import journal_path, load_session_journal
    from kcmc_tpu_torch.serve.router import FleetRouter
    from kcmc_tpu_torch.serve.server import ServeServer

    jdir = str(tmp_path / "journals")
    st = make_drift_stack(64, (256, 256), seed=5).stack.astype(np.float32)
    truth = MotionCorrector(**_serve_kw()).correct(st)
    servers = [ServeServer(MotionCorrector(serve_journal_dir=jdir, serve_journal_every=8,
                                           **_serve_kw()), port=0).start() for _ in range(2)]
    reps = [Replica("127.0.0.1", s.port) for s in servers]
    router = FleetRouter(reps, port=0, config=CorrectorConfig(fleet_probe_interval_s=0.5),
                         journal_dir=jdir).start()
    try:
        with ServeClient(port=router.port) as c:
            sid = c.open_session(tenant="whole", session_id="gpu-P")
            for lo in range(0, 64, 16):
                c.submit(sid, st[lo:lo + 16])
            whole = c.close_session(sid)
            sid = c.open_session(tenant="moved", session_id="gpu-M")
            c.submit(sid, st[:32])
            t0 = time.monotonic()
            jp = journal_path(jdir, sid)
            while True:
                got = load_session_journal(jp) if os.path.exists(jp) else None
                if got and int(got[0]["done"]) >= 16:
                    break
                assert time.monotonic() - t0 < 120, "journal never became durable"
                time.sleep(0.05)
            victim = router.stats()["sessions"][sid]
            servers[[r.rid for r in reps].index(victim)].stop()
            c.submit(sid, st[32:])
            moved = c.close_session(sid)
        stats = router.stats()
        mig = router.fleet_metrics()["plane"]["totals"]["fleet.migrate"]
    finally:
        router.stop()
        for s in servers:
            s.stop()
    np.testing.assert_array_equal(whole["transforms"], truth.transforms)
    for d in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(whole["diagnostics"][d], truth.diagnostics[d])
    assert moved["frames"] == 64
    assert np.abs(moved["transforms"] - truth.transforms).max() <= 1e-4
    assert stats["migrations_total"] == 1 and mig["count"] == 1
