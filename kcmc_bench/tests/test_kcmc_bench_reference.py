"""The reference's frozen copies give the port's own results (CPU):
the registration of a frame against the port's NumPy oracle, the
Hamming distances against the popcount of the XOR, and the warps
against the port's plain versions of K7 and K8 and its gather warps."""

import numpy as np
import pytest
import torch

from kcmc_bench.reference import np_kernels, oracle, warps
from kcmc_tpu_torch.backends import _np_kernels as port_kernels
from kcmc_tpu_torch.backends.numpy_backend import NumpyBackend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.ops import cuda_warp_field, cuda_warp_matrix, piecewise
from kcmc_tpu_torch.ops import warp as port_warp
from kcmc_tpu_torch.utils.synthetic import make_drift_stack, make_piecewise_stack


def test_hamming_is_the_popcount():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 2**32, (70, 8), dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    want = np.bitwise_count(q[:, None, :] ^ r[None, :, :]).sum(-1).astype(np.int64)
    assert np.array_equal(np_kernels._hamming(q, r), want)


def settings_of(cfg: CorrectorConfig) -> oracle.Settings:
    names = ("model", "max_keypoints", "detect_threshold", "nms_size", "border", "harris_k",
             "harris_window_sigma", "cand_tile", "oriented", "blur_sigma", "ratio",
             "max_hamming", "mutual", "patch_grid", "patch_hypotheses", "refine_hypotheses",
             "patch_model", "patch_prior", "field_smooth_sigma", "field_passes",
             "refine_reach_scale", "global_threshold", "field_polish", "n_hypotheses",
             "inlier_threshold", "refine_iters", "seed", "transform_polish", "polish_grid")
    return oracle.Settings({k: getattr(cfg, k) for k in names})


@pytest.mark.parametrize("model", ["affine", "piecewise"])
def test_register_matches_the_port_oracle(model):
    if model == "piecewise":
        data = make_piecewise_stack(n_frames=3, shape=(128, 128), seed=2)
        cfg = CorrectorConfig(model="piecewise", patch_grid=(4, 4))
        key = "field"
    else:
        data = make_drift_stack(n_frames=3, shape=(96, 96), model="affine", seed=2)
        cfg = CorrectorConfig(model="affine", max_keypoints=256)
        key = "transform"
    backend = NumpyBackend(cfg)
    want = backend.process_batch(data.stack[1:], backend.prepare_reference(data.stack[0]),
                                 np.arange(1, 3))
    s = settings_of(cfg)
    ref = oracle.prepare_reference(data.stack[0], s)
    for j, i in enumerate((1, 2)):
        got = oracle.register(data.stack[i], i, ref, s)
        assert got[key].tobytes() == want[key][j].tobytes()
        assert got["corrected"].tobytes() == want["corrected"][j].tobytes()
        assert got["n_matches"] == want["n_matches"][j]


def test_bf16_control_rounds_what_it_stores():
    data = make_drift_stack(n_frames=2, shape=(96, 96), model="affine", seed=4)
    s = settings_of(CorrectorConfig(model="affine", max_keypoints=256))
    low = oracle.register(data.stack[1], 1, oracle.prepare_reference(data.stack[0], s, True),
                          s, lowp=True)
    for k in ("transform", "corrected"):
        assert np.array_equal(low[k], np_kernels.bf16_round(low[k]))
    assert np.array_equal(np_kernels.bf16_round(data.stack[1]),
                          port_kernels.bf16_round(data.stack[1]))


def frames_and_maps(B=3, H=70, W=90, seed=0):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand((B, H, W), generator=g)
    M = torch.eye(3).repeat(B, 1, 1)
    M[:, :2, :2] += (torch.rand((B, 2, 2), generator=g) - 0.5) * 0.04
    M[:, :2, 2] = (torch.rand((B, 2), generator=g) - 0.5) * 12.0
    M[1, 2, :2] = torch.tensor([1e-5, -2e-5])
    M[2, 0, 2] = 140.5  # beyond the window: zeroed and flagged
    return frames, M


def test_warps_match_the_port():
    frames, M = frames_and_maps()
    got, ok = warps.warp_matrix(frames, M, 12)
    want, want_ok = cuda_warp_matrix.warp_batch_matrix_plain(frames, M, 12)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    assert torch.equal(warps.warp_gather(frames, M), port_warp.warp_batch(frames, M))
    g = torch.Generator().manual_seed(1)
    fields = ((torch.rand((3, 8, 8, 2), generator=g) - 0.5) * 6.0).contiguous()
    got, ok = warps.warp_field(frames, fields, 6)
    want, want_ok = cuda_warp_field.warp_batch_field_plain(frames, fields, 6)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    flows = piecewise.upsample_field(fields, (70, 90))
    assert torch.equal(warps.upsample_field(fields, (70, 90)), flows)
    assert torch.equal(warps.warp_flow(frames, fields), port_warp.warp_frame_flow(frames, flows))


def test_matrix_resid_px_matches_the_port():
    from kcmc_tpu_torch.backends.torch_backend import TorchBackend

    for shape, extra in (((512, 512), {}), ((1024, 1024), {}), ((600, 800), {"max_rotation_deg": 3.0})):
        cfg = CorrectorConfig(model="affine", **extra)
        s = oracle.Settings({"max_rotation_deg": cfg.max_rotation_deg,
                             "max_shear_px": cfg.max_shear_px,
                             "max_projective_px": cfg.max_projective_px,
                             "max_scale_dev": cfg.max_scale_dev, "patch_grid": (8, 8),
                             "polish_grid": (4, 4)})
        assert warps.matrix_resid_px(s, shape) == TorchBackend(cfg, device="cpu")._matrix_resid_px(shape)
