"""The unquantized describe route of the PyTorch port
(`match_precision="float32"`) against kcmc_tpu's
`describe_keypoints_batch(precision="float32")`: the bilinear blend and
the orientation bins of the raw windows, the descriptor words (upright
and oriented), and that the route cuts its windows through K11 and no
other patch kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import describe as jdescribe
from kcmc_tpu.ops.detect import detect_keypoints_batch as j_detect_batch
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.ops import describe as tdescribe
from kcmc_tpu_torch.ops.cuda_patch import extract_patches
from kcmc_tpu_torch.ops.detect import Keypoints as TKeypoints


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(dc, K=256, seed=9):
    """Reference keypoints and blur of three 128^2 scenes at a DC level
    (the describe-mean item of ROADMAP queue 3 uses dc 500)."""
    rng = np.random.default_rng(seed)
    fr = np.stack([render_scene(rng, (128, 128), n_blobs=120) * 300 + dc
                   for _ in range(3)]).astype(np.float32)
    kps, smooth = j_detect_batch(jnp.asarray(fr), max_keypoints=K, threshold=1e-4,
                                 smooth_sigma=2.0)
    tk = TKeypoints(*(torch.as_tensor(np.array(x)) for x in kps))
    return fr, kps, smooth, tk


@pytest.fixture(scope="module")
def cases():
    return {dc: _case(dc) for dc in (0, 500)}


def _raw(smooth, xy, r):
    """The route's raw (B, K, P, P) windows: K11 on the padded float32
    mean-removed blur, from the port."""
    c = tdescribe.centre_finite(torch.as_tensor(np.array(smooth)))
    return extract_patches(*tdescribe.float32_windows(c, xy, r == tdescribe.ROT_RADIUS))


_j_blend = jax.jit(jdescribe._bilinear_blend)


@pytest.mark.parametrize("r", [jdescribe.PATCH_RADIUS, jdescribe.ROT_RADIUS])
def test_blend_and_bins_match(cases, r):
    """On the same raw windows: the orientation bins equal, and the
    blend within float32 rounding of the reference's compiled blend
    (2e-6 of max|window|). XLA fuses the two lerps' multiply-adds in a
    way no fixed order of fused and unfused steps reproduces (the
    closest, K2's, leaves ~2.4% of the values 1-2 ulps apart on this
    draw, more ulps only where the mean-removed values cancel); the
    bf16 quantization of the selected values absorbs it, so the words
    below are identical."""
    _, kps, smooth, tk = cases[500]
    raw = _raw(smooth, tk.xy, r)
    for b in range(raw.shape[0]):
        jraw = jnp.asarray(raw[b].permute(1, 2, 0).numpy())  # keypoint-last
        want = np.asarray(_j_blend(jraw, kps.xy[b])).transpose(2, 0, 1)
        got = tdescribe._bilinear_blend(raw[b:b + 1], tk.xy[b:b + 1])[0].numpy()
        tol = 2e-6 * float(raw[b].abs().max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        if r == jdescribe.ROT_RADIUS:
            wbins = np.asarray(jdescribe._quantize_bins(
                jdescribe._moment_angles(jraw, kps.xy[b], r)))
            frac = tk.xy[b:b + 1] - torch.floor(tk.xy[b:b + 1])
            m10, m01 = tdescribe._disc_moments(raw[b:b + 1], frac)
            gbins = tdescribe._quantize_bins(torch.atan2(m01, m10))[0].numpy()
            np.testing.assert_array_equal(gbins, wbins)


@pytest.mark.parametrize("dc", [0, 500])
@pytest.mark.parametrize("oriented", [False, True])
def test_float32_words_match(cases, dc, oriented, monkeypatch):
    """Descriptor words against the reference's float32 route: identical
    except where the per-frame finite mean, a float32 sum in another
    order than XLA's (ROADMAP queue 3, describe mean), moves a blended
    value across a bf16 rounding boundary: at dc 500, 1 bit of 768
    oriented descriptors on this draw, bounded at 16 as on the quantized
    route. The windows come from K11 (its plain version here), not from
    K2, K4, K5 or K6."""
    fr, kps, smooth, tk = cases[dc]
    calls = []
    real = tdescribe.extract_patches
    monkeypatch.setattr(tdescribe, "extract_patches",
                        lambda *a: (calls.append(a[-1]), real(*a))[1])

    def no_kernel(*a, **k):
        raise AssertionError("the float32 route used a quantized patch kernel")

    for name in ("extract_blended", "moment_maps", "binned_select_rows"):
        monkeypatch.setattr(tdescribe, name, no_kernel)
    want = np.asarray(jdescribe.describe_keypoints_batch(
        jnp.asarray(fr), kps, oriented=oriented, blur_sigma=2.0, smooth=smooth,
        precision="float32"))
    got = tdescribe.describe_keypoints_batch(
        torch.as_tensor(fr), tk, smooth=torch.as_tensor(np.array(smooth)),
        oriented=oriented, precision="float32").numpy().astype(np.uint32)
    r = jdescribe.ROT_RADIUS if oriented else jdescribe.PATCH_RADIUS
    assert calls == [2 * r + 2]
    n_bits = int(np.unpackbits((want ^ got).view(np.uint8)).sum())
    if dc == 0 or not oriented:
        assert n_bits == 0
    assert n_bits <= 16


def test_backend_takes_the_float32_route(monkeypatch):
    """The backend resolves "float32" on either device, and its
    reference preparation cuts windows through K11 (one call)."""
    cfg = CorrectorConfig(model="homography", match_precision="float32", max_keypoints=128)
    be = TorchBackend(cfg, device="cpu")
    assert be.precision == "float32"
    calls = []
    real = tdescribe.extract_patches
    monkeypatch.setattr(tdescribe, "extract_patches",
                        lambda *a: (calls.append(a[0].shape), real(*a))[1])
    rng = np.random.default_rng(1)
    ref = be.prepare_reference(render_scene(rng, (96, 96), n_blobs=60).astype(np.float32))
    assert len(calls) == 1 and int(ref["valid"].sum()) > 0
    assert TorchBackend(CorrectorConfig(), device="cpu").precision == "bf16"
