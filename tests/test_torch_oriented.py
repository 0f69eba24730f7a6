"""The bins-first oriented describe route of the PyTorch port against
kcmc_tpu: the rotated-pattern constants, the packed stable sort, the
aligned runs and the word back-map, K4's and K5's plain versions against
the Pallas kernels in interpret mode, and the descriptor words against
both reference describe routes."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import describe as jdescribe
from kcmc_tpu.ops import dispatch as jdispatch
from kcmc_tpu.ops import pallas_patch as pp
from kcmc_tpu.ops import patterns as jpatterns
from kcmc_tpu.ops.detect import Keypoints as JKeypoints
from kcmc_tpu.ops.detect import gaussian_blur as jgaussian_blur
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.ops import cuda_moments, cuda_select
from kcmc_tpu_torch.ops import describe as tdescribe
from kcmc_tpu_torch.ops import dispatch as tdispatch
from kcmc_tpu_torch.ops import patterns as tpatterns
from kcmc_tpu_torch.ops.detect import Keypoints as TKeypoints


@pytest.mark.parametrize(
    "name", ["ROT_PATTERNS", "MOMENTS", "MOMENT_RADIUS", "N_ORIENT_BINS", "ROT_RADIUS"]
)
def test_oriented_constants_equal(name):
    np.testing.assert_array_equal(getattr(jpatterns, name), getattr(tpatterns, name))


def test_sel_rot_equals_reference():
    got = tdescribe.sel_rot("cpu")
    assert got.dtype == torch.bfloat16 and got.shape == jdescribe._SEL_ROT.shape
    np.testing.assert_array_equal(got.float().numpy(), jdescribe._SEL_ROT)


@pytest.mark.parametrize("seed", [0, 1])
def test_stable_argsort_small_keys_identical(seed):
    """Same order as the reference, out-of-range keys clamped alike."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 17, (3, 300)).astype(np.int32)
    keys[0, :5] = [-3, 99, 17, 0, -1]
    for b in range(3):
        wo, wk = jdispatch.stable_argsort_small_keys(jnp.asarray(keys[b]), 17)
        to, tk = tdispatch.stable_argsort_small_keys(torch.as_tensor(keys[b]), 17)
        np.testing.assert_array_equal(np.asarray(wo), to.numpy())
        np.testing.assert_array_equal(np.asarray(wk), tk.numpy())
    bo, bk = tdispatch.stable_argsort_small_keys(torch.as_tensor(keys), 17)
    np.testing.assert_array_equal(bo[1].numpy(), np.argsort(keys[1], kind="stable"))
    with pytest.raises(ValueError, match="overflows"):
        tdispatch.stable_argsort_small_keys(torch.zeros(1 << 20, dtype=torch.int32), 4096)


def test_aligned_runs_structure():
    """The reference's structure case (test_describe_binned.py)."""
    keys = torch.as_tensor([[2, 0, 2, 5, 0, 2, 9, 0]])  # 9 = drop
    src, astarts, aends = tdescribe._aligned_runs(keys, 6, 4)
    src, astarts, aends = src[0].numpy(), astarts[0].numpy(), aends[0].numpy()
    N = 8
    assert astarts[0] == 0 and aends[0] == 4 and list(src[:4]) == [1, 4, 7, N]
    assert astarts[2] == 4 and aends[2] == 8 and list(src[4:8]) == [0, 2, 5, N]
    assert astarts[5] == 8 and aends[5] == 12 and src[8] == 3
    assert astarts[1] == aends[1] == 4
    assert 6 not in src[: aends[5]]
    assert (src[aends[5]:] == N).all()


def test_aligned_runs_identical_on_random_keys():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 18, (2, 500)).astype(np.int32)
    src, astarts, aends = tdescribe._aligned_runs(torch.as_tensor(keys), 17, 16)
    for b in range(2):
        ws, wa, we = jdescribe._aligned_runs(jnp.asarray(keys[b]), 17, 16)
        np.testing.assert_array_equal(np.asarray(ws), src[b].numpy())
        np.testing.assert_array_equal(np.asarray(wa), astarts[b].numpy())
        np.testing.assert_array_equal(np.asarray(we), aends[b].numpy())


@pytest.mark.parametrize("force_scatter", [False, True])
def test_backmap_words_identical(force_scatter):
    """Both of the reference's branches, against both of the port's."""
    rng = np.random.default_rng(5)
    B, K, NW, Kp = 3, 40, 8, 64
    words = rng.integers(0, 2**32, size=(B, Kp, NW), dtype=np.uint32)
    src = np.full((B, Kp), K, np.int32)
    for b in range(B):
        src[b, rng.choice(Kp, size=K, replace=False)] = rng.permutation(K)
    want = np.asarray(jdescribe._backmap_words(
        jnp.asarray(words), jnp.asarray(src), K, force_scatter=force_scatter
    )).astype(np.int64)
    tw, ts = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(src.astype(np.int64))
    for fs in (False, True):
        got = tdescribe._backmap_words(tw, ts, K, force_scatter=fs)
        np.testing.assert_array_equal(want, got.numpy())


def test_quantize_bins_identical():
    rng = np.random.default_rng(6)
    edges = (np.arange(-8, 9) + 0.5) * (2 * np.pi / 16)
    ang = np.concatenate([
        rng.uniform(-np.pi, np.pi, 2000), edges, np.nextafter(edges, 0), [np.pi, -np.pi, 0.0],
    ]).astype(np.float32)
    want = np.asarray(jdescribe._quantize_bins(jnp.asarray(ang)))
    got = tdescribe._quantize_bins(torch.as_tensor(ang)).numpy()
    np.testing.assert_array_equal(want, got)


def test_k4_plain_matches_pallas_interpret():
    """Bit-identical: same band order, m01's multiply-adds fused as the
    reference's CPU evaluation fuses them."""
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.normal(size=(2, 224, 200)).astype(np.float32)).astype(jnp.bfloat16)
    w10, w01 = pp.moment_maps(p, interpret=True)
    pt = torch.as_tensor(np.asarray(p.astype(jnp.float32))).to(torch.bfloat16)
    g10, g01 = cuda_moments.moment_maps(pt)
    assert g10.shape == (2, 210, 186)
    np.testing.assert_array_equal(np.asarray(w10), g10.numpy())
    np.testing.assert_array_equal(np.asarray(w01), g01.numpy())


def test_k4_band_table_matches_source():
    """csrc/moments.cu's BANDS table is the band structure the plain
    version derives from MOMENTS, and the reference's."""
    src = (Path(cuda_moments.__file__).parents[1] / "csrc" / "moments.cu").read_text()
    body = re.search(r"BANDS\[NBAND\]\[2\] = \{(.*?)\};", src, re.S).group(1)
    table = [tuple(map(int, t)) for t in re.findall(r"\{(-?\d+), (-?\d+)\}", body)]
    _, by_w = pp._moment_band_structure()
    want = [(w, dy) for w, dys in sorted(by_w.items()) for dy in dys]
    assert table == cuda_moments.band_structure() == want


def _select_case(dense: bool):
    rng = np.random.default_rng(7)
    B, Kp, L, V, align, nb = 2, 64, 961, 512, 16, 16
    flat = rng.normal(size=(B, Kp, L)).astype(np.float32)
    if dense:
        sel = rng.normal(size=(nb, L, V)).astype(np.float32)
    else:
        sel = jdescribe._SEL_ROT
    ibin = np.array([[0, 0, 5, 15], [3, 9, nb, 1]], np.int32)  # nb: sentinel
    fj = jnp.asarray(flat).astype(jnp.bfloat16)
    sj = jnp.asarray(sel).astype(jnp.bfloat16)
    want = np.asarray(pp.binned_select_rows(fj, jnp.asarray(ibin), sj, align, interpret=True))
    got = cuda_select.binned_select_rows(
        torch.as_tensor(np.asarray(fj.astype(jnp.float32))).to(torch.bfloat16),
        torch.as_tensor(ibin),
        torch.as_tensor(np.asarray(sj.astype(jnp.float32))).to(torch.bfloat16),
        align,
    )
    return want.astype(np.float32), got.float().numpy()


def test_k5_plain_matches_pallas_onehot():
    want, got = _select_case(dense=False)
    np.testing.assert_array_equal(want, got)


def test_k5_plain_matches_pallas_dense():
    """A general selection stack: float32 sums in another order, so
    within one bf16 ulp (2^-7 relative to the larger magnitude)."""
    want, got = _select_case(dense=True)
    _, e = np.frexp(np.maximum(np.abs(want), np.abs(got)))
    ulp = np.ldexp(1.0, e - 8)  # bf16 keeps 8 significant bits
    # plus the float32 slack of 961-term sums for results that cancel
    slack = 1e-5 * np.abs(want).max()
    assert (np.abs(want - got) <= ulp + slack).all()
    assert (want == got).mean() > 0.9


@pytest.fixture(scope="module", params=[0.0, 500.0], ids=["no_dc", "dc500"])
def oriented_case(request):
    """One 128x128 frame with K = 2048 keypoints (the bins-first gate),
    the last 64 invalid; optionally a DC offset the mean must absorb."""
    rng = np.random.default_rng(9)
    H = W = 128
    K = tdescribe.BINS_FIRST_MIN_K
    img = (render_scene(rng, (H, W), n_blobs=120) * 300.0 + request.param).astype(np.float32)
    xy = rng.uniform(2, W - 3, size=(1, K, 2)).astype(np.float32)
    xy[0, :4] = [[3.0, 3.0], [64.5, 20.5], [100.49, 7.51], [124.0, 124.0]]
    valid = np.ones((1, K), bool)
    valid[0, -64:] = False
    score = np.linspace(1, 0.1, K, dtype=np.float32)[None]
    return img[None], xy, valid, score


def test_moments_at_keypoints_identical(oriented_case):
    fr, xy, _, _ = oriented_case
    r = tpatterns.ROT_RADIUS
    padded = jnp.pad(
        jnp.asarray(fr - fr.mean()).astype(jnp.bfloat16),
        ((0, 0), (r + 1, r + 1), (r + 1, r + 1)), mode="edge",
    )
    w10, w01 = jdescribe._moments_at_keypoints(padded, jnp.asarray(xy), r, interpret=True)
    pt = torch.as_tensor(np.asarray(padded.astype(jnp.float32))).to(torch.bfloat16)
    g10, g01 = tdescribe._moments_at_keypoints(pt, torch.as_tensor(xy), r)
    np.testing.assert_array_equal(np.asarray(w10), g10.numpy())
    np.testing.assert_array_equal(np.asarray(w01), g01.numpy())


def test_oriented_words_match_both_reference_routes(oriented_case):
    """Identical words to the reference's bins-first Pallas route
    (interpret mode) and to its single-frame XLA route, whose in-patch
    moments sum in another order (a bin can flip only for an angle
    within ~1e-6 rad of a bin edge; none does here). Both get the same
    blurred frame, as the batch program passes K1's."""
    fr, xy, valid, score = oriented_case
    smooth = np.asarray(jax.vmap(lambda f: jgaussian_blur(f, 2.0))(jnp.asarray(fr)))
    jk = JKeypoints(jnp.asarray(xy), jnp.asarray(score), jnp.asarray(valid))
    want = np.asarray(jdescribe.describe_keypoints_batch(
        jnp.asarray(fr), jk, oriented=True, use_pallas=True, interpret=True,
        smooth=jnp.asarray(smooth),
    )).astype(np.int64)
    tk = TKeypoints(*(torch.as_tensor(a) for a in (xy, score, valid)))
    got = tdescribe.describe_keypoints_batch(
        torch.as_tensor(fr), tk, oriented=True, smooth=torch.as_tensor(smooth)
    ).numpy()
    assert (got[valid] != 0).any(axis=-1).all() and not got[~valid].any()
    if fr.mean() > 100.0:
        # The per-frame mean taken off before the bf16 cast is a float32
        # sum whose order differs between XLA and torch (504.257 against
        # 504.2569 here), so a few near-tie pixels quantize one bf16 step
        # apart: ROADMAP.md queue 3. The words then differ in a few bits.
        bits = np.unpackbits((want ^ got).astype(np.uint32).view(np.uint8)).sum()
        assert bits <= 16, f"{bits} descriptor bits differ"
        return
    np.testing.assert_array_equal(want, got)
    single = np.asarray(jdescribe.describe_keypoints(
        jnp.asarray(fr[0]), JKeypoints(*(a[0] for a in jk)), oriented=True,
        smooth=jnp.asarray(smooth[0]),
    )).astype(np.int64)
    flips = int((single != got[0]).any(axis=-1).sum())
    assert flips == 0, f"{flips} keypoints differ from the in-patch route"
    one = tdescribe.describe_keypoints(
        torch.as_tensor(fr[0]), TKeypoints(*(t[0] for t in tk)), oriented=True,
        smooth=torch.as_tensor(smooth[0]),
    )
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_oriented_below_bins_first_gate_raises(monkeypatch):
    """The K gate routes: with K4 patched to raise, K = 64 takes the
    small-K route (K6) and describes, K = 2048 takes the bins-first route
    and raises."""
    def boom(*_a, **_k):
        raise AssertionError("bins-first route taken")

    monkeypatch.setattr(tdescribe, "moment_maps", boom)

    def kps(K):
        return TKeypoints(torch.full((1, K, 2), 30.0), torch.zeros((1, K)),
                          torch.ones((1, K), dtype=bool))

    frame = torch.rand((1, 64, 64), generator=torch.Generator().manual_seed(0))
    assert tdescribe.describe_keypoints_batch(frame, kps(64), oriented=True).shape == (1, 64, 8)
    with pytest.raises(AssertionError, match="bins-first"):
        tdescribe.describe_keypoints_batch(frame, kps(tdescribe.BINS_FIRST_MIN_K), oriented=True)
