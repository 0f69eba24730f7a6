"""The options of correct() in the PyTorch port against kcmc_tpu: rolling
template segments, blends and tails, the quality metrics and coverage
masks, input sanitizing, the seeded consensus of the warm start, one
template-refinement and one rolling-template run against
backend="jax", and the port's own invariants (chunked and one-shot
runs, batch-size independence, device outputs, stream views)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.backends import jax_backend as jb
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.ops.ransac import consensus_batch as j_consensus
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends import torch_backend as tb
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.ops.piecewise import upsample_field
from kcmc_tpu_torch.ops.ransac import consensus_batch as t_consensus
from kcmc_tpu_torch.utils import prng
from kcmc_tpu_torch.utils.metrics import transform_rmse


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops, which torch's
    intra-op threads only slow down when several test processes share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (128, 128)
KW = dict(batch_size=8, max_keypoints=256)


@pytest.fixture(scope="module")
def drift():
    return jsynthetic.make_drift_stack(16, SHAPE, seed=0)


# ---------------------------------------------------------------------------
# rolling-template pieces, function by function


@pytest.mark.parametrize("E,start,stop", [(0, 0, 50), (8, 0, 50), (8, 5, 50), (7, 13, 14),
                                          (16, 16, 48), (5, 3, 3)])
def test_segment_bounds_match(E, start, stop):
    want = kcmc_tpu.MotionCorrector._segment_bounds(
        types.SimpleNamespace(template_update_every=E), start, stop)
    got = kcmc_tpu_torch.MotionCorrector._segment_bounds(
        types.SimpleNamespace(template_update_every=E), start, stop)
    assert got == want


def _tail_case(seed=0):
    rng = np.random.default_rng(seed)
    outs = [{"corrected": rng.normal(100, 20, (n, 24, 20)).astype(np.float32),
             "warp_ok": rng.uniform(size=n) < 0.7} for n in (8, 8, 5)]
    outs[1]["warp_ok"][:] = False
    ref = rng.normal(100, 20, (24, 20)).astype(np.float32)
    return outs, ref


@pytest.mark.parametrize("window", [1, 4, 9, 21, 40])
def test_template_tail_and_rolled_template_match(window):
    """The tail covers the last `window` frames frame-exactly, and the
    host blend gives the reference's template bit for bit (the same
    numpy float32 mean)."""
    outs, ref = _tail_case()
    jc, jk = kcmc_tpu.MotionCorrector._template_tail(None, outs, window)
    tc, tk = kcmc_tpu_torch.MotionCorrector._template_tail(None, outs, window)
    for a, b in zip(jc + jk, tc + tk):
        np.testing.assert_array_equal(a, b)
    me = types.SimpleNamespace(template_update_alpha=0.3)
    want = kcmc_tpu.MotionCorrector._rolled_template(me, ref, jc, jk, window)
    got = kcmc_tpu_torch.MotionCorrector._rolled_template(me, ref, tc, tk, window)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("case", ["mixed", "none_ok", "all_ok"])
def test_blend_template_matches(case):
    """The device blend within float32 summation order (1e-6 of
    max|frame|); a window with no frame kept leaves the template as it
    is."""
    rng = np.random.default_rng(3)
    ref = rng.normal(300, 50, (40, 36)).astype(np.float32)
    frames = rng.normal(300, 50, (12, 40, 36)).astype(np.float32)
    ok = {"mixed": rng.uniform(size=12) < 0.5, "none_ok": np.zeros(12, bool),
          "all_ok": np.ones(12, bool)}[case]
    want = np.asarray(jb._blend_template(jnp.asarray(ref), jnp.asarray(frames),
                                         jnp.asarray(ok), jnp.float32(0.4)))
    got = tb.blend_template(torch.as_tensor(ref), torch.as_tensor(frames),
                            torch.as_tensor(ok), 0.4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(frames).max())
    if case == "none_ok":
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# quality metrics and coverage masks


def _maps(B, seed, persp=True):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    M[:, :2, :2] += rng.normal(0, 0.03, (B, 2, 2))
    M[:, :2, 2] = rng.uniform(-20, 20, (B, 2))
    if persp:
        M[:, 2, :2] = rng.normal(0, 2e-4, (B, 2))
    return M.astype(np.float32)


def test_coverage_masks_match_exactly():
    H, W = 48, 56
    M = _maps(4, 0)
    want = np.asarray(jb._coverage_matrix(jnp.asarray(M), (H, W)))
    np.testing.assert_array_equal(twarp.coverage_mask((H, W), torch.as_tensor(M)).numpy(), want)
    rng = np.random.default_rng(1)
    flows = rng.normal(0, 3, (3, H, W, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jwarp.coverage_mask_flow))(jnp.asarray(flows)))
    np.testing.assert_array_equal(twarp.coverage_mask_flow(torch.as_tensor(flows)).numpy(), want)
    M3 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    M3[:, :3, :3] += rng.normal(0, 0.02, (3, 3, 3))
    M3[:, :3, 3] = rng.uniform(-4, 4, (3, 3))
    M3 = M3.astype(np.float32)
    shape3 = (10, 20, 24)
    want = np.asarray(jb._coverage_matrix3d(jnp.asarray(M3), shape3))
    np.testing.assert_array_equal(
        twarp.coverage_mask_3d(shape3, torch.as_tensor(M3)).numpy(), want)


def test_template_corr_and_quality_match():
    """template_corr within 1e-5 on frames warped by the maps, over the
    maps' coverage; the backend's quality() on matrix and field outputs
    (the field's coverage through the upsampled flow, exactly)."""
    rng = np.random.default_rng(2)
    H, W = 48, 56
    ref = jsynthetic.render_scene(rng, (H, W), n_blobs=30).astype(np.float32)
    M = _maps(4, 4)
    frames = np.asarray(jax.jit(jax.vmap(jwarp.warp_frame, (None, 0)))(
        jnp.asarray(ref), jnp.asarray(M))) + rng.normal(0, 0.01, (4, H, W)).astype(np.float32)
    mask = np.asarray(jb._coverage_matrix(jnp.asarray(M), (H, W)))
    want = np.asarray(jb._template_corr(jnp.asarray(frames), jnp.asarray(ref), jnp.asarray(mask)))
    got = tb.template_corr(torch.as_tensor(frames), torch.as_tensor(ref),
                           torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    be = tb.TorchBackend(kcmc_tpu_torch.CorrectorConfig(), device="cpu")
    corr, cov = be.quality(torch.as_tensor(frames), {"transform": torch.as_tensor(M)},
                           torch.as_tensor(ref))
    np.testing.assert_allclose(corr.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), mask.mean(axis=(1, 2)), rtol=0, atol=1e-6)
    fields = rng.normal(0, 2, (4, 4, 4, 2)).astype(np.float32)
    fmask = np.asarray(jb._coverage_field(jnp.asarray(fields), (H, W)))
    tmask = twarp.coverage_mask_flow(upsample_field(torch.as_tensor(fields), (H, W))).numpy()
    np.testing.assert_array_equal(tmask, fmask)
    _, cov = be.quality(torch.as_tensor(frames), {"field": torch.as_tensor(fields)},
                        torch.as_tensor(ref))
    np.testing.assert_allclose(cov.numpy(), tmask.mean(axis=(1, 2)), rtol=0, atol=1e-6)


def test_sanitize_nonfinite_matches():
    rng = np.random.default_rng(5)
    fr = rng.normal(500, 40, (3, 30, 26)).astype(np.float32)
    fr[0, 4, :] = np.nan
    fr[0, :, 7] = np.inf
    fr[1, 2, 3] = -np.inf
    fr[2] = np.nan  # no finite pixel: replaced by 0 / 1
    want = np.asarray(jb._sanitize_nonfinite(jnp.asarray(fr)))
    got = tb.sanitize_nonfinite(torch.as_tensor(fr)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    vol = rng.normal(0, 1, (2, 4, 6, 8)).astype(np.float32)
    vol[1, 2, 3, 4] = np.nan
    np.testing.assert_allclose(tb.sanitize_nonfinite(torch.as_tensor(vol)).numpy(),
                               np.asarray(jb._sanitize_nonfinite(jnp.asarray(vol))),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the warm start's seeded consensus


def _px(a, b, size=128):
    """Largest displacement between two maps over a size^2 frame's corners."""
    c = np.array([[0, 0, 1], [size, 0, 1], [0, size, 1], [size, size, 1]], np.float64)
    pa = np.einsum("bij,kj->bki", np.asarray(a, np.float64), c)
    pb = np.einsum("bij,kj->bki", np.asarray(b, np.float64), c)
    return float(np.abs(pa[..., :2] / pa[..., 2:] - pb[..., :2] / pb[..., 2:]).max())


def _seed_case(model, seed=0, B=4, N=96):
    rng = np.random.default_rng(seed)
    M = _maps(B, seed + 10, persp=model == "homography").astype(np.float64)
    src = rng.uniform(0, 128, (B, N, 2))
    h = np.einsum("bij,bkj->bki", M, np.concatenate([src, np.ones((B, N, 1))], -1))
    dst = h[..., :2] / h[..., 2:] + rng.normal(0, 0.3, (B, N, 2))
    out = rng.uniform(size=(B, N)) < 0.3
    dst[out] = rng.uniform(0, 128, (int(out.sum()), 2))
    valid = rng.uniform(size=(B, N)) < 0.85
    valid[3, 20:] = False  # too few matches to arm the early exit
    return src.astype(np.float32), dst.astype(np.float32), valid, M.astype(np.float32)


_j_seeded = jax.jit(
    lambda model, src, dst, valid, keys, seed, ok, **kw: j_consensus(
        model, src, dst, valid, keys, seed_transform=seed, seed_ok=ok, **kw),
    static_argnums=(0,), static_argnames=("n_hypotheses", "threshold", "refine_iters",
                                          "score_cap", "budget_rungs", "early_exit_frac"))


@pytest.mark.parametrize("model,seed_kind,tol", [
    ("affine", "good", 1e-4), ("affine", "scene_cut", 1e-4), ("affine", "per_frame", 1e-4),
    ("homography", "good", 2e-3),
])
def test_seeded_consensus_matches(model, seed_kind, tol):
    """A good seed (the previous frame's map, ok) exits the ladder early;
    a scene-cut seed that scores low leaves it to run as unseeded; a
    per-frame seed with some frames not ok. Identical inlier masks,
    transforms within 1e-4 px (homography: queue 3's 2e-3 px)."""
    src, dst, valid, M = _seed_case(model)
    B = src.shape[0]
    # per-frame seeds throughout, so the reference compiles once per model
    ok = np.ones(B, bool)
    if seed_kind == "good":
        seed = M
    elif seed_kind == "scene_cut":
        seed = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        seed[:, :2, 2] = (60.0, -45.0)
    else:
        seed, ok = M[::-1].copy(), np.array([True, False, True, True])
    idx = np.arange(40, 40 + B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx))
    tkeys = prng.fold_in(prng.key(0), torch.as_tensor(idx))
    kw = dict(n_hypotheses=64, threshold=2.0, refine_iters=2, score_cap=512,
              budget_rungs=4, early_exit_frac=0.7)
    want = _j_seeded(jtransforms.get_model(model), jnp.asarray(src), jnp.asarray(dst),
                     jnp.asarray(valid), jkeys, jnp.asarray(seed), jnp.asarray(ok), **kw)
    got = t_consensus(ttransforms.get_model(model), torch.as_tensor(src),
                      torch.as_tensor(dst), torch.as_tensor(valid), tkeys,
                      seed_transform=torch.as_tensor(seed), seed_ok=torch.as_tensor(ok), **kw)
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_array_equal(np.asarray(want.inlier_mask), got.inlier_mask.numpy())
    assert _px(np.asarray(want.transform), got.transform.numpy()) <= tol


# ---------------------------------------------------------------------------
# end to end against backend="jax" (the PR's two JAX runs: one corrector)


@pytest.fixture(scope="module")
def jax_template_runs(drift):
    """One corrector per package: template_iters=2 with quality metrics,
    then the same corrector with rolling templates (every 6 frames, a
    4-frame window; device_templates on both sides)."""
    jm = kcmc_tpu.MotionCorrector(backend="jax", template_iters=2, template_window=16,
                                  quality_metrics=True, **KW)
    tm = kcmc_tpu_torch.MotionCorrector(device="cpu", template_iters=2, template_window=16,
                                        quality_metrics=True, **KW)
    runs = {"iters": (jm.correct(drift.stack), tm.correct(drift.stack))}
    for m in (jm, tm):
        m.template_iters, m.template_update_every, m.template_window = 0, 6, 4
    runs["rolling"] = (jm.correct(drift.stack), tm.correct(drift.stack))
    return runs


# slow: the two backend="jax" runs compile the reference's programs,
# ~11 s of junit time in the six-worker tier-1 run
@pytest.mark.slow
@pytest.mark.parametrize("kind", ["iters", "rolling"])
def test_template_runs_match_jax_backend(jax_template_runs, kind):
    want, got = jax_template_runs[kind]
    assert transform_rmse(got.transforms, want.transforms, SHAPE) <= 1e-3
    np.testing.assert_array_equal(got.diagnostics["n_inliers"], want.diagnostics["n_inliers"])
    np.testing.assert_allclose(got.diagnostics["template_corr"],
                               want.diagnostics["template_corr"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.diagnostics["coverage"], want.diagnostics["coverage"],
                               rtol=0, atol=1e-4)
    if kind == "rolling":
        for key in ("template_updates", "device_templates"):
            assert got.timing["pipeline"][key] == want.timing["pipeline"][key]
        assert got.timing["pipeline"]["template_updates"] == 2


# ---------------------------------------------------------------------------
# the port's own invariants


@pytest.fixture(scope="module")
def port_runs(drift):
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW)
    return mc, mc.correct(drift.stack)


def test_chunked_run_is_bit_equal(drift, port_runs):
    mc, one = port_runs
    a = mc.correct(drift.stack, end_frame=5)
    b = mc.correct(drift.stack, start_frame=5, end_frame=13)
    c = mc.correct(drift.stack, start_frame=13)
    np.testing.assert_array_equal(np.concatenate([a.transforms, b.transforms, c.transforms]),
                                  one.transforms)
    np.testing.assert_array_equal(np.concatenate([a.corrected, b.corrected, c.corrected]),
                                  one.corrected)


def test_rolling_boundaries_do_not_depend_on_batch_size(drift):
    """Updates at absolute multiples of template_update_every: batches
    of 4 and of 8 give the same transforms, on both template paths."""
    got = {}
    for B, dev in ((4, True), (8, True), (8, False)):
        mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=B, max_keypoints=256,
                                            template_update_every=6, template_window=4,
                                            device_templates=dev)
        got[B, dev] = mc.correct(drift.stack)
        # device templates keep the window in flight across boundaries
        # (one final drain); the host blend drains every segment. A
        # segment stages every batch after its first: batches of 4 wait
        # on one staged upload in each of the two full segments
        assert got[B, dev].timing["pipeline"] == {
            "template_updates": 2, "device_templates": dev,
            "drain_flushes": 1 if dev else 3, "upload_overlap": B == 4,
            "upload_waits": 2 if B == 4 else 0}
    for key in got:
        np.testing.assert_array_equal(got[key].transforms, got[8, True].transforms)


def test_device_outputs_and_tensor_stacks(drift, port_runs):
    """A tensor stack with device_outputs returns tensors on the
    backend's device, equal to the host run where no frame was rescued;
    a tensor stack without it returns numpy equal to the host run."""
    mc, one = port_runs
    res = mc.correct(torch.as_tensor(drift.stack), device_outputs=True,
                     output_dtype="uint16")
    assert isinstance(res.corrected, torch.Tensor) and res.corrected.dtype == torch.float32
    assert isinstance(res.transforms, torch.Tensor)
    np.testing.assert_array_equal(res.transforms.numpy(), one.transforms)
    np.testing.assert_array_equal(res.corrected.numpy(), one.corrected)
    assert "warp_rescued" not in res.diagnostics
    host = mc.correct(torch.as_tensor(drift.stack))
    np.testing.assert_array_equal(host.transforms, one.transforms)


def test_stream_view_shares_the_backend(drift, port_runs, monkeypatch):
    mc, one = port_runs
    built = []
    orig = tb.TorchBackend.__init__
    monkeypatch.setattr(tb.TorchBackend, "__init__",
                        lambda self, *a, **k: (built.append(1), orig(self, *a, **k))[1])
    views = [mc.stream_view(), mc.stream_view(reference="mean", template_update_every=8,
                                              template_update_alpha=0.25)]
    assert not built
    assert all(v.backend is mc.backend for v in views)
    assert views[1].template_update_every == 8 and views[1].template_update_alpha == 0.25
    np.testing.assert_array_equal(views[0].correct(drift.stack).transforms, one.transforms)
    with pytest.raises(ValueError, match="different CorrectorConfig"):
        kcmc_tpu_torch.MotionCorrector(backend=mc.backend, max_keypoints=128)
    with pytest.raises(ValueError, match="mesh= cannot be combined"):
        kcmc_tpu_torch.MotionCorrector(backend=mc.backend, mesh=object(), **KW)


@pytest.mark.parametrize("kw", [{"template_window": 0}, {"template_update_every": -1},
                                {"template_update_alpha": 0.0},
                                {"template_update_alpha": 1.5}])
def test_template_knob_checks_match(kw):
    with pytest.raises(ValueError) as want:
        kcmc_tpu.MotionCorrector(backend="numpy", **kw)
    with pytest.raises(ValueError) as got:
        kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_progress_prints(drift, port_runs, capsys):
    mc, _ = port_runs
    mc.correct(drift.stack, start_frame=4, end_frame=14, progress=True)
    assert capsys.readouterr().out.split("\n")[:2] == ["[kcmc] frames 12/14",
                                                        "[kcmc] frames 14/14"]


def test_warm_start_seeds_each_batch_from_the_last(drift, monkeypatch):
    """The seed resets per run, is the previous batch's last valid
    frame's transform, and the run stays accurate."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=6, max_keypoints=256,
                                        warm_start=True)
    seen = []
    orig = mc.backend.process_batch_async  # the seam the dispatch calls

    def spy(frames, ref, idx, seed=None, **kw):
        out = orig(frames, ref, idx, seed=seed, **kw)
        seen.append((None if seed is None else seed[0].clone(), out["transform"].clone()))
        return out

    monkeypatch.setattr(mc.backend, "process_batch_async", spy)
    res = mc.correct(drift.stack[:10])
    mc.correct(drift.stack[:4])
    assert seen[0][0] is None and seen[2][0] is None  # each run starts unseeded
    torch.testing.assert_close(seen[1][0], seen[0][1][5], rtol=0, atol=0)  # 10 = 6 + 4
    from kcmc_tpu_torch.utils.metrics import relative_transforms
    gt = relative_transforms(drift.transforms)[:10]
    assert transform_rmse(res.transforms, gt, SHAPE) < 0.05


def test_sanitize_run_is_finite(drift):
    """NaN rows and Inf columns: finite outputs, transforms within 0.05
    px of the clean run's, and the rescue path sanitizes too."""
    st = drift.stack.copy()
    st[::3, 40, :] = np.nan
    st[::3, :, 50] = np.inf
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", sanitize_input=True, **KW)
    res = mc.correct(st)
    assert np.isfinite(res.corrected).all() and np.isfinite(res.transforms).all()
    clean = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW).correct(drift.stack)
    assert transform_rmse(res.transforms, clean.transforms, SHAPE) < 0.05
    rescued = mc.backend.rescue_warp(st[:2], {"transform": res.transforms[:2]})
    assert np.isfinite(rescued).all()


def test_seeded_ransac_estimate_takes_the_ladder():
    """ransac_estimate with a seed is consensus_batch with that seed
    (ransac.py:447-478), whatever budget_rungs says, over any leading
    axes."""
    from kcmc_tpu_torch.ops.ransac import ransac_estimate

    src, dst, valid, M = _seed_case("affine")
    model = ttransforms.get_model("affine")
    keys = prng.fold_in(prng.key(0), torch.arange(4))
    args = [torch.as_tensor(a) for a in (src, dst, valid)]
    ok = torch.tensor([True, False, True, True])
    kw = dict(n_hypotheses=32, threshold=2.0, refine_iters=2, budget_rungs=0)
    got = ransac_estimate(model, *(a.reshape((2, 2) + a.shape[1:]) for a in args),
                          keys.reshape(2, 2, 2), seed_transform=torch.as_tensor(M).reshape(
                              2, 2, 3, 3), seed_ok=ok.reshape(2, 2), **kw)
    want = t_consensus(model, *args, keys, seed_transform=torch.as_tensor(M), seed_ok=ok, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
