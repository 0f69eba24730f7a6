"""Execution plans in the PyTorch port (`kcmc_tpu_torch.plans`, the
bucketed batch program of `TorchBackend`, `MotionCorrector.warmup`, the
persistent kernel cache and the retrace sentinel) against kcmc_tpu.

The bucket policy, the config fields, every valid-extent seam of the ops
and the bucketed reference preparation are compared function by
function on the same seeded inputs; two `backend="jax"` end-to-end runs
(translation with the polish off, affine with it on) hold the port's
bucketed run against the reference's bucketed run. The port's own
contracts (bucketed equals unbucketed with the polish off, uint16
padding, rolling templates, counters, the failover, warmup and its
stamps, the sentinel) need no JAX run. Frames are 50x70 in a (64, 80)
bucket with K <= 128, on the CPU with one torch thread."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.backends import jax_backend as jb
from kcmc_tpu.ops import detect as jdetect
from kcmc_tpu.ops import polish as jpolish
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.plans import buckets as jbuckets
from kcmc_tpu.plans import runtime as jruntime
from kcmc_tpu_torch.analysis import sanitize
from kcmc_tpu_torch.backends import torch_backend as tb
from kcmc_tpu_torch.config import CorrectorConfig, config_from_dict
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops import detect as tdetect
from kcmc_tpu_torch.ops import polish as tpolish
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.plans import buckets as tbuckets
from kcmc_tpu_torch.plans import cache as tcache
from kcmc_tpu_torch.plans import runtime as truntime
from kcmc_tpu_torch.plans.plan import kernel_libraries
from kcmc_tpu_torch.utils.metrics import relative_transforms, transform_rmse
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

SHAPE, BUCKET = (50, 70), (64, 80)
VALID = np.array(SHAPE, np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: torch's intra-op threads only slow them
    down when several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def compile_cache(tmp_path):
    """A temporary persistent cache, switched off afterwards so the
    process-global directory never outlives the test."""
    tcache.disable_compile_cache()
    yield str(tmp_path / "cache")
    tcache.disable_compile_cache()


def _drift(n=10, shape=SHAPE, model="translation", seed=0, drift=6.0):
    return make_drift_stack(n_frames=n, shape=shape, model=model, max_drift=drift, seed=seed)


def _port(stack, output_dtype="float32", **kw):
    args = dict(model="translation", device="cpu", batch_size=4, max_keypoints=100,
                transform_polish=0)
    args.update(kw)
    return kcmc_tpu_torch.MotionCorrector(**args).correct(stack, output_dtype=output_dtype)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return (type(e).__name__, str(e))


def _px(a, b, shape=SHAPE) -> float:
    """Largest displacement (px) between two (B, 3, 3) maps at the
    frame's corners."""
    h, w = shape
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T
    pa, pb = np.asarray(a, np.float64) @ c, np.asarray(b, np.float64) @ c
    return float(np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max())


def _maps(n, seed, shift=3.0, lin=0.02):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    M[:, :2, :2] += rng.uniform(-lin, lin, (n, 2, 2)).astype(np.float32)
    M[:, :2, 2] = rng.uniform(-shift, shift, (n, 2)).astype(np.float32)
    return M


def _padded(frames):
    out = np.zeros((len(frames),) + BUCKET, np.float32)
    out[:, : SHAPE[0], : SHAPE[1]] = frames
    return out


# -- bucket policy and config -----------------------------------------------

BUCKET_SPECS = [None, (), [], 512, [64], (512, (480, 640), 512, 1024), ((480, 640),),
                (64, (64, 80), 128), (8,), ("512",), ((64, 64, 64),), (True,), ((32, 31),),
                ((40.0, 64),)]


@pytest.mark.parametrize("spec", BUCKET_SPECS, ids=repr)
def test_normalize_buckets_matches_reference(spec):
    assert _outcome(tbuckets.normalize_buckets, spec) == _outcome(
        jbuckets.normalize_buckets, spec)


@pytest.mark.parametrize("shape", [(50, 70), (64, 64), (100, 100), (500, 500), (50,),
                                   (64, 81), (128, 128), (1, 1)])
def test_route_shape_matches_reference(shape):
    ladder = jbuckets.normalize_buckets((64, (64, 80), 128))
    assert tbuckets.route_shape(shape, ladder) == jbuckets.route_shape(shape, ladder)


@pytest.mark.parametrize("b", [1, 2, 3, 8, 12, 32, 0, -4])
def test_batch_ladder_and_route_batch_match_reference(b):
    assert _outcome(tbuckets.batch_ladder, b) == _outcome(jbuckets.batch_ladder, b)
    if b >= 1:
        ladder = jbuckets.batch_ladder(b)
        for n in range(-1, b + 2):
            assert tbuckets.route_batch(n, ladder) == jbuckets.route_batch(n, ladder)


@pytest.mark.parametrize("kw", [dict(plan_buckets=[64, (64, 80)]), dict(plan_buckets=(16,)),
                                dict(plan_buckets=("x",)), dict(compile_cache_dir=""),
                                dict(compile_cache_dir="  "), dict(compile_cache_dir=3),
                                dict(compile_cache_dir="/tmp/c", plan_buckets=512)],
                         ids=repr)
def test_config_normalizes_and_validates_as_reference(kw):
    want = _outcome(lambda: kcmc_tpu.CorrectorConfig(**kw))
    got = _outcome(lambda: CorrectorConfig(**kw))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert got[1].plan_buckets == want[1].plan_buckets
        assert got[1].compile_cache_dir == want[1].compile_cache_dir
        assert hash(got[1]) is not None
    else:
        assert got[1] == want[1]


def test_config_fields_carry_across_and_unsupported_names_only_meshes():
    import dataclasses

    jcfg = kcmc_tpu.CorrectorConfig(plan_buckets=(64, (64, 80)), compile_cache_dir="/tmp/x")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.plan_buckets == jcfg.plan_buckets == ((64, 64), (64, 80))
    assert cfg.compile_cache_dir == "/tmp/x"
    assert cfg.unsupported() == []
    # the mesh is ported (tests/test_torch_mesh.py); nothing declared is
    # left unsupported, and the trace knob (item 19a) carries across
    assert CorrectorConfig(mesh_devices=2).unsupported() == []
    traced = config_from_dict(dataclasses.asdict(jcfg.replace(trace_path="/tmp/t.json")))
    assert traced.trace_path == "/tmp/t.json" and traced.plan_buckets == cfg.plan_buckets
    kcmc_tpu_torch.MotionCorrector(device="cpu", plan_buckets=(64,))  # no longer raises


def test_compile_cache_dir_is_resume_signature_neutral():
    from kcmc_tpu.corrector import _ROBUSTNESS_SIG_NEUTRAL as ref
    from kcmc_tpu_torch.corrector import _ROBUSTNESS_SIG_NEUTRAL as port

    assert "compile_cache_dir" in port and "compile_cache_dir" in ref
    assert "plan_buckets" not in port and "plan_buckets" not in ref


@pytest.mark.parametrize("programs,dtypes", [(("reference", "register", "apply"), ("float32",)),
                                             (("register",), ("float32", "uint16")),
                                             (("reference", "update_reference"), ("uint8",))])
def test_predict_compile_keys_matches_reference(programs, dtypes):
    spec = (48, (64, 80), 128)
    want = jruntime.predict_compile_keys(kcmc_tpu.CorrectorConfig(plan_buckets=spec),
                                         programs=programs, dtypes=dtypes)
    got = truntime.predict_compile_keys(CorrectorConfig(plan_buckets=spec),
                                        programs=programs, dtypes=dtypes)
    assert got == want
    assert truntime.predict_compile_keys(spec) == jruntime.predict_compile_keys(spec)


@pytest.mark.parametrize("kw,want", [
    (dict(), True), (dict(model="affine"), True), (dict(model="piecewise"), False),
    (dict(n_octaves=2), False), (dict(match_radius=12.0), False), (dict(border=15), False),
    (dict(border=16), True),
])
def test_routable_gate_matches_reference(kw, want):
    jr = jruntime.PlanRuntime(kcmc_tpu.CorrectorConfig(plan_buckets=(64,), **kw))
    tr = truntime.PlanRuntime(CorrectorConfig(plan_buckets=(64,), **kw))
    for shape in (SHAPE, (64, 64), (80, 80), (4, 40, 40)):
        assert tr.routable(shape) == jr.routable(shape)
        assert tr.route(shape) == jr.route(shape)
    assert tr.routable(SHAPE) is want


# -- the valid-extent seams of the ops ---------------------------------------


@pytest.mark.parametrize("border", [0, 3, 16])
@pytest.mark.parametrize("hw", [(50, 70), (64, 80), (33, 79)])
def test_valid_extent_and_rect_masks_match_reference(border, hw):
    vhw = np.array(hw, np.int32)
    want = np.asarray(jdetect.valid_extent_mask(BUCKET, border, jnp.asarray(vhw)))
    got = tdetect.valid_extent_mask(BUCKET, border, torch.as_tensor(vhw))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jwarp.valid_rect_mask(BUCKET, jnp.asarray(vhw)))
    np.testing.assert_array_equal(twarp.valid_rect_mask(BUCKET, torch.as_tensor(vhw)).numpy(), want)


def test_masked_detection_matches_pallas_route():
    """K1's plain version plus the masked selection on the bucket canvas
    against the reference's Pallas route in interpret mode with the same
    valid_hw: identical keypoints and validity, the blur within 1e-5."""
    fr = _padded(_drift(2, seed=3).stack)
    want, wsm = jdetect.detect_keypoints_batch(
        jnp.asarray(fr), max_keypoints=64, threshold=1e-4, use_pallas=True,
        smooth_sigma=2.0, interpret=True, valid_hw=jnp.asarray(VALID))
    got, tsm = tdetect.detect_keypoints_batch(
        torch.as_tensor(fr), max_keypoints=64, threshold=1e-4, smooth_sigma=2.0,
        valid_hw=torch.as_tensor(VALID))
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_allclose(np.asarray(want.xy), got.xy.numpy(), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(wsm) - tsm.numpy()).max() <= 1e-5
    xy = got.xy.numpy()[got.valid.numpy()]
    assert (xy[:, 0] < SHAPE[1] - 16).all() and (xy[:, 1] < SHAPE[0] - 16).all()
    # the same keypoints as the unpadded frames' (the reference's claim)
    plain = tdetect.detect_keypoints_batch(
        torch.as_tensor(np.ascontiguousarray(fr[:, : SHAPE[0], : SHAPE[1]])), max_keypoints=64,
        threshold=1e-4, smooth_sigma=2.0)[0]
    assert torch.equal(plain.xy, got.xy) and torch.equal(plain.valid, got.valid)


def test_masked_single_frame_detection_matches_jnp_route():
    fr = _padded(_drift(1, seed=4).stack)[0]
    want = jdetect.detect_keypoints(jnp.asarray(fr), max_keypoints=40, threshold=1e-4,
                                    valid_hw=jnp.asarray(VALID))
    got = tdetect.detect_keypoints(torch.as_tensor(fr), max_keypoints=40, threshold=1e-4,
                                   valid_hw=torch.as_tensor(VALID))
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_allclose(np.asarray(want.xy), got.xy.numpy(), rtol=0, atol=1e-5)


def test_coverage_and_mask_valid_extent_match_reference():
    """coverage_mask with valid_hw (the perspective divide's source
    bounds, exact booleans) and the backend's valid-extent zeroing of a
    warped canvas, against the reference's per-frame functions."""
    M = _maps(6, 1, shift=12.0, lin=0.05)
    M[5, 2, :2] = (2e-4, -1e-4)  # a projective map
    vhw = torch.as_tensor(VALID)
    got = twarp.coverage_mask(BUCKET, torch.as_tensor(M), vhw).numpy()
    for i in range(len(M)):
        want = np.asarray(jwarp.coverage_mask(BUCKET, jnp.asarray(M[i]), valid_hw=jnp.asarray(VALID)))
        np.testing.assert_array_equal(got[i], want)
    canvas = _padded(_drift(6, seed=5).stack)
    warped = np.array(jwarp.warp_batch(jnp.asarray(canvas), jnp.asarray(M)))
    want = np.asarray(jb._mask_valid_extent(jnp.asarray(warped), jnp.asarray(M),
                                            jnp.asarray(VALID)))
    got = tb.mask_valid_extent(torch.as_tensor(warped), torch.as_tensor(M), vhw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > (warped == 0).sum()  # the valid edge was masked


def test_valid_rect_sanitize_matches_reference():
    """The finite mean restricted to the valid rectangle: the padded
    frames' replacement values equal the unpadded frames' (float32, sums
    in a different order: 1e-6 of the frame scale)."""
    rng = np.random.default_rng(2)
    fr = rng.uniform(0, 1, (3,) + SHAPE).astype(np.float32)
    fr[0, 3, :] = np.nan
    fr[1, :, 7] = np.inf
    fr[2, 10, 10] = -np.inf
    canvas = _padded(fr)
    rect = jwarp.valid_rect_mask(BUCKET, jnp.asarray(VALID))
    want = np.asarray(jb._sanitize_nonfinite(jnp.asarray(canvas), rect))
    got = tb.sanitize_nonfinite(torch.as_tensor(canvas),
                                twarp.valid_rect_mask(BUCKET, torch.as_tensor(VALID))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = tb.sanitize_nonfinite(torch.as_tensor(fr)).numpy()
    np.testing.assert_allclose(got[:, : SHAPE[0], : SHAPE[1]], plain, rtol=0, atol=1e-6)
    assert (got[:, SHAPE[0]:] == 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("model", ["translation", "affine"])
def test_polish_with_valid_extent_matches_reference(model):
    """One polish pass on a bucket canvas with the valid-extent region
    gate, within 1e-4 px of the reference at the corners."""
    rng = np.random.default_rng(7)
    d = _drift(1, seed=7)
    tmpl = _padded(d.stack)[0]
    A = _maps(4, 8, shift=0.3, lin=0.002)
    if model == "translation":
        A[:, :2, :2] = np.eye(2, dtype=np.float32)
    frames = np.asarray(jwarp.warp_batch(jnp.asarray(np.repeat(tmpl[None], 4, 0)), jnp.asarray(A)))
    base = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    base[:, :2, 2] = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    want = np.asarray(jpolish.polish_transforms(
        jnp.asarray(frames), jnp.asarray(tmpl), jnp.asarray(base), model,
        valid_hw=jnp.asarray(VALID)))
    got = tpolish.polish_transforms(torch.as_tensor(frames), torch.as_tensor(tmpl),
                                    torch.as_tensor(base), model,
                                    valid_hw=torch.as_tensor(VALID)).numpy()
    assert _px(want, got) <= 1e-4
    ungated = tpolish.polish_transforms(torch.as_tensor(frames), torch.as_tensor(tmpl),
                                        torch.as_tensor(base), model).numpy()
    assert np.abs(got - base).max() > 1e-3  # the polish moved something
    assert np.abs(ungated - got).max() > 0  # and the gate changed what


def test_device_cast_matches_reference():
    vals = np.array([[-3.0, 0.4, 0.5, 1.5, 2.5, 65535.4, 70000.0, 1e9]], np.float32)
    for dt in ("uint16", "uint8", "int16", "int32"):
        want = np.asarray(jb._cast_corrected(jnp.asarray(vals), dt))
        got = tb.cast_corrected(torch.as_tensor(vals), np.dtype(dt)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- end to end against the reference's bucketed route ----------------------


@pytest.fixture(scope="module")
def jax_translation():
    """The reference's bucketed translation run with the polish off (its
    jax backend on the CPU), the port's, and the stack."""
    stack = np.asarray(_drift().stack, np.float32)
    kw = dict(model="translation", batch_size=4, max_keypoints=100, transform_polish=0,
              quality_metrics=True, plan_buckets=(BUCKET,))
    ref_mc = kcmc_tpu.MotionCorrector(backend="jax", **kw)
    return ref_mc, ref_mc.correct(stack), _port(stack, **kw), stack


def test_bucketed_translation_matches_reference_bucketed_run(jax_translation):
    _, want, got, _ = jax_translation
    assert np.abs(got.transforms - want.transforms).max() <= 1e-4
    for k in ("n_keypoints", "n_matches", "n_inliers", "warp_rescued"):
        np.testing.assert_array_equal(got.diagnostics[k], want.diagnostics[k])
    assert np.abs(got.corrected - want.corrected).max() <= 1e-4
    np.testing.assert_allclose(got.diagnostics["template_corr"],
                               want.diagnostics["template_corr"], rtol=0, atol=1e-5)
    pc, wpc = got.timing["plan_cache"], want.timing["plan_cache"]
    assert pc["bucket_padded"] == wpc["bucket_padded"] == 3
    assert pc["buckets"] == wpc["buckets"] == [list(BUCKET)]


def test_bucketed_reference_prep_matches_reference(jax_translation):
    """prepare_reference on a routable shape: detection on the padded
    frame masked to the true extent. xy, valid and descriptor words equal
    to the reference's bucketed preparation (both describe on the bucket
    canvas, so both means include the pad zeros); the true-shape
    template in "frame", the canvas in "_plan_frame"."""
    ref_mc, _, _, stack = jax_translation
    want = ref_mc.backend.prepare_reference(stack[0])
    port = tb.TorchBackend(CorrectorConfig(max_keypoints=100, transform_polish=0,
                                           plan_buckets=(BUCKET,)), device="cpu")
    got = port.prepare_reference(stack[0])
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["desc"].numpy(),
                                  np.asarray(want["desc"]).astype(np.uint32).astype(np.int64))
    assert tuple(got["frame"].shape) == SHAPE and tuple(got["_plan_frame"].shape) == BUCKET
    np.testing.assert_array_equal(np.asarray(want["_plan_frame"]), got["_plan_frame"].numpy())


def test_describe_mean_gap_between_bucketed_and_unbucketed_words():
    """The watch-list entry: the describe stage's finite mean runs over
    the whole canvas, pad zeros included, in both packages, so a few
    descriptor words of the bucketed reference differ from the
    unbucketed one's (keypoints and validity do not). Bound: at most 2%
    of the words, the same words in both packages."""
    frame = _drift(1, shape=(100, 120), seed=11).stack[0]
    big = (128, 128)

    def words(backend, f):
        d = backend.prepare_reference(f)
        return (np.asarray(d["desc"]).astype(np.uint32), np.asarray(d["xy"]),
                np.asarray(d["valid"]))

    cfg = dict(max_keypoints=100, transform_polish=0)
    jref = jb.JaxBackend(kcmc_tpu.CorrectorConfig(**cfg))
    jbuck = jb.JaxBackend(kcmc_tpu.CorrectorConfig(plan_buckets=(big,), **cfg))
    tref = tb.TorchBackend(CorrectorConfig(**cfg), device="cpu")
    tbuck = tb.TorchBackend(CorrectorConfig(plan_buckets=(big,), **cfg), device="cpu")
    jw, jb_ = words(jref, frame), words(jbuck, frame)
    tw, tbw = ({k: v.numpy() for k, v in b.prepare_reference(frame).items()}
               for b in (tref, tbuck))
    for a, b in ((jw, jb_), ((tw["desc"], tw["xy"], tw["valid"]),
                             (tbw["desc"], tbw["xy"], tbw["valid"]))):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        assert (a[0] != b[0]).sum() <= 0.02 * a[0].size
    differ_ref = jw[0] != jb_[0]
    differ_port = tw["desc"].astype(np.uint32) != tbw["desc"].astype(np.uint32)
    np.testing.assert_array_equal(differ_port, differ_ref)
    assert differ_ref.any()  # the gap is real: the watch entry stands


def test_bucketed_affine_polish_matches_reference_bucketed_run():
    """Affine 100x120 in a 128 bucket with the polish on: the port's
    bucketed run against the reference's bucketed run. Diagnostics and
    bucket counters equal; transforms within 1e-3 px at the corners and
    frames within 0.05 of max|frame| (the unbucketed affine polish slice
    already differs from the reference by ~2e-4 px in the same f32
    solves); both land on the same accuracy plateau."""
    data = _drift(8, (100, 120), model="affine", seed=1, drift=5.0)
    stack = np.asarray(data.stack, np.float32)
    truth = relative_transforms(data.transforms)
    kw = dict(model="affine", batch_size=4, max_keypoints=128, transform_polish=1,
              plan_buckets=(128,))
    want = kcmc_tpu.MotionCorrector(backend="jax", **kw).correct(stack)
    got = _port(stack, **kw)
    for k in ("n_keypoints", "n_matches", "n_inliers", "warp_rescued"):
        np.testing.assert_array_equal(got.diagnostics[k], want.diagnostics[k])
    assert _px(got.transforms, want.transforms, (100, 120)) <= 1e-3
    assert np.abs(got.corrected - want.corrected).max() <= 0.05 * np.abs(stack).max()
    assert got.timing["plan_cache"]["bucket_padded"] == want.timing["plan_cache"][
        "bucket_padded"] == 2
    r_got = transform_rmse(got.transforms, truth, (100, 120))
    r_want = transform_rmse(want.transforms, truth, (100, 120))
    assert abs(r_got - r_want) < 0.002
    plain = _port(stack, **dict(kw, plan_buckets=()))
    assert abs(r_got - transform_rmse(plain.transforms, truth, (100, 120))) < 0.02


# -- the port's own contracts -------------------------------------------------


@pytest.fixture(scope="module")
def drift_stack():
    return np.asarray(_drift().stack, np.float32)


def test_padded_route_equals_unbucketed_with_polish_off(drift_stack):
    kw = dict(quality_metrics=True)
    plain = _port(drift_stack, **kw)
    routed = _port(drift_stack, plan_buckets=(BUCKET,), **kw)
    assert np.abs(routed.transforms - plain.transforms).max() <= 1e-4
    assert np.abs(routed.corrected - plain.corrected).max() <= 1e-4
    for k in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(routed.diagnostics[k], plain.diagnostics[k])
    for k in ("template_corr", "coverage"):
        np.testing.assert_allclose(routed.diagnostics[k], plain.diagnostics[k], rtol=0, atol=1e-5)
    assert routed.timing["plan_cache"]["bucket_padded"] == 3


def test_uint16_pads_and_casts_identically():
    data = _drift(6, seed=5, drift=5.0)
    stack = np.clip(np.asarray(data.stack) * 40000, 0, 65535).astype(np.uint16)
    plain = _port(stack, output_dtype="input")
    routed = _port(stack, plan_buckets=(BUCKET,), output_dtype="input")
    assert routed.corrected.dtype == np.uint16
    np.testing.assert_array_equal(routed.corrected, plain.corrected)
    assert np.abs(routed.transforms - plain.transforms).max() <= 1e-4
    # the device-side cast of the batch program gives the host cast's frames
    be = tb.TorchBackend(CorrectorConfig(max_keypoints=100, transform_polish=0,
                                         plan_buckets=(BUCKET,)), device="cpu")
    ref = be.prepare_reference(stack[0].astype(np.float32))
    out = be.process_batch(stack[:4], ref, np.arange(4), cast_dtype=np.uint16)
    assert out["corrected"].dtype == np.uint16
    np.testing.assert_array_equal(out["corrected"], plain.corrected[:4])
    assert be.plan_cache_stats()["compile_counts"]["cast|50x70|uint16|full"] == 1


def test_rolling_templates_through_buckets():
    """Rolling updates (device blend) at the true shape, re-prepared
    through the bucket."""
    stack = np.asarray(_drift(12, seed=4, drift=5.0).stack, np.float32)
    kw = dict(template_update_every=5, template_window=4)
    plain = _port(stack, **kw)
    mc = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                        max_keypoints=100, transform_polish=0,
                                        plan_buckets=(BUCKET,), **kw)
    routed = mc.correct(stack)
    assert routed.timing["pipeline"]["template_updates"] == 2
    assert np.abs(routed.transforms - plain.transforms).max() <= 1e-4
    counts = mc.backend.plan_cache_stats()["compile_counts"]
    assert "update_reference|4x50x70|float32|full" in counts
    assert "reference|64x80|float32|full" in counts and len(
        [k for k in counts if k.startswith("reference|")]) == 1


def test_exact_and_fallback_counters(drift_stack):
    exact = np.asarray(_drift(6, shape=BUCKET, seed=2, drift=5.0).stack, np.float32)
    mc = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                        max_keypoints=100, transform_polish=0,
                                        plan_buckets=(BUCKET,))
    routed = mc.correct(exact)
    assert np.array_equal(routed.transforms, _port(exact).transforms)  # no pad: bit-equal
    stats = mc.backend.plan_cache_stats()
    assert (stats["bucket_exact"], stats["bucket_padded"], stats["bucket_fallback"]) == (2, 0, 0)
    small = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                           max_keypoints=100, transform_polish=0,
                                           plan_buckets=(32,))
    res = small.correct(drift_stack)
    assert np.array_equal(res.transforms, _port(drift_stack).transforms)
    stats = res.timing["plan_cache"]
    assert (stats["bucket_exact"], stats["bucket_padded"], stats["bucket_fallback"]) == (0, 0, 3)


def test_failover_backend_ignores_buckets(drift_stack):
    """The failover backend, the numpy oracle, accepts and ignores
    plan_buckets, so a bucketed config fails over without a scrub: the
    reference's own check of its numpy backend (tests/test_plans.py:
    224-235), plus the failover's reference and batch."""
    plain = _port(drift_stack, backend="numpy", device=None)
    routed = _port(drift_stack, backend="numpy", device=None, plan_buckets=(BUCKET,))
    np.testing.assert_array_equal(routed.transforms, plain.transforms)
    assert "plan_cache" not in routed.timing
    mc = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                        max_keypoints=100, transform_polish=0,
                                        plan_buckets=(BUCKET,), failover_backend="numpy")
    fb = mc._get_failover_backend()
    assert fb.name == "numpy" and fb.config.plan_buckets == ((64, 80),)
    assert fb.runtime_info()["plan_buckets_ignored"] == [[64, 80]]
    ref = fb.prepare_reference(drift_stack[0])
    assert "_plan_frame" not in ref
    out = fb.process_batch(drift_stack[:4], ref, np.arange(4))
    assert out["corrected"].shape == (4,) + SHAPE
    np.testing.assert_array_equal(out["transform"], plain.transforms[:4])


# -- warmup, the persistent cache and the retrace sentinel --------------------


def test_warmup_second_backend_hits_every_stamp(compile_cache):
    common = dict(model="translation", device="cpu", batch_size=4, max_keypoints=64,
                  plan_buckets=(48,), compile_cache_dir=compile_cache)
    w1 = kcmc_tpu_torch.MotionCorrector(**common).warmup()
    assert w1["programs_built"] == 3  # reference, register, apply
    assert w1["stamp_misses"] == 3 and w1["persistent"] is True
    assert w1["libraries"] == {}  # the CPU builds no kernel library
    w2 = kcmc_tpu_torch.MotionCorrector(**common).warmup()
    assert w2["stamp_misses"] == 0
    assert w2["stamp_hits"] == w1["stamp_hits"] + w1["stamp_misses"]
    stamps = os.listdir(os.path.join(compile_cache, "kcmc_plans"))
    assert len([s for s in stamps if s.endswith(".json")]) == 3


def test_warmup_requires_buckets_and_2d():
    with pytest.raises(ValueError, match="bucket"):
        kcmc_tpu_torch.MotionCorrector(device="cpu").warmup()
    with pytest.raises(ValueError, match="rigid3d"):
        kcmc_tpu_torch.MotionCorrector(model="rigid3d", device="cpu",
                                       plan_buckets=(64,)).warmup()


def test_warmed_correct_reports_plan_cache(compile_cache, drift_stack):
    mc = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                        max_keypoints=100, transform_polish=0,
                                        plan_buckets=(BUCKET,), compile_cache_dir=compile_cache,
                                        template_update_every=4)
    w = mc.warmup(dtypes=("float32", "uint16"))
    assert w["programs_built"] == 5  # reference, register x 2, update_reference, apply
    assert w["stamp_misses"] == 6  # and the uint16 cast
    res = mc.correct(drift_stack)
    pc = res.timing["plan_cache"]
    assert pc["enabled"] and pc["persistent"] and pc["bucket_padded"] == 3
    assert pc["cache_dir"] == os.path.abspath(compile_cache)
    assert np.abs(res.transforms - _port(drift_stack, template_update_every=4).transforms
                  ).max() <= 1e-4


def test_retrace_sentinel_after_warmup(drift_stack):
    mc = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu", batch_size=4,
                                        max_keypoints=64, transform_polish=0,
                                        plan_buckets=(BUCKET,))
    mc.warmup()
    sanitize.take_violations()
    predicted = truntime.predict_compile_keys(mc.config)
    with sanitize.retrace_sentinel(predicted=predicted, label="t") as st:
        mc.correct(drift_stack)
        assert st.violations == []
        mc.correct(np.asarray(_drift(4, shape=(90, 90), seed=1).stack, np.float32))
        stats = sanitize.sentinel_stats()
    got = sanitize.take_violations()
    assert len(got) == 2 and stats["armed"] and stats["violations"] == 2
    assert {(v.split("'")[1], "90x90" in v) for v in got} == {("reference", True),
                                                              ("register", True)}
    assert sanitize.take_violations() == [] and not sanitize.sentinel_stats()["armed"]


def test_kernel_library_dir_follows_the_active_cache(compile_cache):
    """Without a card nothing builds: the library paths resolve under
    the cache directory while it is active, under build/ otherwise."""
    default = cuda_build.lib_dir()
    assert default == cuda_build.BUILD_DIR
    tb.TorchBackend(CorrectorConfig(compile_cache_dir=compile_cache), device="cpu")
    want = os.path.join(os.path.abspath(compile_cache), "kcmc_tpu_torch_kernels")
    assert str(cuda_build.lib_dir()) == want
    assert str(cuda_build.target("warp").parent) == want
    with pytest.warns(RuntimeWarning, match="already active"):
        assert tcache.enable_compile_cache(compile_cache + "_other") == os.path.abspath(
            compile_cache)
    tcache.disable_compile_cache()
    assert cuda_build.lib_dir() == default
    assert not os.path.exists(want)


def test_stamp_hit_needs_the_program_libraries(compile_cache):
    """A stamp is a hit only while the kernel libraries its program
    launches were in the cache directory before a warmup's nvcc round:
    with them wiped (or just rebuilt), the next runtime misses that
    program's stamp (and re-stamps it), while a program that launches
    none still hits."""
    cfg = CorrectorConfig(compile_cache_dir=compile_cache, plan_buckets=(BUCKET,))

    def warm(fresh=()):
        rt = truntime.PlanRuntime(
            cfg, libraries=lambda p: ["detect"] if p == "reference" else [])
        rt.fresh.update(fresh)
        for program in ("reference", "quality"):
            with rt.timed(program, BUCKET, "float32"):
                pass
        return {e["program"]: e["stamp_hit"] for e in rt.stats()["events"]}

    tcache.enable_compile_cache(compile_cache)
    lib = cuda_build.target("detect")
    assert str(lib.parent).startswith(os.path.abspath(compile_cache))
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")  # stands for the built library; nothing loads it here
    assert warm() == {"reference": False, "quality": False}
    assert warm() == {"reference": True, "quality": True}
    stamps = [tcache.PlanCache(compile_cache).load(f[:-5]) for f in
              os.listdir(os.path.join(compile_cache, "kcmc_plans"))]
    assert sorted(s["libraries"] for s in stamps) == [[], [lib.name]]
    lib.unlink()
    assert warm() == {"reference": False, "quality": True}
    lib.write_bytes(b"")
    assert warm() == {"reference": True, "quality": True}
    # as if a warmup's nvcc round had just rebuilt it
    assert warm(fresh={lib}) == {"reference": False, "quality": True}


def test_backend_is_freed_without_the_garbage_collector():
    """The plan runtime holds its backend weakly: dropping a corrector
    frees its backend (and the backend's tensors) at once, with no
    reference cycle left for the collector."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        mc = kcmc_tpu_torch.MotionCorrector(device="cpu", plan_buckets=(BUCKET,))
        assert kernel_libraries(mc.backend, ("register",)) == []
        assert mc.backend._plan.libraries("register") == []  # the CPU launches none
        gone = weakref.ref(mc.backend)
        del mc
        assert gone() is None
    finally:
        if enabled:
            gc.enable()


def test_stamps_are_neither_keyed_nor_checked_without_a_cache():
    rt = truntime.PlanRuntime(CorrectorConfig(), libraries=lambda p: ["detect"])
    rt.program_stamp_key = None  # must not be called
    with rt.timed("register", SHAPE, "float32"):
        pass
    stats = rt.stats()
    assert stats["programs_compiled"] == 1 and not stats["persistent"]
    assert (stats["stamp_hits"], stats["stamp_misses"]) == (0, 0)
    assert stats["events"][0]["stamp_hit"] is None


def test_integer_outputs_cast_in_the_batch_program(tmp_path):
    """correct() and correct_file() cast integer outputs in the batch
    program (its 'cast' build) to the host cast's frames; a rolling
    template keeps float32 frames and casts on the host."""
    from kcmc_tpu_torch.corrector import _cast_output
    from kcmc_tpu_torch.io import write_stack

    stack = np.clip(np.asarray(_drift(6, seed=5, drift=5.0).stack) * 40000, 0,
                    65535).astype(np.uint16)
    f32 = _port(stack)
    kw = dict(model="translation", device="cpu", batch_size=4, max_keypoints=100,
              transform_polish=0)
    got_mc = kcmc_tpu_torch.MotionCorrector(**kw)
    got = got_mc.correct(stack, output_dtype="input")
    assert got.corrected.dtype == np.uint16
    np.testing.assert_array_equal(got.corrected, _cast_output(f32.corrected, np.uint16))
    # the CPU route compiles nothing, so its timing carries no
    # plan_cache (as the reference's numpy backend's); the backend
    # still counts the cast program's first run
    assert "plan_cache" not in got.timing
    assert got_mc.backend.plan_cache_stats()["compile_counts"]["cast|50x70|uint16|full"] == 1
    write_stack(str(tmp_path / "in.tif"), stack)
    mc = kcmc_tpu_torch.MotionCorrector(**kw)
    mc.correct_file(str(tmp_path / "in.tif"), output=str(tmp_path / "out.tif"))
    assert "cast|50x70|uint16|full" in mc.backend.plan_cache_stats()["compile_counts"]
    from kcmc_tpu_torch.io import open_stack

    np.testing.assert_array_equal(open_stack(str(tmp_path / "out.tif")).read(0, 6),
                                  got.corrected)
    roll = kcmc_tpu_torch.MotionCorrector(template_update_every=4, **kw)
    rolled = roll.correct(stack, output_dtype="input")
    assert rolled.corrected.dtype == np.uint16
    assert not [k for k in roll.backend.plan_cache_stats()["compile_counts"]
                if k.startswith("cast|")]


@pytest.mark.parametrize("kw,want", [
    (dict(), ["detect", "patch", "warp", "warp_matrix"]),
    (dict(model="affine"), ["detect", "patch", "warp_matrix"]),
    (dict(model="affine", max_keypoints=4096), ["detect", "moments", "patch", "select",
                                                "warp_matrix"]),
    (dict(model="similarity"), ["detect", "patch", "warp_matrix"]),
    (dict(match_precision="float32"), ["detect", "patches", "warp", "warp_matrix"]),
    (dict(model="piecewise"), ["detect", "patch", "warp_field"]),
    (dict(warp="jnp"), ["detect", "patch", "warp_matrix"]),
])
def test_warmup_kernel_libraries(kw, want):
    """The libraries warmup builds in its one nvcc round: those the
    config's programs launch on the card (the CPU builds none)."""
    be = tb.TorchBackend(CorrectorConfig(**kw), device="cpu")
    assert kernel_libraries(be, ("reference", "register", "apply")) == []
    be.device = torch.device("cuda")
    assert kernel_libraries(be, ("reference", "register", "apply")) == want
