"""The port's out-of-bound rescue policy and config checks against
kcmc_tpu: the warn / escalate rule on per-batch warp_ok sequences fed to
both correctors, the escalation end to end on a tiny stack, the knobs
`config_from_dict` carries, and the warp/model pairs and knob values
both packages reject."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu_torch.utils import synthetic as tsynthetic


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops, which torch's
    intra-op threads only slow down when several test processes share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_rescue(frames, out, ref=None):
    return np.zeros_like(frames)


def _policy_trace(mc, counts, B):
    """Feed one warp_ok array per batch (n frames, `bad` of them flagged,
    the last ones) to mc._rescue_flagged: per batch, the warning text it
    raised (or None) and whether the corrector had escalated."""
    mc.backend.rescue_warp = _stub_rescue
    trace = []
    for n, bad in counts:
        ok = np.arange(n) < n - bad
        host = {"warp_ok": ok, "corrected": np.zeros((n, 4, 4), np.float32),
                "transform": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))}
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mc._rescue_flagged(host, np.zeros((B, 4, 4), np.float32), n, None)
        msgs = [str(w.message) for w in rec if issubclass(w.category, RuntimeWarning)]
        assert len(msgs) <= 1
        trace.append((msgs[0] if msgs else None, mc._escalated))
    return trace


B = 32
CASES = {
    # 9 of the first 32 frames (28%) trip at once
    "cumulative_first_batch": [(B, 9)] + [(B, 0)] * 3,
    # 8 of 32 is exactly 25%: at the threshold, not over it
    "at_threshold": [(B, 8)] * 6 + [(17, 4)],
    # the cumulative rate climbs over 25% in the third batch
    "cumulative_later": [(B, 4), (B, 6), (B, 20), (B, 0)],
    # 40 clean batches dilute the cumulative rate; the window of the
    # newest >= 256 frames trips once 4 batches of 20 rescues are in it
    "late_onset_window": [(B, 0)] * 40 + [(B, 20)] * 6,
    # a first batch shorter than the batch size is counted, but the rule
    # waits for batch_size frames: it trips on the second batch
    "short_first_batch": [(5, 5), (B, 6), (B, 1)],
}


@pytest.mark.parametrize("escalate", [True, False], ids=["escalate", "warn_only"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rescue_policy_matches_reference(case, escalate):
    """The same batch trips the policy in both packages, with the same
    warning text, and escalates exactly when rescue_escalate is on."""
    kw = dict(batch_size=B, rescue_escalate=escalate)
    want = _policy_trace(kcmc_tpu.MotionCorrector(backend="jax", **kw), CASES[case], B)
    got = _policy_trace(kcmc_tpu_torch.MotionCorrector(device="cpu", **kw), CASES[case], B)
    assert got == want
    tripped = [i for i, (msg, _) in enumerate(got) if msg]
    if case == "at_threshold":
        assert tripped == []
    else:
        assert len(tripped) == 1
        assert got[-1][1] is escalate
        assert ("switching the remaining batches" in got[tripped[0]][0]) is escalate
    if case == "late_onset_window":
        assert tripped == [43]
    if case == "short_first_batch":
        assert tripped == [1]


class _StubBackend:
    """A batch program that only reports the warp_ok of a fed sequence
    (the bounded backend) or all True (the escalation backend), and logs
    which backend took each dispatched batch."""

    accepts_native_dtype = True

    def __init__(self, name, oks, log):
        self.name, self.oks, self.log = name, oks, log

    def process_batch_async(self, frames, ref, idx, **kw):
        b = len(self.log)
        self.log.append(self.name)
        n = len(idx)
        ok = self.oks[b] if self.name == "bounded" else np.ones(n, bool)
        return {"warp_ok": ok, "corrected": np.zeros((n, 4, 4), np.float32),
                "transform": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))}

    def stage_upload(self, frames):
        return frames

    def to_host(self, out):
        return {k: np.asarray(v) for k, v in out.items()}

    def rescue_warp(self, frames, out, ref=None):
        return np.zeros_like(frames)


def _dispatch_trace(mc, counts, B, port: bool):
    """Feed the warp_ok sequence through mc's pipelined dispatch core with
    stub backends: the backend that took each batch, in order."""
    oks, batches, lo = [], [], 0
    for n, bad in counts:
        ok = np.ones(B, bool)
        ok[n - bad:n] = False
        oks.append(ok)
        idx = np.concatenate([np.arange(lo, lo + n), np.full(B - n, lo + n - 1)])
        batches.append((n, np.zeros((B, 4, 4), np.float32), idx))
        lo += n
    log = []
    mc.backend = _StubBackend("bounded", oks, log)
    esc = _StubBackend("escalation", oks, log)
    mc._get_escalation_backend = lambda: esc
    mc._begin_robust_run()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if port:
            mc._reset_rescue_policy()

            def drain(n, host, kept, ref, failed):
                mc._rescue_flagged(host, kept, n, ref)

            mc._dispatch_batches(iter(batches), None, drain, keep_frames=True)
        else:
            def drain(entry):
                n, host, kept, ref = entry
                mc._rescue_flagged(dict(host), kept, n, ref)

            mc._dispatch_batches(iter(batches), None, drain, keep_frames=True)
    return log


@pytest.mark.parametrize("case", sorted(CASES))
def test_drain_time_escalation_matches_reference(case):
    """The escalation is decided when the tripping batch drains, with
    three batches in flight: in both packages the same batches take the
    escalation backend, the first of them three after the batch that
    tripped the policy (the port flipped on the next batch before its
    dispatch was pipelined)."""
    kw = dict(batch_size=B)
    want = _dispatch_trace(kcmc_tpu.MotionCorrector(backend="jax", **kw), CASES[case], B,
                           port=False)
    got = _dispatch_trace(kcmc_tpu_torch.MotionCorrector(device="cpu", **kw), CASES[case], B,
                          port=True)
    assert got == want and len(got) == len(CASES[case])
    trips = [i for i, (msg, _) in enumerate(_policy_trace(
        kcmc_tpu_torch.MotionCorrector(device="cpu", **kw), CASES[case], B)) if msg]
    first = got.index("escalation") if "escalation" in got else None
    if trips and trips[0] + 3 < len(got):
        assert first == trips[0] + 3
    else:
        assert first is None


def _shifted_stack(n_in, n_out, seed=2):
    """n_in frames shifted within K3's +-128 px window, then n_out shifted
    140 px, beyond it (the construction of test_torch_pipeline's rescue
    test)."""
    rng = np.random.default_rng(seed)
    scene = tsynthetic.render_scene(rng, (320, 320), n_blobs=300)
    frames = []
    for i in range(n_in + n_out):
        M = np.eye(3, dtype=np.float32)
        M[:2, 2] = (140.25, 3.5) if i >= n_in else (1.5 * i, -0.5 * i)
        frames.append(tsynthetic._warp_scene(scene, M))
    return np.stack(frames).astype(np.float32)


@pytest.fixture(scope="module")
def escalation_runs():
    # the flip is decided at drain, with three batches in flight: the
    # batch that trips it (batch 1) reaches drain after batch 3 is
    # dispatched, so batch 4 is the first on the escalation backend
    stack = _shifted_stack(2, 10)
    kw = dict(device="cpu", batch_size=2, max_keypoints=256)
    runs = {}
    for name, extra in (("auto", {}), ("warn_only", {"rescue_escalate": False}),
                        ("jnp", {"warp": "jnp"})):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res = kcmc_tpu_torch.MotionCorrector(**kw, **extra).correct(stack)
        runs[name] = (res, [str(w.message) for w in rec if w.category is RuntimeWarning])
    return stack, runs


def test_escalation_end_to_end(escalation_runs):
    """Batch 1 (frames 2-3) leaves K3's window: the policy warns at its
    drain, and the batches dispatched after it, from batch 4 on (batches
    2 and 3 were in flight), take the warp="jnp" backend, whose frames
    equal a warp="jnp" run's bit for bit (the RANSAC keys fold the global
    frame index). Before the flip the bounded route's frames and its
    rescues stand."""
    stack, runs = escalation_runs
    res, msgs = runs["auto"]
    assert res.timing["warp_escalated"] is True and res.escalated_at == 8
    assert len(msgs) == 1 and "switching the remaining batches" in msgs[0]
    np.testing.assert_array_equal(res.diagnostics["warp_rescued"],
                                  [False, False] + [True] * 6 + [False] * 4)
    jnp_res = runs["jnp"][0]
    np.testing.assert_array_equal(res.corrected[8:], jnp_res.corrected[8:])
    np.testing.assert_array_equal(res.transforms[8:], jnp_res.transforms[8:])
    assert np.abs(res.transforms[2:, 0, 2] - 140.25).max() < 0.1


def test_escalation_warn_only_and_warns(escalation_runs):
    """rescue_escalate=False warns once and rescues frame by frame to the
    end; the default run warns through warnings.warn as RuntimeWarning."""
    stack, runs = escalation_runs
    res, msgs = runs["warn_only"]
    assert res.timing["warp_escalated"] is False and res.escalated_at is None
    assert len(msgs) == 1 and "Use warp='jnp'" in msgs[0]
    np.testing.assert_array_equal(res.diagnostics["warp_rescued"], [False, False] + [True] * 10)
    assert runs["jnp"][0].timing["warp_escalated"] is False and not runs["jnp"][1]
    with pytest.warns(RuntimeWarning, match="exceeded the bounded warp kernel"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=2, max_keypoints=256).correct(
            stack[:4])


def test_policy_state_resets_per_correct(escalation_runs):
    """Every correct() starts with the counters at zero and the bounded
    warp: an escalated warm-up does not carry into the next run. (Batch 0
    of the ten out-of-window frames trips the policy at its drain;
    batch 3, frame 6 of the run, is the first on the escalation
    backend.)"""
    stack, _ = escalation_runs
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=2, max_keypoints=256,
                                        reference=stack[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert mc.correct(stack[2:]).escalated_at == 6
        res = mc.correct(stack[:2])
    assert res.timing["warp_escalated"] is False and mc._rescue_seen == 2


def test_step3_knobs_carry_across():
    jcfg = kcmc_tpu.CorrectorConfig(rescue_warn_fraction=0.4, rescue_escalate=False,
                                    match_tile=32, match_slack=1.5, match_radius=12.0)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for f in ("rescue_warn_fraction", "rescue_escalate", "match_tile", "match_slack",
              "match_radius"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.unsupported() == []


@pytest.mark.parametrize("knob", [("trace_path", "/tmp/x.json"),
                                  ("frame_records_path", "/tmp/r.jsonl"),
                                  ("heartbeat_s", 1.0)], ids=lambda k: k[0])
def test_fault_e_unported_observability_knobs_raise(knob, tmp_path, monkeypatch):
    """Queue 3 fault E, now that item 19a is ported: a reference config
    that arms a trace, per-frame records or a heartbeat carries that
    knob across, through config_from_dict and through MotionCorrector's
    keywords alike, and a run arms its artifact (the trace file, the
    records file, heartbeat lines) instead of silently writing none.
    (Before the port these knobs raised NotImplementedError.)"""
    from kcmc_tpu_torch.obs import heartbeat

    name, value = knob
    if name != "heartbeat_s":
        value = str(tmp_path / os.path.basename(value))
    jcfg = kcmc_tpu.CorrectorConfig(collective_chunks=4, **{name: value})
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    assert getattr(cfg, name) == value and cfg.collective_chunks == 4
    assert cfg.observability_enabled
    lines = []
    monkeypatch.setattr(heartbeat, "_default_emit", lines.append)
    arm = {name: 0.01 if name == "heartbeat_s" else value}
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=4, max_keypoints=64, **arm)
    stack = np.random.default_rng(0).random((8, 48, 48), np.float32)
    mc.correct(stack)
    assert mc._telemetry is None
    if name == "heartbeat_s":
        assert lines and "frames" in lines[-1]
    else:
        assert os.path.getsize(value) > 0


def test_fault_e_only_the_named_fields_are_dropped():
    """The reference fields the port does not declare are exactly the
    named table of dropped fields (each with its item and reason) and
    the three that raise; upload_overlap and collective_chunks carry
    across; a name no config has raises TypeError."""
    from kcmc_tpu_torch.config import DROPPED_FIELDS

    ref = {f.name for f in dataclasses.fields(kcmc_tpu.CorrectorConfig)}
    port = {f.name for f in dataclasses.fields(kcmc_tpu_torch.CorrectorConfig)}
    assert ref - port == set(DROPPED_FIELDS)
    assert all(item and reason for item, reason in DROPPED_FIELDS.values())
    jcfg = kcmc_tpu.CorrectorConfig(collective_chunks=4, upload_overlap=False, mesh_devices=2,
                                    serve_queue_depth=8, donate_buffers=False,
                                    fleet_dead_probes=6, fleet_queue_watermark=0.5)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.collective_chunks, cfg.upload_overlap, cfg.mesh_devices) == (4, False, 2)
    # the serve and fleet knobs carry across; only "none" items are dropped
    assert cfg.serve_queue_depth == 8
    assert (cfg.fleet_dead_probes, cfg.fleet_queue_watermark) == (6, 0.5)
    assert {item for item, _ in DROPPED_FIELDS.values()} == {"none"}
    with pytest.raises(TypeError, match="bogus_knob"):
        kcmc_tpu_torch.config_from_dict({"model": "translation", "bogus_knob": 1})
    with pytest.raises(TypeError, match="bogus_knob"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", bogus_knob=1)


@pytest.mark.parametrize(
    "kw",
    [
        {"model": "rigid", "warp": "pallas"},
        {"model": "affine", "warp": "pallas"},
        {"model": "similarity", "warp": "pallas"},
        {"model": "piecewise", "warp": "pallas"},
        {"model": "rigid3d", "warp": "pallas"},
        {"model": "similarity", "warp": "matrix"},
        {"model": "piecewise", "warp": "matrix"},
        {"model": "rigid3d", "warp": "matrix"},
        {"model": "piecewise", "warp": "separable"},
        {"model": "rigid3d", "warp": "separable"},
        {"warp": "bilinear"},
        {"match_radius": 0.0},
        {"match_radius": -4.0},
        {"match_tile": 12},
        {"match_tile": 18},
        {"match_slack": 0.5},
        {"rescue_warn_fraction": 0.0},
        {"rescue_warn_fraction": 1.5},
    ],
)
def test_reference_rejected_configs_raise_in_both(kw):
    """Warp/model pairs and knob values kcmc_tpu rejects raise ValueError
    in the port too, with the reference's message."""
    with pytest.raises(ValueError) as want:
        kcmc_tpu.CorrectorConfig(**kw)
    with pytest.raises(ValueError) as got:
        kcmc_tpu_torch.CorrectorConfig(**kw)
    assert str(got.value) == str(want.value)
