"""The port's own tooling against the reference's, on the CPU: the
latency histogram's quantiles and state, `honest_time` and `trace`,
`stage_breakdown`'s rows and errors, the roofline model (`stage_costs`
prices the same work as the reference's for every model, `judge` and
`achieved_rates` give its figures on the shared `cpu` row, and the peaks
table holds the host and the H100 only), the platform mapping, and the
selftest's check list (which needs a card). Nothing here compiles a JAX
program."""

import json

import numpy as np
import pytest
import torch

from kcmc_tpu.analysis import roofline as jroof
from kcmc_tpu.obs import latency as jlat
from kcmc_tpu_torch import selftest
from kcmc_tpu_torch.analysis import roofline as troof
from kcmc_tpu_torch.obs import latency as tlat
from kcmc_tpu_torch.utils import profiling

MODELS = ("translation", "rigid", "similarity", "affine", "homography", "piecewise")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: torch's intra-op threads only slow them
    down when several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# latency histogram


@pytest.mark.parametrize("seed", [0, 1])
def test_latency_histogram_matches_reference(seed):
    """The same recorded latencies give the reference's quantiles,
    buckets, summary and state; a merge of two halves equals the whole."""
    rng = np.random.default_rng(seed)
    xs = np.exp(rng.uniform(np.log(1e-7), np.log(200.0), 2000))
    hists = {}
    for mod in (jlat, tlat):
        h = mod.LatencyHistogram()
        for x in xs:
            h.record(float(x))
        h.record(0.004, n=7)
        hists[mod] = h
    j, t = hists[jlat], hists[tlat]
    assert t.counts == j.counts
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert t.quantile(q) == j.quantile(q)
    assert t.summary() == j.summary()
    assert t.to_dict() == j.to_dict()
    assert tlat.LatencyHistogram.from_dict(j.to_dict()).to_dict() == j.to_dict()
    a, b = tlat.LatencyHistogram(), tlat.LatencyHistogram()
    for i, x in enumerate(xs):
        (a if i % 2 else b).record(float(x))
    b.record(0.004, n=7)
    assert tlat.merge_histograms(a, b).to_dict() == t.to_dict()
    assert tlat.LatencyHistogram().quantile(50) is None


# ---------------------------------------------------------------------------
# timing and traces


def test_honest_time_on_the_cpu():
    x = torch.ones(1000)
    t = profiling.honest_time(torch.sum, x, iters=5, min_warmup_s=0.0, device="cpu")
    assert t > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_stage_breakdown_rows():
    """The reference's row keys (its stage_costs stages, less the
    transfer pseudo-stages, and frames_per_sec); every cumulative time
    positive. No ordering of timings is asserted: prefixes share a
    loaded host."""
    rows = profiling.stage_breakdown("translation", shape=(64, 64), batch_size=4, iters=1,
                                     device="cpu", max_keypoints=64)
    want = set(jroof.stage_costs("translation", (64, 64), 4)) - {"upload", "download"}
    assert set(rows) == want | {"frames_per_sec"}
    for name in want:
        assert set(rows[name]) == {"cumulative_ms", "incremental_ms"}
        assert rows[name]["cumulative_ms"] > 0.0
    assert rows["frames_per_sec"] > 0.0


@pytest.mark.parametrize("model", ["piecewise", "rigid3d"])
def test_stage_breakdown_rejects_non_matrix_models(model):
    from kcmc_tpu.utils import profiling as jprof

    errs = []
    for fn in (jprof.stage_breakdown, profiling.stage_breakdown):
        with pytest.raises(ValueError) as e:
            fn(model)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# the roofline model


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("K", [512, 4096])
def test_stage_costs_match_reference(model, K):
    """stage_costs prices the work, not its implementation: the
    reference's figures for every model, K, octave count and output
    choice."""
    for n_octaves in (1, 3):
        for emit in (True, False):
            kw = dict(max_keypoints=K, n_octaves=n_octaves, emit_frames=emit, in_itemsize=2)
            assert (troof.stage_costs(model, (512, 512), 32, **kw)
                    == jroof.stage_costs(model, (512, 512), 32, **kw))
    assert troof.total_costs(troof.stage_costs(model, (96, 80), 8)) == jroof.total_costs(
        jroof.stage_costs(model, (96, 80), 8))


@pytest.mark.parametrize("model", ["translation", "affine", "piecewise"])
def test_judge_and_achieved_rates_match_reference_on_cpu(model):
    """On the shared `cpu` row the verdict's figures are the
    reference's; its labels are each package's own names."""
    costs = jroof.stage_costs(model, (512, 512), 32, max_keypoints=4096)
    for measured in (1e-4, 0.05, 3.0):
        got = troof.judge(costs, measured, "cpu")
        want = jroof.judge(costs, measured, "cpu")
        labels = ("platform_label", "binding_label")
        assert {k: v for k, v in got.items() if k not in labels} == {
            k: v for k, v in want.items() if k not in labels}
        assert got["binding_label"] == troof.RESOURCE_NAMES[got["binding"]]
    secs = {"detect": 0.01, "describe": 0.02, "match": 0.0, "consensus": -1.0, "none": 1.0}
    assert troof.achieved_rates(costs, secs) == jroof.achieved_rates(costs, secs)
    assert set(troof.RESOURCE_NAMES) == set(jroof.RESOURCE_NAMES)


def test_peaks_hold_the_host_and_the_h100_only():
    assert sorted(troof.PEAKS) == ["cpu", "h100"]
    cpu = {k: v for k, v in troof.PEAKS["cpu"].items() if k != "label"}
    assert cpu == {k: v for k, v in jroof.PEAKS["cpu"].items() if k != "label"}
    assert troof.PEAKS["h100"] == {
        "label": "NVIDIA H100 80GB HBM3", "compute": 6.7e13, "vector": 6.7e13,
        "memory": 3.35e12, "vmem": None, "link": 6.4e10, "interconnect": None,
    }
    # the h100 verdict prices config 2's matrix work at the float32 rate
    costs = troof.stage_costs("affine", (512, 512), 32, max_keypoints=4096)
    v = troof.judge(costs, 0.07, "h100")
    match_s = (costs["match"]["flops"] + costs["consensus"]["flops"]) / 6.7e13
    assert v["time_at_peak_s"]["compute"] == round(match_s, 6)


def test_platform_mapping(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert troof.detect_platform() == "cpu"
    assert troof.platform_of("NVIDIA H100 80GB HBM3") == "h100"
    for other in ("NVIDIA A100-SXM4-40GB", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        with pytest.raises(ValueError, match=other):
            troof.platform_of(other)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA L4")
    with pytest.raises(ValueError, match="NVIDIA L4"):
        troof.detect_platform()


# ---------------------------------------------------------------------------
# selftest


def test_selftest_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        selftest.run_selftest()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        selftest.main([])


def test_selftest_checks_every_kernel_and_the_match():
    names = " ".join(name for name, _ in selftest.checks())
    for k in range(1, 12):
        assert f"K{k} " in names
    assert "match" in names and "pipeline" in names


def test_selftest_main_takes_the_references_size_and_depth(monkeypatch, capsys):
    """`--size` / `--depth` reach run_selftest as the reference's
    selftest passes them (size3d = (depth, size // 2, size // 2)); the
    per-check lines go to stderr and only the JSON summary to stdout."""
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return [{"name": "K1 detect_response 256x256", "ok": True, "detail": "equal"}]

    monkeypatch.setattr(selftest, "run_selftest", fake_run)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert selftest.main(["--size", "256", "--depth", "16"]) == 0
    assert seen == {"size": 256, "size3d": (16, 128, 128)}
    out, err = capsys.readouterr()
    summary = json.loads(out)
    assert summary["passed"] == 1 and summary["failed"] == 0
    assert "[selftest] PASS K1 detect_response 256x256" in err and "[selftest]" not in out
    selftest.main([])
    assert seen == {"size": 512, "size3d": (32, 256, 256)}
    names = [name for name, _ in selftest.checks(256, (16, 128, 128))]
    assert "K1 detect_response 256x256" in names and "K1 detect_response 2304x2304" in names
