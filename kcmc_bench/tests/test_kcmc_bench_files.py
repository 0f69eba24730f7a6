"""Every name in BENCHMARK.json resolves to its files, and the file
keeps the benchmark contract's shape (CPU, no card)."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "kcmc_bench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["kcmc_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert NAME.fullmatch(entry["name"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # what the program is given is what the reference runs
    assert all(cfg["settings"][k] == v for k, v in cfg["corrector"].items())
    assert cfg["rmse"]["kind"] in ("transform", "field")
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(wl):
    assert NAME.fullmatch(wl["name"]) and wl["chips"] in (1, 4)
    assert 1 <= len(wl["why"]) <= 200
    assert wl["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    assert traffic["name"] == wl["traffic"]
    cfg = json.loads((ROOT / {c["name"]: c for c in BENCH["configs"]}[wl["config"]]["file"])
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{wl['name']}.json").read_text())
    gap = "field_gap_px" if cfg["rmse"]["kind"] == "field" else "transform_gap_px"
    assert set(limits) == {gap, "frame_gap"}
    reports = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
               if "workloads" not in m or wl["name"] in m["workloads"]]
    assert {"setup_s"} < {m["name"] for m in reports if m in BENCH["end_to_end"]}
    assert any(m in BENCH["per_layer"] for m in reports)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    path = HERE / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
