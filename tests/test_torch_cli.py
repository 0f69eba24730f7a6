"""The port's command line, `python -m kcmc_tpu_torch` (kcmc_tpu_torch/
__main__.py), held against the reference's (kcmc_tpu/__main__.py) on
16x64x64 uint16 TIFFs on the CPU: every ported subcommand's flags,
defaults and choices; `correct`'s summary keys against the reference's
`--backend numpy` run, its transforms bit-equal to an in-process
correct_file and within 1e-3 px of one reference `--backend jax` run;
the apply / stabilize / report / warmup / info workflows; `metrics` and
`trace` text against the reference's on the same artifacts; the error
paths' exit codes and messages; and the `-m` entry under the sanitizer
in child processes."""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kcmc_tpu_torch.__main__ import build_parser
from kcmc_tpu_torch.__main__ import main as tmain
from kcmc_tpu_torch.io import read_stack, write_stack
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("info", "selftest", "correct", "warmup", "sanitize", "metrics",
          "trace", "report", "apply", "stabilize", "serve", "router", "top", "check")
CPU = ("--device", "cpu")
BATCH = ("--batch-size", "8")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_cli_logging():
    """`main` routes the port's advisories through its logger with a
    handler on the captured stderr; undo it after every test."""
    yield
    from kcmc_tpu_torch.obs import log as tlog

    if tlog.cli_logging_active():
        tlog.reset_cli_logging()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data = make_drift_stack(16, (64, 64), model="translation", max_drift=4.0, seed=0)
    u16 = np.clip(data.stack * 40000, 0, 65535).astype(np.uint16)
    out = {"dir": d, "stack": u16, "tif": str(d / "s.tif"), "chan2": str(d / "c2.tif")}
    write_stack(out["tif"], u16)
    write_stack(out["chan2"], np.clip(data.stack * 20000 + 7, 0, 65535).astype(np.uint16))
    vol = np.random.default_rng(1).integers(0, 60000, (4 * 8, 32, 32)).astype(np.uint16)
    out["zstack"] = str(d / "z.tif")
    write_stack(out["zstack"], vol)  # 4 volumes of 8x32x32
    return out


def _json_out(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jmain(argv):
    from kcmc_tpu.__main__ import main

    return main(list(argv))


@pytest.fixture(scope="module")
def port_run(files):
    """One `--device cpu correct -o --transforms` run of the port: its
    summary (stdout), its npz and its output."""
    import contextlib
    import io

    d = files["dir"]
    npz, out = str(d / "t.npz"), str(d / "o.tif")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain([*CPU, "correct", files["tif"], "-o", out, "--transforms", npz, *BATCH])
    from kcmc_tpu_torch.obs import log as tlog

    tlog.reset_cli_logging()
    assert rc == 0
    return {"summary": json.loads(buf.getvalue().strip().splitlines()[-1]),
            "npz": npz, "out": out}


# -- flags ------------------------------------------------------------------


class _Captured(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser kcmc_tpu.__main__.main builds, caught at parse_args."""
    def capture(self, *a, **k):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        _jmain(["info", "x"])
    except _Captured as e:
        return e.args[0]
    finally:
        monkeypatch.undo()
    raise AssertionError("kcmc_tpu.__main__.main built no parser")


def _subparsers(ap) -> dict:
    (action,) = [a for a in ap._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _flags(p, skip=()) -> dict:
    out = {}
    for a in p._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        if a.dest in skip:
            continue
        out[a.dest] = (tuple(a.option_strings), type(a).__name__, a.default,
                       tuple(a.choices) if a.choices is not None else None,
                       a.nargs, a.type, a.required, a.const)
    return out


@pytest.mark.parametrize("cmd", PORTED)
def test_subcommand_flags_equal_the_reference(monkeypatch, cmd):
    """Each ported subcommand takes the reference's flags with its
    defaults and choices; `--backend` differs in its default (torch)."""
    ref = _subparsers(_reference_parser(monkeypatch))[cmd]
    port = _subparsers(build_parser())[cmd]
    want, got = _flags(ref), _flags(port)
    if "backend" in want:
        assert want.pop("backend")[:2] == (("--backend",), "_StoreAction")
        b = got.pop("backend")
        assert b[:2] == (("--backend",), "_StoreAction") and b[2] == "torch"
    assert got == want


def test_top_level_flags_and_unported_subcommands(monkeypatch, capsys, tmp_path):
    ref, port = _reference_parser(monkeypatch), build_parser()
    assert _flags(port, skip=("device",)) == _flags(ref)
    dev = [a for a in port._actions if a.dest == "device"][0]
    assert dev.option_strings == ["--device"] and dev.default is None
    assert set(_subparsers(port)) == set(PORTED)
    assert set(_subparsers(ref)) - set(PORTED) == set()
    # `check` is a command of its own now: a root without the port's
    # package is its usage error (exit 2), before any pass runs
    assert tmain(["check", "--root", str(tmp_path)]) == 2
    assert "no kcmc_tpu_torch/ package" in capsys.readouterr().err
    # the fleet's commands take only their own flags, as every other does
    for cmd in ("router", "top"):
        with pytest.raises(SystemExit) as e:
            tmain([cmd, "--bogus-flag"])
        assert e.value.code == 2
    capsys.readouterr()


# -- correct against the reference -------------------------------------------


def test_correct_summary_keys_equal_the_references(files, port_run, capsys):
    d = files["dir"]
    assert _jmain(["correct", files["tif"], "--backend", "numpy", *BATCH,
                   "-o", str(d / "ref_o.tif"), "--transforms", str(d / "ref.npz")]) == 0
    want = _json_out(capsys)
    got = port_run["summary"]
    assert set(got) == set(want)
    assert set(got["stages"]) == set(want["stages"])
    assert got["backend"] == "torch" and got["output"].endswith("o.tif")
    assert got["mean_inliers"] == want["mean_inliers"]
    assert got["warp_flagged_frames"] == want["warp_flagged_frames"] == 0


def test_correct_transforms_equal_correct_file_and_near_jax(files, port_run, capsys):
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.utils.metrics import transform_rmse

    npz = np.load(port_run["npz"])
    res = MotionCorrector(device="cpu", batch_size=8).correct_file(
        files["tif"], output=str(files["dir"] / "inproc.tif"))
    assert np.array_equal(npz["transforms"], res.transforms)
    assert np.array_equal(read_stack(port_run["out"]), read_stack(files["dir"] / "inproc.tif"))
    assert json.loads(str(npz["timing"]))["stages_s"]
    # the one reference backend="jax" end-to-end run of this file
    jnpz = str(files["dir"] / "jax.npz")
    assert _jmain(["correct", files["tif"], "--backend", "jax", *BATCH,
                   "--transforms", jnpz]) == 0
    capsys.readouterr()
    assert transform_rmse(npz["transforms"], np.load(jnpz)["transforms"], (64, 64)) <= 1e-3


@pytest.mark.parametrize("route", ["device_cpu", "numpy"])
def test_correct_numpy_backend_is_the_cpu(files, port_run, capsys, route):
    """`--device cpu` runs the torch backend's plain versions, equal to
    `port_run`; `--backend numpy` runs the NumPy oracle, whose transforms
    equal the reference CLI's `--backend numpy` ones by bytes."""
    npz = str(files["dir"] / f"{route}.npz")
    argv = ([*CPU, "correct", files["tif"]] if route == "device_cpu"
            else ["correct", files["tif"], "--backend", "numpy"])
    assert tmain([*argv, *BATCH, "--transforms", npz]) == 0
    s = _json_out(capsys)
    assert s["backend"] == ("torch" if route == "device_cpu" else "numpy")
    assert s["output"] is None
    if route == "device_cpu":
        want = np.load(port_run["npz"])["transforms"]
    else:
        jnpz = str(files["dir"] / "ref_numpy.npz")
        assert _jmain(["correct", files["tif"], "--backend", "numpy", *BATCH,
                       "--transforms", jnpz]) == 0
        capsys.readouterr()
        want = np.load(jnpz)["transforms"]
    assert np.load(npz)["transforms"].tobytes() == want.tobytes()


def test_correct_rigid3d_volumes(files, capsys):
    rc = tmain([*CPU, "correct", files["zstack"], "--model", "rigid3d", "--volume-depth", "8",
                "--batch-size", "2", "--max-keypoints", "64",
                "--transforms", str(files["dir"] / "z.npz")])
    assert rc == 0
    s = _json_out(capsys)
    assert set(s) >= {"model", "backend", "n_volumes", "volume_shape", "output", "mean_inliers"}
    assert s["n_volumes"] == 4 and s["volume_shape"] == [8, 32, 32]
    assert np.load(files["dir"] / "z.npz")["transforms"].shape == (4, 4, 4)


# -- workflows ---------------------------------------------------------------


def test_register_then_apply_to_a_second_channel(files, port_run, capsys):
    from kcmc_tpu_torch import apply_correction

    out = str(files["dir"] / "c2_out.tif")
    assert tmain([*CPU, "apply", files["chan2"], port_run["npz"], "-o", out]) == 0
    assert _json_out(capsys) == {"output": out, "applied": port_run["npz"]}
    want = apply_correction(read_stack(files["chan2"]), np.load(port_run["npz"])["transforms"],
                            output_dtype=np.uint16, device="cpu")
    assert np.array_equal(read_stack(out), want)


def test_stabilize_smooths_the_registration(files, port_run, capsys):
    from kcmc_tpu_torch.utils.trajectory import smooth_trajectory

    out, npz = str(files["dir"] / "stab.tif"), str(files["dir"] / "stab.npz")
    assert tmain([*CPU, "stabilize", files["tif"], "-o", out, *BATCH,
                  "--sigma", "3", "--transforms", npz]) == 0
    s = _json_out(capsys)
    assert set(s) == {"model", "sigma_frames", "output", "mean_inliers"}
    assert s["sigma_frames"] == 3.0
    want = smooth_trajectory(np.load(port_run["npz"])["transforms"], sigma=3.0)
    np.testing.assert_allclose(np.load(npz)["transforms"], want, atol=1e-6)
    got = read_stack(out)
    assert got.shape == files["stack"].shape and got.dtype == np.uint16


def test_report_renders_the_npz(port_run, capsys):
    assert tmain(["report", port_run["npz"]]) == 0
    text = capsys.readouterr().out
    assert "Stages:" in text and "register_batches" in text
    assert tmain(["report", port_run["npz"], "--json"]) == 0
    assert _json_out(capsys)["n_frames"] == 16


def test_warmup_builds_the_bucket(files, capsys):
    from kcmc_tpu_torch.plans.cache import disable_compile_cache

    try:
        rc = tmain([*CPU, "warmup", "--buckets", "48", "--batch-size", "4",
                    "--max-keypoints", "64", "--compile-cache", str(files["dir"] / "cache")])
        assert rc == 0
        stats = _json_out(capsys)
    finally:
        disable_compile_cache()
    assert stats["programs_built"] >= 2
    assert stats["persistent"] is True
    assert stats["buckets"] == [[48, 48]]
    assert "plan_cache" not in stats


def test_info_equals_the_references(files, capsys):
    assert tmain(["info", files["tif"]]) == 0
    got = _json_out(capsys)
    assert _jmain(["info", files["tif"]]) == 0
    assert got == _json_out(capsys)
    assert got["n_frames"] == 16 and got["frame_shape"] == [64, 64]


# -- pure parity: metrics and trace -----------------------------------------


def _metrics_snapshot() -> dict:
    from kcmc_tpu_torch.obs.latency import SegmentLatencies

    seg = SegmentLatencies()
    rng = np.random.default_rng(0)
    for name in ("request.device", "request.dispatch", "request.total"):
        for rung in ("full", "reduced"):
            for v in rng.lognormal(-4.0, 1.0, 40):
                seg.observe(name, float(v), rung=rung)
    hists = seg.hist_dicts()
    idx = next(iter(hists["request.total"]["full"]["counts"]))
    return {
        "plane": {"histograms": hists},
        "exemplars": {"request.total": {"full": {idx: {"trace_id": "ab\"c", "value_s": 0.0123}}}},
        "counters": {"frames_submitted": 640, "rejected": 3},
        "gauges": {"sessions_open": 2, "batch_occupancy": 0.75,
                   "queues": {"s1": 4, "s\n2": 0}},
        "slo": {"objectives": [{"name": "full_p99", "target": 0.99, "qos_class": "latency"},
                               {"name": "avail", "target": 0.999}],
                "burn_rates": {"full_p99": {"5m": 2.5, "1h": 0.4, "3d": None},
                               "avail": {"6h": 0.0}},
                "alerts": [{"objective": "full_p99"}]},
    }


def test_metrics_text_equals_the_references_render(files, capsys):
    from kcmc_tpu.obs.latency import render_prometheus

    snap = _metrics_snapshot()
    bare, wrapped = files["dir"] / "m.json", files["dir"] / "m_reply.json"
    bare.write_text(json.dumps(snap))
    wrapped.write_text(json.dumps({"ok": True, "metrics": snap}))
    want = render_prometheus(json.loads(bare.read_text()))
    for path in (bare, wrapped):
        assert tmain(["metrics", str(path), "--text"]) == 0
        assert capsys.readouterr().out == want
    assert tmain(["metrics", str(wrapped)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(bare.read_text())
    assert "kcmc_slo_burn_rate" in want and "trace_id=" in want


def test_trace_rows_equal_the_references(files, capsys):
    from kcmc_tpu_torch.obs.tracing import SpanShard, mint_span_id, mint_trace_id

    shard_dir = files["dir"] / "shards"
    shard = SpanShard(str(shard_dir / "p1.jsonl"))
    t0 = 1.7e9
    for i in range(4):
        tid, root = mint_trace_id(), mint_span_id()
        shard.complete("request.total", t0 + i, 0.05 * (i + 1), trace_id=tid, span_id=root)
        shard.complete("request.queue_wait", t0 + i, 0.01 * (i + 1), trace_id=tid,
                       parent_id=root)
        shard.complete("request.device", t0 + i + 0.01, 0.03 * (i + 1), trace_id=tid,
                       parent_id=root)
    shard.close()
    chrome = files["dir"] / "stitched.json"
    for extra in (["--json"], ["--slowest", "2", "--chrome", str(chrome)]):
        assert tmain(["trace", str(shard_dir), *extra]) == 0
        got = capsys.readouterr().out
        assert _jmain(["trace", str(shard_dir), *extra]) == 0
        assert got == capsys.readouterr().out
    assert tmain(["trace", str(shard_dir), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows["n_spans"] == 12 and rows["n_traces"] == 4
    assert rows["slowest"][0]["dominant"] == "request.device"
    assert json.loads(chrome.read_text())["traceEvents"]


# -- error paths --------------------------------------------------------------


def _exit(argv, fn=tmain):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return e.value.code


@pytest.mark.parametrize("case", ["rigid3d_depth", "buckets", "npz_keys"])
def test_error_exits_equal_the_references(files, case):
    bad = str(files["dir"] / "bad.npz")
    np.savez(bad, foo=np.zeros(3))
    argv = {
        "rigid3d_depth": ["correct", files["zstack"], "--model", "rigid3d"],
        "buckets": ["correct", files["tif"], "--buckets", "512,4x8y"],
        "npz_keys": ["apply", files["chan2"], bad, "-o", str(files["dir"] / "x.tif")],
    }[case]
    backend = ["--backend", "numpy"] if argv[0] == "correct" else []
    got = _exit([*CPU, *argv, *backend])
    want = _exit([*argv, *backend], fn=_jmain)
    assert isinstance(got, str) and got == want


def test_port_only_error_paths(files, capsys):
    # a live source with nothing listening: the reference's error
    for argv in (["metrics", "localhost:9"], ["trace", "localhost:9"]):
        with pytest.raises(ConnectionRefusedError):
            tmain(argv)
        with pytest.raises(ConnectionRefusedError):
            _jmain(argv)
    code = _exit(["correct", files["tif"], "--backend", "jax"])
    assert "python -m kcmc_tpu`" in code
    code = _exit(["--device", "cuda", "correct", files["tif"], "--backend", "numpy"])
    assert "--backend numpy runs on the CPU" in code
    code = _exit(["--device", "cuda", "router", "--spawn", "1", "--serve-args=--backend numpy"])
    assert "--backend numpy runs on the CPU" in code
    code = _exit([*CPU, "selftest"])
    assert "needs a CUDA card" in code
    code = _exit([*CPU, "correct", files["zstack"], "--model", "rigid3d", "--volume-depth",
                  "8", "--checkpoint", "c.npz"])
    assert code == ("--checkpoint is not supported with --model rigid3d (the volumetric "
                    "path runs in memory; use kcmc_tpu_torch.utils.checkpoint."
                    "ResumableCorrector from Python for chunk-level resume)")
    if not torch.cuda.is_available():
        assert "--device cpu" in _exit(["correct", files["tif"]])
        assert "--device cpu" in _exit(["serve", "--port", "0"])
        # a router spawns no replica on a device the caller did not name
        assert "--device cpu" in _exit(["router", "--spawn", "2", "--port", "0"])
        assert "needs a CUDA card" in _exit(["selftest", "--size", "256"])
    capsys.readouterr()


def test_sanitize_subcommand_passes_its_options(monkeypatch):
    calls = {}

    def fake_call(cmd, env=None):
        calls["cmd"], calls["env"] = cmd, env
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    rc = tmain(["sanitize", "--watchdog", "2", "--no-static", "--", "python", "-m",
                "kcmc_tpu_torch", "info", "x.tif"])
    assert rc == 0
    assert calls["cmd"] == ["python", "-m", "kcmc_tpu_torch", "info", "x.tif"]
    env = calls["env"]
    assert env["KCMC_SANITIZE"] == "1" and env["KCMC_SANITIZE_WATCHDOG"] == "2.0"
    assert env["KCMC_SANITIZE_STATIC"] == "0" and "KCMC_SANITIZE_STRICT" not in env


# -- the -m entry, in child processes ------------------------------------------


def test_module_entry_under_the_sanitizer(files):
    """`python -m kcmc_tpu_torch sanitize -- python -m kcmc_tpu_torch
    info`: two processes; the inner one is armed through the
    environment, prints the info line, reports the missing static graph
    (item 22) and 0 violations at exit."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for k in ("KCMC_SANITIZE", "KCMC_SANITIZE_STATIC", "KCMC_SANITIZE_STRICT"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "kcmc_tpu_torch", "sanitize", "--", sys.executable, "-m",
         "kcmc_tpu_torch", "info", files["tif"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["n_frames"] == 16 and info["dtype"] == "uint16"
    assert "runtime-only order checking" not in out.stderr
    assert "static lock-order graph unavailable" not in out.stderr
    static = re.search(r"edges \((\d+) static\)", out.stderr)
    assert static and int(static.group(1)) > 0, out.stderr
    assert "0 violation(s)" in out.stderr
