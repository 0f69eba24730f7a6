"""One run of one cell of the benchmark: set-up, the measured window, the
correctness check and the result line.

    python -m kcmc_bench --workload affine2k.rec512 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with a CUDA card. The cell
(`BENCHMARK.json` `workloads`) names a configuration
(`configs/<name>.json`: the corrector's settings, the scene, the error
measure) and a traffic mix (`traffic/<name>.json`: frame shape, length,
motion); `limits/<cell>.json` holds the correctness limits and
`metrics/<metric>.py` one reader per metric. Nothing here knows a cell
by name: a new cell is new files and entries.

The run makes the recording from `--seed` (kcmc_bench/gen.py), builds
the program's `MotionCorrector`, corrects the whole recording once as
the warm-up (every shape, library and allocation of the timed path),
then calls `correct(stack)` back to back, one caller in a closed loop,
and closes the window at the first call boundary after `--seconds`.
With `--trace 1` the calls of a shorter window run under torch.profiler
and the per-layer metrics are printed instead of the end-to-end ones.
After the window it reads the device's memory peak, frees the program,
checks that no JAX module was loaded, and judges a sample of the
window's outputs against the reference (kcmc_bench/reference). The last
line of standard output is the result; the numbers compared, each with
its limit, are the last lines of standard error and the result's last
key.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from kcmc_bench import gen
from kcmc_bench import trace as tr
from kcmc_bench.reference import compare, errors, oracle

ROOT = Path(__file__).resolve().parents[1]  # the checkout
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kcmc_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "CUDA_CACHE_PATH": "nv"}


def process_age_s() -> float:
    """Seconds since this process started (/proc), 0 where unreadable."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = float(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metric entries, found by name."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        wl = {w["name"]: w for w in bench["workloads"]}
        if name not in wl:
            raise SystemExit(f"kcmc_bench: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = wl[name]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]


class Run:
    """What the metric readers (metrics/<name>.py) read: the cell, the
    window's calls, the last call's error, the traced calls' counts and
    the trace summary."""

    def __init__(self, cell: Cell, settings):
        self.cell = cell
        self.settings = settings
        self.shape = tuple(cell.traffic["shape"])
        self.setup_s = 0.0
        self.calls: list[dict] = []  # {"start", "end", "frames", "counts"}
        self.rmse_px = math.nan
        self.trace = None  # trace.Summary of a --trace 1 run
        self.traced_calls: list[dict] = []

    def batches(self, calls) -> int:
        B = int(self.settings.batch_size)
        return sum(-(-c["frames"] // B) for c in calls)


def keep_call(res, start: float, end: float, frames: np.ndarray, settings, last: bool) -> dict:
    """What a call leaves for the metrics and the check: its counts, the
    sampled frames' outputs and, for the last call, its motion of every
    frame."""
    d = res.diagnostics
    key = "field" if settings.model == "piecewise" else "transform"
    motion = res.fields if key == "field" else res.transforms
    rescued = np.asarray(d.get("warp_rescued", np.zeros(len(motion), bool)), bool)
    rb = res.timing.get("robustness", {})
    ladder = (rb.get("failover_frames", 0) + rb.get("failed_frames", 0)
              + rb.get("device_retries", 0) * int(settings.batch_size))
    call = {
        "start": start, "end": end, "frames": len(motion), "ladder_frames": int(ladder),
        "counts": {k: np.asarray(d[k]).copy() for k in ("n_keypoints", "n_matches", "n_inliers")},
        "rescued": int(rescued.sum()),
        "samples": {
            "motion": {int(i): np.array(motion[i]) for i in frames},
            "corrected": {int(i): np.array(res.corrected[i]) for i in frames},
            "route": {int(i): compare.route(int(i), bool(rescued[i]), res.escalated_at)
                      for i in frames},
        },
    }
    if last:
        call["motion"] = np.array(motion)
    return call


def settings_differ(program_config, settings: dict) -> list[str]:
    """Names of the settings in which the program's resolved config
    departs from the configuration file's `settings`."""
    out = []
    for k, v in settings.items():
        got = getattr(program_config, k, None)
        if isinstance(got, tuple):
            got = list(got)
        if got != v:
            out.append(k)
    return out


def rmse_px(config: dict, motion: np.ndarray, truth, shape) -> float:
    """Registration error of every frame of a call against the
    generator's ground truth relative to frame 0, tiled as the recording
    tiles its distinct frames."""
    field = config["rmse"]["kind"] == "field"
    want = truth.fields - truth.fields[0] if field else errors.relative_transforms(truth.transforms)
    want = np.concatenate([want] * -(-len(motion) // len(want)))[:len(motion)]
    return errors.field_rmse(motion, want) if field else errors.transform_rmse(motion, want, shape)


def read_metric(entry: dict, run: Run):
    """The metric's reader (metrics/<name>.py `read(run)`): a number, or
    None where it found nothing to read."""
    path = HERE / "metrics" / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location(f"kcmc_bench.metrics.{entry['name']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def loaded_forbidden() -> list[str]:
    """Top-level names of JAX or the JAX package in sys.modules, compared whole."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_window(mc, stack, seconds: float, frames, settings, run: Run, trace: bool,
               sync) -> None:
    """The timed calls: whole calls of `correct(stack)` until `seconds`
    have passed, under the profiler with `trace`; `sync` waits for the
    device."""

    def calls():
        t_open = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            res = mc.correct(stack)
            sync()
            t1 = time.perf_counter()
            done = t1 - t_open >= seconds
            run.calls.append(keep_call(res, t0, t1, frames, settings, done))
            del res
            if done:
                return

    with warnings.catch_warnings():
        # the escalation's RuntimeWarning repeats on every call
        warnings.simplefilter("ignore")
        if not trace:
            calls()
            return
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(tr.WINDOW):
                calls()
                sync()
        run.trace = tr.summarize(prof)
        run.traced_calls = list(run.calls)


def set_cache_env() -> None:
    """Point the build and kernel caches at fixed directories inside the
    checkout (before the first CUDA call)."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / "build" / "kcmc_bench" / sub)


def corrector_kwargs(config: dict) -> dict:
    """The configuration's `corrector` block as MotionCorrector keywords."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["corrector"].items()}


def main(argv=None, device: str | None = None, cell: Cell | None = None) -> int:
    """One run; returns the exit code. Tests only: `device` skips the
    look for a card and runs the program there, `cell` replaces the
    workload's files."""
    started = time.time() - process_age_s()
    ap = argparse.ArgumentParser(prog="python -m kcmc_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell or Cell(args.workload)
    set_cache_env()
    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"kcmc_bench: {args.workload} needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"

    from kcmc_tpu_torch import MotionCorrector

    config, traffic = cell.config, cell.traffic
    settings = oracle.Settings(config["settings"])
    run = Run(cell, settings)
    stack, truth = gen.recording(config["scene"], traffic, args.seed)
    frames = compare.sample_frames(args.seed, len(stack), int(traffic["check_frames"]))
    mc = MotionCorrector(device=device, **corrector_kwargs(config))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mc.correct(stack)  # the warm-up: the whole recording once
    sync()
    run.setup_s = time.time() - started
    seconds = float(traffic["trace_min_s"]) if args.trace else args.seconds
    run_window(mc, stack, seconds, frames, settings, run, bool(args.trace), sync)
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    differ = settings_differ(mc.config, config["settings"])
    del mc
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    bad = loaded_forbidden()
    if bad:
        print(f"kcmc_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    last = run.calls[-1]
    run.rmse_px = rmse_px(config, last["motion"], truth, run.shape)
    reference = compare.reference_runs(stack, frames, settings)
    gaps = compare.judge(stack, [c["samples"] for c in run.calls], reference, settings)
    ladder = sum(c["ladder_frames"] for c in run.calls)
    checks = {"settings_differ": (len(differ), 0), "ladder_frames": (ladder, 0),
              "rmse_px": (run.rmse_px, config["rmse"]["limit_px"])}
    for k, v in gaps.items():
        checks[k] = (v, cell.limits[k])
    correct = all(v <= lim for v, lim in checks.values())

    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for e in entries:
        value = read_metric(e, run)
        if value is not None:
            metrics[e["name"]] = {"value": float(value), "unit": e["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": chips, "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": int(sum(c["frames"] for c in run.calls)),
            "failed": int(ladder), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    if differ:
        print(f"kcmc_bench: settings differ from the configuration: {differ}", file=sys.stderr)
    line["checks"] = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in checks.items()}
    print("calls " + " ".join(f"{c['frames']}:{c['end'] - c['start']:.4f}s" for c in run.calls),
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    return 0
