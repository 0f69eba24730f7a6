"""Readings for the correctness limits of a cell, on the card.

    python -m kcmc_bench.control --workload affine2k.rec512 --seconds 8 \
        --seeds 11 12 13 ... --control 3

For each seed, in one process: the recording, a short window of the
timed path (the benchmark's own `run_window`, whole calls of
`correct(stack)`), and the numbers the benchmark compares, read against
the float32 reference: the program's readings (a limit's lower end).
For the first `--control` seeds also the control's: the reference
computed in bfloat16 put in the program's place (a limit's upper end).
The references run on the host in worker processes while the card
works on the next seed. One JSON line per seed on standard output,
`{"seed", "program": {...}, "control": {...}}`, and a summary line
with each number's largest program reading and smallest control
reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import warnings
from concurrent.futures import ProcessPoolExecutor

import torch

from kcmc_bench import gen
from kcmc_bench.reference import compare, oracle
from kcmc_bench.run import Cell, Run, corrector_kwargs, rmse_px, run_window, set_cache_env


def judge_seed(config: dict, traffic: dict, seed: int, samples: list, control: bool) -> dict:
    """Worker: the reference of one seed's sampled frames, the program's
    readings and, with `control`, the control's."""
    stack, _ = gen.recording(config["scene"], traffic, seed)
    settings = oracle.Settings(config["settings"])
    frames = compare.sample_frames(seed, len(stack), int(traffic["check_frames"]))
    reference = compare.reference_runs(stack, frames, settings)
    out = {"seed": seed, "program": compare.judge(stack, samples, reference, settings)}
    if control:
        low = compare.control_samples(stack, frames, settings)
        out["control"] = compare.judge(stack, low, reference, settings)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kcmc_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    set_cache_env()
    if not torch.cuda.is_available():
        print("kcmc_bench.control: needs a CUDA card", file=sys.stderr)
        return 2
    from kcmc_tpu_torch import MotionCorrector

    config, traffic = cell.config, cell.traffic
    settings = oracle.Settings(config["settings"])
    mc = MotionCorrector(device="cuda", **corrector_kwargs(config))
    ctx = multiprocessing.get_context("spawn")
    env_threads = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    os.environ.update(env_threads)  # inherited by the spawned workers
    futures, rmse = [], {}
    with ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        for n, seed in enumerate(args.seeds):
            stack, truth = gen.recording(config["scene"], traffic, seed)
            frames = compare.sample_frames(seed, len(stack), int(traffic["check_frames"]))
            run = Run(cell, settings)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mc.correct(stack[: int(settings.batch_size)])
            run_window(mc, stack, args.seconds, frames, settings, run, False,
                       torch.cuda.synchronize)
            rmse[seed] = rmse_px(config, run.calls[-1]["motion"], truth, run.shape)
            samples = [c["samples"] for c in run.calls]
            futures.append(pool.submit(judge_seed, config, traffic, seed, samples,
                                       n < args.control))
            del stack, run
        lines = [f.result() for f in futures]
    worst, least = {}, {}
    for line in lines:
        line["program"]["rmse_px"] = rmse[line["seed"]]
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(lines),
                      "program_max": worst, "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
