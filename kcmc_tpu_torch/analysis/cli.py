"""`python -m kcmc_tpu_torch check`: run the port's invariant passes and
gate on the baseline (the port's copy of kcmc_tpu/analysis/cli.py).

Exit codes: 0 = no new error-severity findings (warnings and baselined
findings never block); 1 = new errors (or unjustified baseline
entries); 2 = usage problems (missing baseline file, bad root).

The default baseline ships inside the package
(`kcmc_tpu_torch/analysis/baseline.json`), so `check` works from any
checkout or install without flags; `--write-baseline` rewrites it from the
current findings with placeholder reasons for NEW entries — fill the
reasons in before committing (an empty reason is itself a finding).

Six passes run. The JAX package's `jit-purity`, `traceflow` and
`donation` check traced programs (jit purity, retrace/dtype/transfer
flow from every jit entry, buffer donation); the port runs eager
PyTorch and hand-written kernels and traces nothing, so the three do
not apply until the port captures programs (CUDA graphs or
`torch.compile`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def default_passes():
    from kcmc_tpu_torch.analysis.concurrency import RacePass, ThreadRootsPass
    from kcmc_tpu_torch.analysis.config_registry import ConfigRegistryPass
    from kcmc_tpu_torch.analysis.lifecycle import ResourceLifecyclePass
    from kcmc_tpu_torch.analysis.lock_discipline import LockDisciplinePass
    from kcmc_tpu_torch.analysis.span_registry import SpanRegistryPass

    return [
        ConfigRegistryPass(),
        LockDisciplinePass(),
        SpanRegistryPass(),
        ThreadRootsPass(),
        RacePass(),
        ResourceLifecyclePass(),
    ]


def find_repo_root(start: str | None = None) -> str:
    """The directory holding the `kcmc_tpu_torch/` package: walk up from
    this file (source checkouts), falling back to cwd."""
    here = os.path.dirname(os.path.abspath(__file__))
    cand = os.path.dirname(os.path.dirname(here))  # .../kcmc_tpu_torch/analysis
    if os.path.isdir(os.path.join(cand, "kcmc_tpu_torch")):
        return cand
    cwd = os.path.abspath(start or os.getcwd())
    if os.path.isdir(os.path.join(cwd, "kcmc_tpu_torch")):
        return cwd
    return cand


def default_baseline_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "baseline.json"
    )


def run_check(
    root: str,
    baseline_path: str | None = None,
    passes=None,
    use_cache: bool = True,
):
    from kcmc_tpu_torch.analysis.cache import CheckCache
    from kcmc_tpu_torch.analysis.core import Baseline, ModuleIndex, run_passes

    index = ModuleIndex.from_package(root)
    bl_path = baseline_path or default_baseline_path()
    baseline = Baseline.load(bl_path) if os.path.exists(bl_path) else None
    return run_passes(
        index,
        passes if passes is not None else default_passes(),
        baseline,
        cache=CheckCache(root) if use_cache else None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kcmc_tpu_torch check",
        description=(
            "AST-based invariant checker of the port: config-signature "
            "registry, lock/thread discipline, span registry, "
            "thread-root inventory, whole-program race detection and "
            "resource lifecycle"
        ),
    )
    ap.add_argument(
        "--root",
        default=None,
        help="repo root holding kcmc_tpu_torch/ (default: auto-detected)",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=(
            "baseline file of accepted findings (default: the "
            "checked-in kcmc_tpu_torch/analysis/baseline.json)"
        ),
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="machine-readable report on stdout (kind: kcmc_check)",
    )
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help=(
            "bypass the content-hash result cache "
            "(.kcmc_torch_check_cache/) and re-run every pass"
        ),
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help=(
            "rewrite the baseline from the current findings (new "
            "entries get a FILL-ME-IN reason; commit only after "
            "justifying each)"
        ),
    )
    ap.add_argument(
        "--prune-baseline",
        action="store_true",
        help=(
            "drop STALE baseline entries (entries whose finding no "
            "longer fires) and rewrite the file — the explicit cleanup "
            "mode behind the stale-entry warning"
        ),
    )
    ap.add_argument(
        "--sarif",
        default="",
        metavar="PATH",
        help=(
            "also write the NEW findings as a SARIF 2.1.0 log (GitHub "
            "code-scanning upload renders them as inline PR "
            "annotations); '-' for stdout"
        ),
    )
    args = ap.parse_args(argv)
    if args.json and args.sarif == "-":
        print(
            "kcmc check: --json and --sarif - both claim stdout; "
            "write the SARIF log to a file",
            file=sys.stderr,
        )
        return 2

    root = os.path.abspath(args.root) if args.root else find_repo_root()
    if not os.path.isdir(os.path.join(root, "kcmc_tpu_torch")):
        print(
            f"kcmc check: no kcmc_tpu_torch/ package under {root!r}",
            file=sys.stderr,
        )
        return 2
    bl_path = args.baseline or default_baseline_path()
    if args.baseline and not os.path.exists(bl_path):
        print(
            f"kcmc check: baseline {bl_path!r} does not exist",
            file=sys.stderr,
        )
        return 2

    try:
        result = run_check(
            root, baseline_path=bl_path, use_cache=not args.no_cache
        )
    except (ValueError, KeyError, OSError) as e:
        # a hand-edited baseline with bad JSON / wrong kind / missing
        # entry fields is a usage error (exit 2), not "new findings"
        print(
            f"kcmc check: cannot load baseline {bl_path!r}: {e}",
            file=sys.stderr,
        )
        return 2

    if args.write_baseline:
        from kcmc_tpu_torch.analysis.core import Baseline, BaselineEntry

        old = (
            Baseline.load(bl_path) if os.path.exists(bl_path) else Baseline()
        )
        # re-match against the current findings so still-firing entries
        # survive and stale ones drop out
        old.split(result.findings)
        entries = [e for e in old.entries if e.used]
        known = {(e.rule, e.path, e.match) for e in entries}
        for f in result.new:
            key = (f.rule, f.path, f.message)
            if key not in known:
                known.add(key)
                entries.append(
                    BaselineEntry(
                        rule=f.rule,
                        path=f.path,
                        match=f.message,
                        reason="FILL-ME-IN: justify or fix",
                    )
                )
        Baseline(entries).save(bl_path)
        print(
            f"kcmc check: wrote {len(entries)} baseline entries to "
            f"{bl_path}",
            file=sys.stderr,
        )

    if args.prune_baseline:
        from kcmc_tpu_torch.analysis.core import Baseline

        if not os.path.exists(bl_path):
            print(
                f"kcmc check: no baseline at {bl_path!r} to prune",
                file=sys.stderr,
            )
            return 2
        bl = Baseline.load(bl_path)
        bl.split(result.findings)  # marks still-firing entries used
        live = [e for e in bl.entries if e.used]
        pruned = len(bl.entries) - len(live)
        if pruned:
            Baseline(live).save(bl_path)
        print(
            f"kcmc check: pruned {pruned} stale baseline entr"
            f"{'y' if pruned == 1 else 'ies'} "
            f"({len(live)} live) in {bl_path}",
            file=sys.stderr,
        )
        if pruned:
            # the pruned file is the new truth: re-evaluate the gate so
            # a prune run reports the same exit the next plain run would
            result = run_check(
            root, baseline_path=bl_path, use_cache=not args.no_cache
        )

    if args.sarif:
        from kcmc_tpu_torch.analysis.sarif import to_sarif

        payload = json.dumps(to_sarif(result), indent=2)
        if args.sarif == "-":
            print(payload)
        else:
            with open(args.sarif, "w", encoding="utf-8") as f:
                f.write(payload + "\n")
            print(
                f"kcmc check: wrote SARIF log to {args.sarif}",
                file=sys.stderr,
            )

    if args.json:
        print(json.dumps(result.as_dict()))
    elif args.sarif == "-":
        # stdout is the SARIF document; the summary goes to stderr
        s = result.summary()
        print(
            f"kcmc check: {s['findings']} findings ({s['new']} new) -> "
            f"{'OK' if s['ok'] else 'FAIL'}",
            file=sys.stderr,
        )
    else:
        for f in result.new:
            print(f.format())
        for f in result.baseline_problems:
            print(f.format())
        s = result.summary()
        print(
            f"kcmc check: {s['findings']} findings "
            f"({s['baselined']} baselined, {s['new']} new, "
            f"{s['new_errors']} new errors, "
            f"{s['stale_baseline']} stale baseline) -> "
            f"{'OK' if s['ok'] else 'FAIL'}"
        )
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
