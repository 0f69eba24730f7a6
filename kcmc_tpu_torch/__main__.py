"""Command-line interface of the port: `python -m kcmc_tpu_torch <command>`
(the port's copy of kcmc_tpu/__main__.py; the same subcommands, flags,
stdout summaries and exit codes).

    python -m kcmc_tpu_torch info stack.tif
    python -m kcmc_tpu_torch correct stack.tif -o corrected.tif \
        --model affine --transforms transforms.npz --progress
    python -m kcmc_tpu_torch correct structural.tif --transforms reg.npz
    python -m kcmc_tpu_torch apply functional.tif reg.npz -o func_corrected.tif
    python -m kcmc_tpu_torch stabilize video.tif -o stabilized.tif --sigma 15
    python -m kcmc_tpu_torch --device cpu correct stack.tif --transforms t.npz

Every command runs on the CUDA card unless `--device cpu` (before the
subcommand) asks for the CPU, where every kernel runs its plain PyTorch
version, or a subcommand's `--backend numpy` asks for the pure-NumPy
host oracle; with no card and neither, a command that corrects exits
with an error. `--backend` takes any registered backend
(`kcmc_tpu_torch.available_backends()`): `torch` (the default) or
`numpy`; `--backend jax` belongs to the JAX package's own command line,
`python -m kcmc_tpu`.

`correct` streams: chunks decode in a background thread (native TIFF
decoder), register on the card, and corrected frames append to the
output TIFF behind a background writer — constant host memory
regardless of stack length. Without `-o` it is registration-only (no
corrected-frame transfers at all — the fast first pass of the
`apply`/`stabilize` workflows). `apply` resamples any same-shape stack
through a saved registration (multi-channel microscopy); `stabilize`
removes motion faster than ~sigma frames and follows the rest.

`serve` keeps one warm backend resident on the card and multiplexes
many client streams through it (line-delimited JSON over TCP; drive it
with `kcmc_tpu_torch.serve.client.ServeClient`); its first stdout line
is the ready record with the bound port, its last the `served` record.
`router` is the fleet's front door over N such replicas (spawned with
`--spawn N` on the top-level `--device`, or adopted with `--replicas`):
the same protocol, rendezvous placement, health probing and live
migration through a shared journal directory; `top` is the live
dashboard over a replica, several, or a router.

Observability: `correct --trace t.json --frame-records f.jsonl
--heartbeat 30` exports a Perfetto-loadable span trace and a per-frame
quality JSONL while narrating progress to stderr; `report` renders
either artifact into a human-readable run report. `metrics` and `trace`
read a live server's `host:port` or dumped metrics and span shards.
`-v`/`-q` tune stderr logging; stdout stays machine-readable.
`KCMC_SANITIZE=1` (or `sanitize -- CMD`) arms the runtime concurrency
sanitizer for the process, whose lock-order check merges the static
graph that `check` builds. `check` runs the port's six invariant passes
(stdlib only, no card) against `kcmc_tpu_torch/analysis/baseline.json`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

def _device(args):
    """The device= a subcommand's correctors and applies run on: the
    top-level --device (the card by default), or the CPU for `--backend
    numpy`, the host oracle (a `stabilize`'s applies then run the plain
    PyTorch versions there). Refuses a name the registry lacks."""
    from kcmc_tpu_torch.backends import available_backends

    backend = getattr(args, "backend", "torch")
    if backend == "jax":
        raise SystemExit(
            "--backend jax runs the JAX package: use `python -m kcmc_tpu`; "
            "`python -m kcmc_tpu_torch` takes --backend torch (the card, "
            "or --device) or numpy (the pure-NumPy host oracle)"
        )
    if backend not in available_backends():
        raise SystemExit(
            f"unknown backend {backend!r}; available: {available_backends()}"
        )
    if backend == "numpy":
        if args.device not in (None, "cpu"):
            raise SystemExit(
                f"--backend numpy runs on the CPU; it cannot be combined "
                f"with --device {args.device}"
            )
        return "cpu"
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "no CUDA device is available; pass --device cpu to run "
                "the plain PyTorch versions of the kernels on the CPU (or "
                "--backend numpy for the pure-NumPy host oracle)"
            )
    return args.device


def _backend_kw(args) -> dict:
    """A subcommand's corrector backend and device."""
    return {"backend": args.backend, "device": _device(args)}


def _cmd_info(args) -> int:
    from kcmc_tpu_torch.io import TiffStack

    with TiffStack(args.stack) as ts:
        print(
            json.dumps(
                {
                    "path": args.stack,
                    "n_frames": ts.n_frames,
                    "frame_shape": list(ts.frame_shape),
                    "dtype": str(ts.dtype),
                    "decoder": ts.backend,
                }
            )
        )
    return 0


def _parse_buckets(spec: str) -> tuple:
    """CLI bucket-spec grammar: comma-separated entries, each a side
    (square bucket) or HxW (rectangular), e.g. "512,1024" or
    "480x640,1024"."""
    out: list = []
    try:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "x" in part:
                h, w = part.split("x", 1)
                out.append((int(h), int(w)))
            else:
                out.append(int(part))
    except ValueError:
        raise SystemExit(
            f"--buckets: cannot parse {spec!r} — expected comma-"
            "separated sides or HxW pairs, e.g. '512,1024' or '480x640'"
        ) from None
    return tuple(out)


def _parse_reference_and_overrides(args):
    """Shared CLI → MotionCorrector argument mapping (2D and 3D paths)."""
    ref = args.reference
    if ref not in ("first", "mean"):
        ref = int(ref)
    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.max_keypoints:
        overrides["max_keypoints"] = args.max_keypoints
    if args.hypotheses:
        overrides["n_hypotheses"] = args.hypotheses
    if args.warp:
        overrides["warp"] = args.warp
    if args.quality:
        overrides["quality_metrics"] = True
    if getattr(args, "template_update", 0):
        overrides["template_update_every"] = args.template_update
    if getattr(args, "octaves", 0):
        overrides["n_octaves"] = args.octaves
    if getattr(args, "match_radius", 0):
        overrides["match_radius"] = args.match_radius
    if getattr(args, "field_polish", -1) >= 0:
        overrides["field_polish"] = args.field_polish
    if getattr(args, "transform_polish", -1) >= 0:
        overrides["transform_polish"] = args.transform_polish
    if getattr(args, "inject_faults", ""):
        overrides["fault_plan"] = args.inject_faults
    if getattr(args, "writer_depth", -1) >= 0:
        overrides["writer_depth"] = args.writer_depth
    # --io-threads is the CLI spelling of CorrectorConfig.io_workers
    if getattr(args, "io_threads", 0):
        overrides["io_workers"] = args.io_threads
    if getattr(args, "io_prefetch", 0):
        overrides["io_prefetch"] = args.io_prefetch
    devices = getattr(args, "devices", None)
    if devices is not None:
        if devices == 0:
            # An EXPLICIT --devices 0 forces one device: clear the
            # ambient KCMC_DEVICES opt-in for this process so "explicit
            # wins over environment" holds for 0 too (mesh_devices=0
            # alone means "auto").
            import os

            os.environ.pop("KCMC_DEVICES", None)
        overrides["mesh_devices"] = devices
    # execution plans (kcmc_tpu_torch/plans): buckets opt into shape-
    # bucketed execution; the cache dir keeps the kernel libraries and
    # plan stamps (KCMC_COMPILE_CACHE also works)
    if getattr(args, "buckets", ""):
        overrides["plan_buckets"] = _parse_buckets(args.buckets)
    if getattr(args, "compile_cache", ""):
        overrides["compile_cache_dir"] = args.compile_cache
    # observability: all off by default
    if getattr(args, "trace", ""):
        overrides["trace_path"] = args.trace
    if getattr(args, "frame_records", ""):
        overrides["frame_records_path"] = args.frame_records
    if getattr(args, "heartbeat", 0):
        overrides["heartbeat_s"] = args.heartbeat
    return ref, overrides


def _cmd_correct(args) -> int:
    from kcmc_tpu_torch import MotionCorrector

    if args.model == "rigid3d":
        return _correct_volumetric(args)
    ref, overrides = _parse_reference_and_overrides(args)

    mc = MotionCorrector(
        model=args.model, reference=ref, **_backend_kw(args), **overrides
    )
    res = mc.correct_file(
        args.stack,
        output=args.output,
        compression=args.compression,
        progress=args.progress,
        n_threads=args.io_threads,
        output_dtype=args.output_dtype,
        checkpoint=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
        stall_abort=args.stall_exit or None,
        # No -o: the CLI discards corrected pixels (only --transforms
        # and the summary are written), so skip their device->host
        # transfer entirely — registration-only streaming.
        emit_frames=args.output is not None,
    )

    if args.transforms:
        payload = {k: v for k, v in res.diagnostics.items()}
        if res.transforms is not None:
            payload["transforms"] = res.transforms
        if res.fields is not None:
            payload["fields"] = res.fields
        if res.robustness is not None:
            # 0-d unicode array: readable back without allow_pickle
            payload["robustness"] = np.array(json.dumps(res.robustness))
        # stage/stall timing rides along so `report t.npz` can render
        # the stage table without the sidecar records file
        payload["timing"] = np.array(json.dumps(res.timing))
        np.savez(args.transforms, **payload)

    fps = res.frames_per_sec
    summary = {
        "model": args.model,
        "backend": args.backend,
        "output": args.output,
        "transforms": args.transforms,
        "frames_per_sec": round(fps, 2) if fps else None,
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"]))
        if "n_inliers" in res.diagnostics
        else None,
        # registration-failure detection: frames whose consensus is this
        # thin are suspect (the transforms npz has per-frame n_inliers)
        "min_inliers": int(np.min(res.diagnostics["n_inliers"]))
        if "n_inliers" in res.diagnostics
        else None,
    }
    # With rescue_warp on, warp_ok is rewritten to all-True after the
    # rescue pass; warp_rescued records which frames actually exceeded a
    # bounded kernel's motion bound, so report from it when present.
    if "warp_rescued" in res.diagnostics:
        summary["warp_flagged_frames"] = int(
            res.diagnostics["warp_rescued"].sum()
        )
    elif "warp_ok" in res.diagnostics:
        summary["warp_flagged_frames"] = int(
            (~res.diagnostics["warp_ok"]).sum()
        )
    if res.timing.get("warp_escalated"):
        summary["warp_escalated"] = True
    # Per-stage totals/counts/means: the coarse where-did-the-time-go
    # view.
    if res.timing.get("stages_s"):
        counts = res.timing.get("stage_counts", {})
        means = res.timing.get("stage_mean_s", {})
        summary["stages"] = {
            k: {
                "total_s": round(v, 3),
                "count": int(counts.get(k, 0)),
                "mean_s": round(means.get(k, 0.0), 4),
            }
            for k, v in res.timing["stages_s"].items()
        }
    # Pipeline-stall accounting: seconds the streaming consumer spent
    # blocked on each seam that should overlap.
    stalls = res.timing.get("stalls_s")
    if stalls:
        summary["stalls_s"] = {k: round(v, 3) for k, v in stalls.items()}
    if res.timing.get("pipeline"):
        summary["pipeline"] = res.timing["pipeline"]
    # Pooled-ingest accounting (io/feeder.py): present when the decode
    # pool or an object store fed the run, as in the reference's summary
    # (the port's timing also counts the plain prefetch thread's chunks)
    fd = res.timing.get("feeder")
    if fd and (fd.get("mode") != "prefetch" or "object" in fd):
        summary["feeder"] = fd
    pc = res.timing.get("plan_cache")
    if pc:
        # compact warm-up/build accounting (full events in `report`)
        summary["plan_cache"] = {
            k: pc.get(k, 0)
            for k in (
                "programs_compiled", "compile_s", "stamp_hits",
                "stamp_misses", "bucket_exact", "bucket_padded",
                "bucket_fallback",
            )
        }
    rb = res.robustness
    if rb is not None and any(rb.values()):
        # only when something actually happened
        summary["robustness"] = rb
    if "template_corr" in res.diagnostics:
        # nan-aware: registration-only runs NaN out frames whose QC
        # would have been measured against an unrescued zeroed warp
        corr = res.diagnostics["template_corr"]
        if np.isnan(corr).all():
            summary["template_corr_mean"] = None
            summary["template_corr_min"] = None
        else:
            summary["template_corr_mean"] = round(float(np.nanmean(corr)), 4)
            summary["template_corr_min"] = round(float(np.nanmin(corr)), 4)
    print(json.dumps(summary))
    return 0


def _correct_volumetric(args) -> int:
    """Config 5 from the CLI: a z-stack TIFF whose pages are D-deep
    volumes in acquisition order (page t*D + z = volume t, plane z).

    Volumetric registration needs whole volumes per batch, so this path
    loads the stack in memory rather than streaming pages.
    """
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.io import read_stack
    from kcmc_tpu_torch.io.tiff import write_stack

    D = args.volume_depth
    if D <= 0:
        raise SystemExit(
            "--model rigid3d requires --volume-depth D (pages per volume)"
        )
    if args.checkpoint:
        # The in-memory volumetric path has no streaming checkpoint;
        # refusing beats a user discovering post-kill that none existed.
        raise SystemExit(
            "--checkpoint is not supported with --model rigid3d (the "
            "volumetric path runs in memory; use "
            "kcmc_tpu_torch.utils.checkpoint.ResumableCorrector from Python "
            "for chunk-level resume)"
        )
    if args.stall_exit:
        raise SystemExit(
            "--stall-exit is not supported with --model rigid3d (the "
            "in-memory volumetric path has no progress watchdog)"
        )
    # Construct (and so config-validate) BEFORE the page read: a 2D-only
    # flag (--octaves, --match-radius) must fail fast.
    ref, overrides = _parse_reference_and_overrides(args)
    mc = MotionCorrector(
        model="rigid3d", reference=ref, **_backend_kw(args), **overrides
    )

    pages = read_stack(args.stack, n_threads=args.io_threads)
    T, rem = divmod(len(pages), D)
    if rem:
        raise SystemExit(
            f"{len(pages)} pages is not a whole number of {D}-deep volumes"
        )
    stack = pages.reshape(T, D, *pages.shape[1:])
    res = mc.correct(
        stack, progress=args.progress, output_dtype=args.output_dtype
    )
    if args.output:
        write_stack(
            args.output,
            res.corrected.reshape(T * D, *pages.shape[1:]),
            compression=args.compression,
            bigtiff=res.corrected.nbytes > 2**32 - (1 << 24),
        )
    if args.transforms:
        payload = dict(res.diagnostics)
        payload["transforms"] = res.transforms
        np.savez(args.transforms, **payload)
    summary = {
        "model": "rigid3d",
        "backend": args.backend,
        "n_volumes": T,
        "volume_shape": [D, *pages.shape[1:]],
        "output": args.output,
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"])),
    }
    if "template_corr" in res.diagnostics:
        summary["template_corr_mean"] = round(
            float(np.mean(res.diagnostics["template_corr"])), 4
        )
    print(json.dumps(summary))
    return 0


def _cmd_apply(args) -> int:
    """Apply previously-recovered transforms to another stack file —
    the multi-channel workflow's pass 2 (register the structural
    channel with `correct --transforms reg.npz`, apply to each
    functional channel's file)."""
    from kcmc_tpu_torch import apply_correction_file

    data = np.load(args.transforms)
    if "transforms" in data:
        kind = {"transforms": data["transforms"]}
    elif "fields" in data:
        kind = {"fields": data["fields"]}
    else:
        raise SystemExit(
            f"{args.transforms} contains neither 'transforms' nor 'fields' "
            "— was it written by `correct --transforms`? (keys: "
            f"{sorted(data.keys())})"
        )
    apply_correction_file(
        args.stack,
        args.output,
        **kind,
        compression=args.compression,
        output_dtype=args.output_dtype,
        n_threads=args.io_threads,
        progress=args.progress,
        io_prefetch=args.io_prefetch,
        device=_device(args),
    )
    print(json.dumps({"output": args.output, "applied": args.transforms}))
    return 0


def _cmd_stabilize(args) -> int:
    """Two-pass stabilization: registration-only streaming pass (no
    corrected-frame transfers), temporal low-pass of the trajectory,
    then stream the ORIGINAL frames through the stabilizing warps."""
    from kcmc_tpu_torch import MotionCorrector, apply_correction_file
    from kcmc_tpu_torch.utils.trajectory import smooth_trajectory

    ref, overrides = _parse_reference_and_overrides(args)
    device = _device(args)
    mc = MotionCorrector(
        model=args.model, reference=ref, backend=args.backend, device=device, **overrides
    )
    res = mc.correct_file(
        args.stack,
        progress=args.progress,
        n_threads=args.io_threads,
        emit_frames=False,
    )
    if res.transforms is not None:
        stab = {"transforms": smooth_trajectory(res.transforms, sigma=args.sigma)}
    else:
        stab = {"fields": smooth_trajectory(fields=res.fields, sigma=args.sigma)}
    apply_correction_file(
        args.stack,
        args.output,
        **stab,
        compression=args.compression,
        output_dtype=args.output_dtype,
        n_threads=args.io_threads,
        progress=args.progress,
        io_prefetch=args.io_prefetch,
        device=device,
    )
    summary = {
        "model": args.model,
        "sigma_frames": args.sigma,
        "output": args.output,
        "mean_inliers": float(np.mean(res.diagnostics["n_inliers"]))
        if "n_inliers" in res.diagnostics
        else None,
    }
    if args.transforms:
        np.savez(args.transforms, **stab, **dict(res.diagnostics))
    print(json.dumps(summary))
    return 0


def _cmd_warmup(args) -> int:
    """Pre-populate the execution-plan caches for a config set: run
    every hot program per declared shape bucket (and dtype), building
    the kernel libraries into the compile cache and stamping it, so the
    NEXT process starts warm. Prints one JSON line of build stats;
    `stamp_misses == 0` means everything was found in a previous run's
    cache."""
    from kcmc_tpu_torch import MotionCorrector

    ref, overrides = _parse_reference_and_overrides(args)
    # passed explicitly below (the shared mapper also collects it)
    overrides.pop("template_update_every", None)
    mc = MotionCorrector(
        model=args.model, reference=ref, **_backend_kw(args),
        template_update_every=args.template_update, **overrides,
    )
    dtypes = tuple(
        d.strip() for d in args.dtypes.split(",") if d.strip()
    ) or ("float32",)
    try:
        stats = mc.warmup(dtypes=dtypes, progress=args.progress)
    except ValueError as e:
        raise SystemExit(f"warmup: {e}") from None
    # drop the verbose backend snapshot; the build summary (programs,
    # stamp hits/misses, seconds) is the contract surface
    stats.pop("plan_cache", None)
    print(json.dumps(stats))
    return 0


def _cmd_check(args) -> int:
    """The port's invariant checker (analysis/cli.py): AST passes over
    the package enforcing the config-signature registry, lock/thread
    discipline, the telemetry span registry, the thread-root inventory,
    whole-program races and resource lifecycles, gated on a checked-in
    baseline. Exit 0 = no new errors, 1 = new errors, 2 = usage."""
    from kcmc_tpu_torch.analysis.cli import main as check_main

    argv = []
    if args.root:
        argv += ["--root", args.root]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.json:
        argv.append("--json")
    if args.write_baseline:
        argv.append("--write-baseline")
    if args.prune_baseline:
        argv.append("--prune-baseline")
    if args.sarif:
        argv += ["--sarif", args.sarif]
    if args.no_cache:
        argv.append("--no-cache")
    return check_main(argv)


def _cmd_sanitize(args) -> int:
    """Run a command under the runtime concurrency sanitizer:
    instrumented locks with lock-order validation, a deadlock watchdog
    that dumps every thread's stack, and leak checking."""
    from kcmc_tpu_torch.analysis.sanitize import main as sanitize_main

    argv = []
    if args.watchdog != 10.0:
        argv += ["--watchdog", str(args.watchdog)]
    if args.no_static:
        argv.append("--no-static")
    if args.strict:
        argv.append("--strict")
    return sanitize_main(argv + args.cmd)


def _cmd_report(args) -> int:
    """Render a human-readable run report from either run artifact:
    a --frame-records JSONL or a `correct --transforms` npz."""
    from kcmc_tpu_torch.obs.report import main as report_main

    return report_main(args.artifact, top=args.top, as_json=args.json)


def _cmd_metrics(args) -> int:
    """Scrape a serve process's request-latency/health metrics: JSON by
    default, Prometheus text exposition with --text. `source` is
    host:port of a live server, or a previously dumped metrics JSON
    file."""
    import os

    from kcmc_tpu_torch.obs.latency import render_prometheus
    from kcmc_tpu_torch.obs.top import parse_addr

    if os.path.isfile(args.source):
        with open(args.source, encoding="utf-8") as f:
            snap = json.load(f)
        # accept either the raw verb reply ({"ok":..,"metrics":..})
        # or a bare payload dumped earlier by this command
        m = snap.get("metrics", snap)
    else:
        host, port = parse_addr(args.source)
        from kcmc_tpu_torch.serve.client import ServeClient

        with ServeClient(host=host, port=port) as c:
            m = c.metrics()
    if args.text:
        print(render_prometheus(m), end="")
    else:
        print(json.dumps(m))
    return 0


def _cmd_trace(args) -> int:
    """Stitch distributed request traces from span shards on disk and/or
    a live server's `trace` verb, and render the slowest requests with
    their critical path — which lifecycle segment dominated each."""
    import os

    from kcmc_tpu_torch.obs.tracing import (
        chrome_trace,
        collect_spans,
        critical_path,
        slowest,
        stitch,
    )

    spans: list = []
    for src in args.sources:
        if os.path.exists(src):
            spans.extend(collect_spans([src]))
        else:
            from kcmc_tpu_torch.obs.top import parse_addr
            from kcmc_tpu_torch.serve.client import ServeClient

            host, port = parse_addr(src)
            with ServeClient(host=host, port=port) as c:
                spans.extend(c.trace_dump())
    traces = stitch(spans)
    if args.chrome:
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump(chrome_trace(spans), f)
    rows = slowest(traces, n=args.slowest)
    if args.json:
        print(
            json.dumps(
                {
                    "kind": "kcmc_trace",
                    "n_spans": len(spans),
                    "n_traces": len(traces),
                    "slowest": rows,
                }
            )
        )
        return 0
    print(f"{len(traces)} traces / {len(spans)} spans")
    if rows:
        print(
            f"  {'trace':<32} {'total':>10} {'spans':>6}  dominant"
        )
        for r in rows:
            tot = (
                f"{r['total_s'] * 1e3:.1f}ms"
                if r.get("total_s") is not None
                else "—"
            )
            print(
                f"  {r['trace_id']:<32} {tot:>10} "
                f"{r['n_spans']:>6}  {r.get('dominant') or '—'}"
            )
        # segment breakdown of the slowest request — the "why"
        cp = critical_path(traces[rows[0]["trace_id"]])
        parts = ", ".join(
            f"{seg.split('.', 1)[-1]}={dur * 1e3:.1f}ms"
            for seg, dur in sorted(
                (cp.get("segments") or {}).items(),
                key=lambda kv: -kv[1],
            )
        )
        if parts:
            print(f"  slowest breakdown: {parts}")
    if args.chrome:
        print(f"chrome trace written to {args.chrome}")
    return 0


def _cmd_serve(args) -> int:
    """Resident multi-tenant serving: one warm backend on the card, many
    concurrent client streams multiplexed through it (docs/SERVING.md).
    The first stdout line is a machine-readable ready record with the
    bound port; drive it with kcmc_tpu_torch.serve.client.ServeClient.
    Without a card it exits unless `--device cpu` (or `--backend numpy`)
    asks for the plain versions."""
    # --reference is parser-restricted to 'first': "mean"/index
    # references need the whole stack up front, which a stream never
    # has — clients send an explicit reference array at open_session.
    ref, overrides = _parse_reference_and_overrides(args)
    # serve_main passes template_update_every explicitly, and the serve
    # plane owns the AGGREGATE heartbeat (args.heartbeat goes to
    # ServeServer) — per-run heartbeats stay off.
    overrides.pop("template_update_every", None)
    overrides.pop("heartbeat_s", None)
    if args.queue_depth:
        overrides["serve_queue_depth"] = args.queue_depth
    if args.inflight:
        overrides["serve_inflight"] = args.inflight
    if args.degrade_watermark is not None:
        overrides["serve_degrade_watermark"] = args.degrade_watermark
    # journaling/reap/transport knobs into the scheduler's shared
    # corrector config; the config's eager validation rejects a typo'd
    # fault plan or SLO spec BEFORE the ready line
    if args.journal_dir:
        overrides["serve_journal_dir"] = args.journal_dir
    if args.journal_every is not None:
        # `is not None`: an explicit 0 must reach the validator
        overrides["serve_journal_every"] = args.journal_every
    if args.session_timeout is not None:
        overrides["serve_session_timeout_s"] = args.session_timeout
    if args.io_timeout is not None:
        overrides["serve_io_timeout_s"] = args.io_timeout
    if args.trace_shards:
        overrides["trace_shard_dir"] = args.trace_shards
    if args.slo:
        overrides["slo_objectives"] = args.slo
    # latency QoS: scheduling-timing knobs only
    if args.latency_fill_floor is not None:
        overrides["serve_latency_fill_floor"] = args.latency_fill_floor
    if args.no_latency_admission:
        overrides["serve_latency_admission"] = False
    if args.starvation_limit is not None:
        overrides["serve_latency_starvation_limit"] = args.starvation_limit
    args.device = _device(args)
    args.reference = ref
    args.overrides = overrides
    from kcmc_tpu_torch.serve.server import serve_main

    return serve_main(args)


def _cmd_router(args) -> int:
    """Fleet front door (docs/SERVING.md "Running a fleet"): spawn
    and/or adopt serve replicas, health-check them by scraping their
    metrics/stats verbs, place sessions by rendezvous hashing, and
    live-migrate streams off dead or draining replicas through the
    shared journal directory. Speaks the same protocol as `serve` —
    point any ServeClient (or `top`) at the router. Spawned replicas
    run on the top-level `--device`: without a card the command exits
    unless `--device cpu` or a `--backend numpy` in `--serve-args`
    asks for the CPU; the router itself never touches a device."""
    import shlex

    if args.spawn or args.autoscale:
        # the replicas' own arguments and device rule, checked before
        # any spawns
        serve = build_parser().parse_args(["serve", *shlex.split(args.serve_args or "")])
        serve.device = args.device
        _device(serve)
    from kcmc_tpu_torch.serve.router import router_main

    return router_main(args)


def _cmd_top(args) -> int:
    """Live terminal dashboard over a serve replica: per-session
    fps/queue depth, segment latency p50/p99, supervisor state."""
    from kcmc_tpu_torch.obs.top import main as top_main

    return top_main(args)


def _cmd_selftest(args) -> int:
    """On-card kernel parity checks: needs the card, never falls back."""
    import torch

    if args.device == "cpu" or not torch.cuda.is_available():
        raise SystemExit(
            "selftest needs a CUDA card: it holds each hand-written kernel "
            "against its plain version on the card (there is no CPU "
            "fallback)"
        )
    from kcmc_tpu_torch.selftest import main as selftest_main

    argv = ["--size", str(args.size), "--depth", str(args.depth)]
    return selftest_main(argv)


_MODELS_2D = ["translation", "rigid", "similarity", "affine", "homography",
              "piecewise"]
_WARPS = ["", "auto", "jnp", "pallas", "separable"]
_COMPRESSIONS = ["none", "deflate", "packbits"]


def _backend_arg(p) -> None:
    p.add_argument(
        "--backend", default="torch",
        help="a registered backend: torch (default: the hand-written "
        "CUDA kernels on the card, or their plain PyTorch versions with "
        "the top-level --device cpu) or numpy (the pure-NumPy host "
        "oracle, on the CPU); jax is the JAX package's (python -m kcmc_tpu)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m kcmc_tpu_torch",
        description="keypoint-consensus motion correction on a CUDA card "
        "(the PyTorch port of kcmc_tpu)",
    )
    ap.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="more logging on stderr (-v: INFO, -vv: DEBUG); "
        "machine-readable summaries stay on stdout",
    )
    ap.add_argument(
        "-q", "--quiet", action="count", default=0,
        help="less logging on stderr (-q: errors only, -qq: critical)",
    )
    ap.add_argument(
        "--device", default=None,
        help="device every corrector and apply of the command runs on "
        "(default: the CUDA card, and an error without one; 'cpu' runs "
        "the kernels' plain PyTorch versions)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="describe a TIFF stack")
    p.add_argument("stack")
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser(
        "selftest",
        help="on-card kernel parity checks (each CUDA kernel against its "
        "plain PyTorch version; needs the card)",
    )
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--depth", type=int, default=32)
    p.set_defaults(fn=_cmd_selftest)

    p = sub.add_parser("correct", help="register + correct a stack")
    p.add_argument("stack", help="input multi-page TIFF")
    p.add_argument("-o", "--output", help="corrected-stack TIFF to write")
    p.add_argument("--model", default="translation",
                   choices=_MODELS_2D + ["rigid3d"])
    p.add_argument(
        "--volume-depth", type=int, default=0,
        help="rigid3d: pages per volume (page t*D+z = volume t, plane z)",
    )
    _backend_arg(p)
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard frame batches over the first N cards (1-D "
        "frame-axis mesh, reference gathered on the card; -1 = all "
        "visible cards; an explicit 0 forces one device even when "
        "KCMC_DEVICES is set; default: one device unless KCMC_DEVICES "
        "says otherwise)",
    )
    p.add_argument("--reference", default="0",
                   help="frame index, 'first', or 'mean'")
    p.add_argument("--transforms", help=".npz for transforms + diagnostics")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=0)
    p.add_argument("--hypotheses", type=int, default=0)
    p.add_argument("--warp", default="", choices=_WARPS)
    p.add_argument("--compression", default="none", choices=_COMPRESSIONS)
    p.add_argument(
        "--io-threads", "--io-workers", type=int, default=0, dest="io_threads",
        help="host-ingest decode workers / encode threads "
        "(CorrectorConfig.io_workers; 0 = auto: one per CPU, capped at "
        "8). GIL-bound pure-Python codec sources decode in a process "
        "pool of this size (io/feeder.py)",
    )
    p.add_argument(
        "--io-prefetch", type=int, default=0,
        help="feeder prefetch depth in chunks (io_prefetch; 0 = auto: "
        "derived from the dispatch window — depth x batch frames ahead)",
    )
    p.add_argument(
        "--writer-depth", type=int, default=-1,
        help="background-writeback queue depth in batches (default 2: "
        "output encode+write overlaps device dispatch; 0 = synchronous "
        "writes). Blocked-queue time shows as stalls_s.writer_backpressure",
    )
    p.add_argument(
        "--output-dtype", default="input",
        help="corrected-frame dtype: 'input' (match source, default), "
        "'float32', or any NumPy dtype (integer targets round + clip)",
    )
    p.add_argument(
        "--quality", action="store_true",
        help="report per-frame template correlation (registration QC)",
    )
    p.add_argument(
        "--template-update", type=int, default=0,
        help="rolling template updates every N frames (long recordings "
        "whose scene bleaches/changes; 0 = off). Updates land at fixed "
        "frame boundaries, so results are batch/chunk/resume invariant",
    )
    p.add_argument(
        "--checkpoint", default="",
        help="resume-checkpoint .npz: a killed run re-invoked with the "
        "same arguments resumes after the last checkpointed frame",
    )
    p.add_argument("--checkpoint-every", type=int, default=512)
    p.add_argument(
        "--stall-exit", type=float, default=0,
        help="exit(3) after this many seconds of zero frame progress "
        "(wedged device link); rerun with the same --checkpoint to "
        "resume. Set well above the first batch's build time.",
    )
    p.add_argument(
        "--octaves", type=int, default=0,
        help="ORB scale-pyramid octave count (2D models): 3 extends "
        "the zoom envelope from ±25%% to ~2x at ~2x per-frame cost; "
        "0/1 = single-scale (default)",
    )
    p.add_argument(
        "--match-radius", type=float, default=0,
        help="spatially-banded matching radius, px (the scale path for "
        "very high keypoint counts; 0 = dense matching, default)",
    )
    p.add_argument(
        "--field-polish", type=int, default=-1,
        help="piecewise photometric polish passes (default 1; 2 = best "
        "accuracy; 0 = off)",
    )
    p.add_argument(
        "--transform-polish", type=int, default=-1,
        help="photometric transform-polish passes for the matrix "
        "models (default 1; 0 = off)",
    )
    p.add_argument(
        "--inject-faults", default="", metavar="SPEC",
        help="deterministic chaos run: inject faults per SPEC (e.g. "
        "'io_read:step=3:raise, device:step=7:transient, "
        "checkpoint:corrupt_part=1'). Also settable via the "
        "KCMC_FAULT_PLAN env var",
    )
    p.add_argument(
        "--buckets", default="", metavar="SPEC",
        help="execution-plan shape buckets, e.g. '512,1024' or "
        "'480x640,1024': 2D matrix-model inputs pad to the smallest "
        "covering bucket so odd shapes hit warm programs; pre-build "
        "with `python -m kcmc_tpu_torch warmup`",
    )
    p.add_argument(
        "--compile-cache", default="", metavar="DIR",
        help="persistent kernel-library and plan-stamp directory (also "
        "via KCMC_COMPILE_CACHE): later processes load the built "
        "kernels instead of rebuilding them",
    )
    p.add_argument(
        "--trace", default="", metavar="PATH",
        help="export a Chrome trace-event JSON of the run (stages, "
        "pipeline stalls, per-batch dispatch, writer thread); load in "
        "Perfetto / chrome://tracing",
    )
    p.add_argument(
        "--frame-records", default="", metavar="PATH",
        help="stream per-frame quality records (keypoints, matches, "
        "inlier count/ratio, consensus residual px, robustness flags) "
        "to a JSONL sidecar; render with `python -m kcmc_tpu_torch "
        "report PATH`",
    )
    p.add_argument(
        "--heartbeat", type=float, default=0, metavar="SECS",
        help="log a progress line (frames done, fps, stall fractions, "
        "robustness counters) to stderr every SECS seconds — liveness "
        "for unattended runs (0 = off)",
    )
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=_cmd_correct)

    p = sub.add_parser(
        "warmup",
        help="pre-populate the execution-plan caches for a config set: "
        "run every hot program per shape bucket, building the kernel "
        "libraries into the compile cache and stamping it, so the next "
        "process starts warm",
    )
    p.add_argument(
        "--buckets", default="", metavar="SPEC", required=True,
        help="shape buckets to build, e.g. '512,1024' or '480x640'",
    )
    p.add_argument(
        "--compile-cache", default="", metavar="DIR",
        help="persistent kernel-library and plan-stamp directory (also "
        "via KCMC_COMPILE_CACHE; without one the build only warms THIS "
        "process and stamps nothing)",
    )
    p.add_argument(
        "--dtypes", default="float32",
        help="comma-separated input dtypes to warm per bucket "
        "(default float32; integer dtypes also warm the device-side "
        "output cast), e.g. 'float32,uint16'",
    )
    p.add_argument("--model", default="translation", choices=_MODELS_2D)
    _backend_arg(p)
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="warm the sharded programs of an N-card mesh "
        "(see `correct --devices`)",
    )
    p.add_argument("--reference", default="0",
                   help="unused for warm-up math; accepted for parity "
                   "with `correct` flag sets")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=0)
    p.add_argument("--hypotheses", type=int, default=0)
    p.add_argument("--warp", default="", choices=_WARPS)
    p.add_argument("--quality", action="store_true")
    p.add_argument(
        "--template-update", type=int, default=0,
        help="also warm the rolling-template update program for this "
        "cadence (0 = skip it)",
    )
    p.add_argument(
        "--transform-polish", type=int, default=-1,
        help="polish passes the warmed programs run with (must match "
        "the serving config; default: config default)",
    )
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=_cmd_warmup)

    p = sub.add_parser(
        "serve",
        help="resident multi-tenant serving: keep one warm backend on "
        "the card alive and multiplex concurrent client streams through "
        "it (line-delimited JSON over TCP; docs/SERVING.md)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port", type=int, default=7733,
        help="TCP port (0 = ephemeral; the ready line reports the "
        "bound port)",
    )
    p.add_argument(
        "--model", default="translation",
        choices=["translation", "rigid", "similarity", "affine",
                 "homography", "piecewise"],
    )
    _backend_arg(p)
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the resident mesh over N cards (see `correct "
        "--devices`)",
    )
    p.add_argument("--reference", default="first", choices=["first"],
                   help="reference for sessions that send no explicit "
                   "reference frame at open_session: 'first' (each "
                   "stream's first submitted frame) is the only "
                   "stream-compatible policy")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=0)
    p.add_argument("--hypotheses", type=int, default=0)
    p.add_argument("--warp", default="",
                   choices=_WARPS)
    p.add_argument("--quality", action="store_true")
    p.add_argument(
        "--template-update", type=int, default=0,
        help="default rolling-template cadence for sessions (frames; "
        "0 = off; sessions may override per-stream)",
    )
    p.add_argument(
        "--queue-depth", type=int, default=0,
        help="per-session admission bound in frames "
        "(serve_queue_depth; default 256)",
    )
    p.add_argument(
        "--inflight", type=int, default=0,
        help="cross-session in-flight dispatch window, batches "
        "(serve_inflight; default 3)",
    )
    p.add_argument(
        "--degrade-watermark", type=float, default=None,
        help="queue fraction where QoS degradation engages before any "
        "429 rejection (serve_degrade_watermark; default 0.5)",
    )
    p.add_argument(
        "--journal-dir", default="", metavar="DIR",
        help="durable session-journal directory (serve_journal_dir): "
        "sessions periodically persist resume state so a killed server "
        "restarted over the same DIR resumes every journaled stream "
        "via the resume_session verb (docs/ROBUSTNESS.md)",
    )
    p.add_argument(
        "--journal-every", type=int, default=None, metavar="FRAMES",
        help="journal cadence in drained frames "
        "(serve_journal_every; default 64)",
    )
    p.add_argument(
        "--session-timeout", type=float, default=None, metavar="SECS",
        help="reap sessions whose client has been idle this long "
        "(journaled, not dropped — resume_session restores them; "
        "serve_session_timeout_s; 0 = never)",
    )
    p.add_argument(
        "--io-timeout", type=float, default=None, metavar="SECS",
        help="transport IO deadline baseline (serve_io_timeout_s; "
        "default 30)",
    )
    p.add_argument(
        "--inject-faults", default="", metavar="SPEC",
        help="deterministic serve-plane chaos: the fault-plan grammar "
        "(see `correct --inject-faults`) plus the serve surfaces — "
        "transport (drop/stall a connection), scheduler (wedge the "
        "loop), device (mid-dispatch errors per session), journal "
        "(session-writer failures); also via KCMC_FAULT_PLAN",
    )
    p.add_argument(
        "--writer-depth", type=int, default=-1,
        help="background-writeback queue depth for sessions writing "
        "server-side output files (see `correct --writer-depth`)",
    )
    p.add_argument(
        "--io-threads", "--io-workers", type=int, default=0, dest="io_threads",
        help="decode-worker / encode-thread budget for session-side IO "
        "(CorrectorConfig.io_workers; sessions share one process-wide "
        "pool — see `correct --io-threads`)",
    )
    p.add_argument(
        "--heartbeat", type=float, default=0, metavar="SECS",
        help="aggregate serve heartbeat: per-session frames/fps, queue "
        "depths, admission decisions, batch occupancy (0 = off)",
    )
    p.add_argument(
        "--buckets", default="", metavar="SPEC",
        help="execution-plan shape buckets (see `correct --buckets`): "
        "the server runs every hot program per bucket BEFORE the ready "
        "line, so sessions open against warm plans; with "
        "--compile-cache a re-booted server loads its kernel libraries "
        "instead of rebuilding them (ready record reports warmup_s and "
        "plan-cache hits/misses)",
    )
    p.add_argument(
        "--compile-cache", default="", metavar="DIR",
        help="persistent kernel-library and plan-stamp directory (also "
        "via KCMC_COMPILE_CACHE)",
    )
    p.add_argument(
        "--trace", default="", metavar="PATH",
        help="per-session Chrome traces (every session derives its "
        "own session-id filename from PATH)",
    )
    p.add_argument(
        "--frame-records", default="", metavar="PATH",
        help="per-session frame-quality JSONLs (session-id derived "
        "filenames)",
    )
    p.add_argument(
        "--trace-shards", default="", metavar="DIR",
        help="distributed-tracing span-shard directory "
        "(trace_shard_dir): finished request/RPC spans append to a "
        "bounded per-process JSONL under DIR; stitch with `python -m "
        "kcmc_tpu_torch trace DIR` (docs/OBSERVABILITY.md 'Distributed tracing')",
    )
    p.add_argument(
        "--slo", default="", metavar="SPEC",
        help="declarative SLO objectives (slo_objectives): "
        "';'-separated rung:threshold_s:fraction (latency) or "
        "avail:fraction entries, e.g. 'full:0.5:0.99;avail:0.999'; "
        "multi-window burn rates ride the metrics verb as kcmc_slo_* "
        "gauges and the heartbeat",
    )
    p.add_argument(
        "--latency-fill-floor", type=float, default=None,
        metavar="FRAC",
        help="deadline-QoS fill floor (serve_latency_fill_floor; "
        "default 0): a deadline-forced partial window below this "
        "fraction of batch_size defers while slack remains, so "
        "trickle traffic cannot collapse throughput "
        "(docs/SERVING.md 'Latency QoS')",
    )
    p.add_argument(
        "--no-latency-admission", action="store_true",
        help="disable predictive admission "
        "(serve_latency_admission=False): submits whose predicted "
        "wait exceeds their deadline are admitted anyway instead of "
        "being rejected 429 with a predicted_wait_s hint",
    )
    p.add_argument(
        "--starvation-limit", type=int, default=None, metavar="N",
        help="batch-class starvation bound "
        "(serve_latency_starvation_limit; default 4): after N "
        "consecutive latency-class preemptions a waiting batch "
        "session takes the dispatch slot unconditionally",
    )
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser(
        "router",
        help="fleet front door over N serve replicas: speaks the same "
        "line-JSON protocol, places sessions by rendezvous hashing "
        "over health-checked replicas, live-migrates streams off dead "
        "or draining replicas via the shared journal dir, and "
        "optionally autoscales (docs/SERVING.md 'Running a fleet')",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port", type=int, default=7744,
        help="router TCP port (0 = ephemeral; the ready line reports "
        "the bound port)",
    )
    p.add_argument(
        "--spawn", type=int, default=0, metavar="N",
        help="spawn N `serve` replicas (ephemeral ports, "
        "shared --journal-dir, the top-level --device) and supervise "
        "them",
    )
    p.add_argument(
        "--replicas", default="", metavar="HOST:PORT,...",
        help="adopt externally managed replicas (comma-separated "
        "host:port list); adopted replicas are health-checked and "
        "routed to but never stopped or drained by the autoscaler",
    )
    p.add_argument(
        "--serve-args", default="", metavar="ARGS",
        help="extra `serve` flags for spawned replicas, one "
        "shell-quoted string (e.g. \"--backend numpy --batch-size 8\")",
    )
    p.add_argument(
        "--journal-dir", default="", metavar="DIR",
        help="SHARED session-journal directory — the migration "
        "substrate; defaults to a fresh temp dir when spawning "
        "(migration needs every replica to see every journal)",
    )
    p.add_argument(
        "--probe-interval", type=float, default=None, metavar="SECS",
        help="health-scrape period AND per-scrape budget "
        "(fleet_probe_interval_s; default 1)",
    )
    p.add_argument(
        "--suspect-probes", type=int, default=None, metavar="N",
        help="consecutive bad scrapes before HEALTHY -> SUSPECT "
        "(fleet_suspect_probes; default 2)",
    )
    p.add_argument(
        "--dead-probes", type=int, default=None, metavar="N",
        help="consecutive hard-bad scrapes before SUSPECT -> DEAD "
        "and migration (fleet_dead_probes; default 4)",
    )
    p.add_argument(
        "--wedge-threshold", type=float, default=None, metavar="SECS",
        help="loop_beat_age_s above which a reachable replica counts "
        "as wedged (fleet_wedge_threshold_s; default 30)",
    )
    p.add_argument(
        "--watermark", type=float, default=None, metavar="FRAC",
        help="fleet-wide admission watermark: reject new sessions "
        "429-style once global queued frames pass FRAC of aggregate "
        "capacity (fleet_queue_watermark; default 0.9; 1.0 = off)",
    )
    p.add_argument(
        "--autoscale", action="store_true",
        help="run the autoscaler control loop (spawn on backlog, "
        "drain on idle, within --min/--max-replicas)",
    )
    p.add_argument(
        "--min-replicas", type=int, default=0, metavar="N",
        help="autoscale floor (default: the initial fleet size)",
    )
    p.add_argument(
        "--max-replicas", type=int, default=0, metavar="N",
        help="autoscale ceiling (default: the initial fleet size)",
    )
    p.add_argument(
        "--scale-cooldown", type=float, default=None, metavar="SECS",
        help="minimum seconds between autoscale actions "
        "(fleet_scale_cooldown_s; default 30)",
    )
    p.add_argument(
        "--inject-faults", default="", metavar="SPEC",
        help="deterministic fleet chaos: the fault-plan grammar with "
        "the `fleet` surface — a raising clause blackholes a "
        "router->replica call, stall= stalls a health scrape past "
        "its budget; also via KCMC_FAULT_PLAN",
    )
    p.add_argument(
        "--trace-shards", default="", metavar="DIR",
        help="distributed-tracing span-shard directory for the router "
        "AND spawned replicas (trace_shard_dir): the whole fleet "
        "shards into DIR, so `python -m kcmc_tpu_torch trace DIR` stitches one fleet "
        "trace per request",
    )
    p.add_argument(
        "--slo", default="", metavar="SPEC",
        help="fleet SLO objectives (slo_objectives; see `serve "
        "--slo`): burn rates computed over the exact-merged fleet "
        "histograms; alert transitions land in the router log",
    )
    p.set_defaults(fn=_cmd_router)

    p = sub.add_parser(
        "top",
        help="live terminal dashboard over serve replicas: per-session "
        "fps and queue depth, per-segment latency p50/p99, supervisor "
        "state and wedge age (polls the metrics/stats verbs); several "
        "targets — or one router — render a fleet-merged view",
    )
    p.add_argument(
        "addrs", nargs="*", default=["127.0.0.1:7733"], metavar="ADDR",
        help="one or more host:port targets (default 127.0.0.1:7733): "
        "one replica or router renders directly; several replicas are "
        "scraped and exact-merged into one fleet dashboard",
    )
    p.add_argument(
        "--interval", type=float, default=2.0, metavar="SECS",
        help="refresh period (default 2)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (scripting / CI smoke)",
    )
    p.set_defaults(fn=_cmd_top)

    p = sub.add_parser(
        "check",
        help="static invariant checker of the port: config-signature "
        "registry, lock/thread discipline (lock order, daemon-cuda), "
        "span registry, thread-root inventory, whole-program race "
        "detection, resource lifecycle — exit 0 unless a NEW "
        "(non-baselined) error appears",
    )
    p.add_argument(
        "--root", default="",
        help="repo root holding kcmc_tpu_torch/ (default: auto-detected)",
    )
    p.add_argument(
        "--baseline", default="", metavar="PATH",
        help="baseline of accepted findings (default: the checked-in "
        "kcmc_tpu_torch/analysis/baseline.json)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable findings report (kind: kcmc_check); "
        "render with `python -m kcmc_tpu_torch report`",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from current findings (new entries "
        "get FILL-ME-IN reasons; justify each before committing)",
    )
    p.add_argument(
        "--prune-baseline", action="store_true",
        help="drop stale baseline entries (ones whose finding no "
        "longer fires) and rewrite the file",
    )
    p.add_argument(
        "--sarif", default="", metavar="PATH",
        help="also write new findings as a SARIF 2.1.0 log for GitHub "
        "code-scanning PR annotations ('-' = stdout)",
    )
    p.add_argument(
        "--no-cache", action="store_true",
        help="bypass the content-hash result cache "
        "(.kcmc_torch_check_cache/) and re-run every pass",
    )
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser(
        "sanitize",
        help="run a command under the runtime concurrency sanitizer: "
        "instrumented locks with lock-order validation, deadlock "
        "watchdog with all-thread stack dumps, and leak checking",
    )
    p.add_argument(
        "--watchdog", type=float, default=10.0, metavar="SECS",
        help="deadlock-watchdog threshold: a lock held this long with "
        "waiters dumps every thread's stack (default 10)",
    )
    p.add_argument(
        "--no-static", action="store_true",
        help="skip merging the static lock-order graph into the "
        "runtime order check",
    )
    p.add_argument(
        "--strict", action="store_true",
        help="raise at the acquisition closing a lock-order cycle "
        "instead of recording it",
    )
    p.add_argument(
        "cmd", nargs=argparse.REMAINDER,
        help="command to run, e.g. `python -m kcmc_tpu_torch correct "
        "s.tif`",
    )
    p.set_defaults(fn=_cmd_sanitize)

    p = sub.add_parser(
        "metrics",
        help="re-render a serve replica's request-latency/health "
        "metrics from a dumped JSON snapshot: JSON by default, "
        "Prometheus text exposition with --text",
    )
    p.add_argument(
        "source", nargs="?", default="127.0.0.1:7733",
        help="host:port of a live server (default 127.0.0.1:7733), or "
        "a dumped metrics JSON file to re-render",
    )
    p.add_argument(
        "--text", action="store_true",
        help="Prometheus text exposition (histogram buckets, counters, "
        "gauges) instead of the JSON payload",
    )
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser(
        "trace",
        help="stitch distributed request traces from span shards: "
        "slowest-N requests with per-request critical paths (which "
        "lifecycle segment dominated), optional Chrome/Perfetto export",
    )
    p.add_argument(
        "sources", nargs="+", metavar="SRC",
        help="span-shard .jsonl files, shard directories, or host:port "
        "of a live server",
    )
    p.add_argument(
        "--slowest", type=int, default=10, metavar="N",
        help="slowest-N requests to list (default 10)",
    )
    p.add_argument(
        "--chrome", default="", metavar="PATH",
        help="also write the stitched multi-process trace as Chrome "
        "trace-event JSON (load in Perfetto / chrome://tracing)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable JSON summary instead of the text table",
    )
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser(
        "report",
        help="render a run report from a --frame-records JSONL or a "
        "`correct --transforms` npz (stage/stall table, frame-quality "
        "percentiles, worst frames, robustness summary)",
    )
    p.add_argument("artifact", help="frame-records .jsonl or transforms .npz")
    p.add_argument(
        "--top", type=int, default=10,
        help="worst-N frames to list (default 10)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable JSON summary instead of the text report",
    )
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser(
        "apply",
        help="apply recovered transforms to another stack file "
        "(multi-channel pass 2)",
    )
    p.add_argument("stack", help="input multi-page TIFF to resample")
    p.add_argument("transforms", help=".npz from `correct --transforms`")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--compression", default="none", choices=_COMPRESSIONS)
    p.add_argument("--output-dtype", default="input")
    p.add_argument(
        "--io-threads", "--io-workers", type=int, default=0,
        dest="io_threads",
        help="decode workers / encode threads (see `correct --io-threads`)",
    )
    p.add_argument(
        "--io-prefetch", type=int, default=0,
        help="feeder prefetch depth in chunks (0 = auto)",
    )
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=_cmd_apply)

    p = sub.add_parser(
        "stabilize",
        help="remove jitter but follow intentional motion "
        "(register, low-pass the trajectory, re-apply the residual)",
    )
    p.add_argument("stack", help="input multi-page TIFF")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--sigma", type=float, default=15.0,
        help="temporal scale IN FRAMES: slower motion is kept (default 15)",
    )
    p.add_argument("--model", default="translation", choices=_MODELS_2D)
    _backend_arg(p)
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the registration pass over N cards "
        "(see `correct --devices`)",
    )
    p.add_argument("--reference", default="0")
    p.add_argument("--transforms",
                   help=".npz for the stabilizing transforms + diagnostics")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=0)
    p.add_argument("--hypotheses", type=int, default=0)
    p.add_argument("--warp", default="", choices=_WARPS)
    p.add_argument("--quality", action="store_true")
    p.add_argument("--compression", default="none", choices=_COMPRESSIONS)
    p.add_argument("--output-dtype", default="input")
    p.add_argument(
        "--io-threads", "--io-workers", type=int, default=0,
        dest="io_threads",
        help="decode workers / encode threads (see `correct --io-threads`)",
    )
    p.add_argument(
        "--io-prefetch", type=int, default=0,
        help="feeder prefetch depth in chunks (0 = auto)",
    )
    p.add_argument(
        "--inject-faults", default="", metavar="SPEC",
        help="deterministic chaos run (see `correct --inject-faults`)",
    )
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=_cmd_stabilize)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    # KCMC_SANITIZE=1 arms the runtime concurrency sanitizer for this
    # process (`sanitize` re-execs with it set)
    from kcmc_tpu_torch.analysis.sanitize import maybe_enable_from_env

    maybe_enable_from_env()
    # CLI processes route library advisories through the kcmc_tpu_torch
    # logger on stderr; stdout carries only machine-readable output.
    from kcmc_tpu_torch.obs.log import setup_cli_logging

    setup_cli_logging(verbose=args.verbose, quiet=args.quiet)
    if getattr(args, "heartbeat", 0):
        # explicit --heartbeat output must survive the default WARNING
        # level without requiring -v
        import logging

        logging.getLogger("kcmc_tpu_torch.heartbeat").setLevel(logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
