"""`MotionCorrector` of the PyTorch port (translation, rigid, similarity,
affine, homography, piecewise and rigid3d slices, single-scale or
through the scale pyramid), and `apply_correction`.

Counterpart of `kcmc_tpu/corrector.py`'s `MotionCorrector.correct`
(:1318-1524) and `apply_correction` (:242): reference selection and
template refinement (`template_iters`), fixed-size batches with the tail
batch padded by repeating its last frame, rolling-template segments
(`template_update_every`: updates at absolute multiples of it, blended
on the host or, with `device_templates`, on the device), the batch
program with the warm-start seed of the previous batch, rescue of frames
the bounded warp flagged with the out-of-bound policy (warn, then
escalate the remaining batches to the exact gather warp;
kcmc_tpu/corrector.py:1990-2066), and the merge. `correct()` takes a
host array or a tensor (sliced where it lies), a frame range with global
frame indices, and `device_outputs`. `stream_view` gives per-stream
correctors that share one backend: the serve plane's sessions (serve/).

The dispatch is pipelined (kcmc_tpu/corrector.py:1560-1980): three
batches in flight, the oldest drained; with `upload_overlap` (the
default) a single upload worker stages the next batch's upload through
the backend's pinned staging ring while the current batch runs, and the
downloads, started at dispatch into pinned buffers, are materialized at
drain. The rescue escalation is decided when the tripping batch
drains, so the two batches dispatched after it still run the bounded
warp. The output is byte-identical with `upload_overlap=False`. With `mesh=` or
`mesh_devices` every batch is sharded over a frame-axis mesh of devices
(parallel/).

The backend is a registered name (`backends/`: "torch", or the NumPy
host oracle "numpy") or an instance; every seam beyond
`prepare_reference` and `process_batch` is probed (`process_batch_async`,
`stage_upload`, `to_host`, `rescue_warp`, `update_reference`,
`plan_cache_stats`), so a plugin backend runs synchronously, as in the
reference.

File-scale runs (`correct_file`, kcmc_tpu/corrector.py:2110-2837) stream
chunks through `io/` (native TIFF decoder, Zarr, HDF5, npy, raw; a
prefetch thread or a decode pool; object-store URLs through
`io/objectstore.py`) into the same dispatch core as `correct()`, write
the corrected frames incrementally (TIFF, Zarr, HDF5 or an object-store
bucket, behind a background writer) and checkpoint the recovered
transforms with the writer's exact cursor, so a killed run resumes and
writes the bytes of an uninterrupted one. Every batch runs under the
degradation ladder (:864-1166): injected transient faults are retried
with backoff, then re-run on the failover backend (the NumPy oracle on
the host by default), then marked failed and interpolated; any other
error of the batch program raises (chunk reads retry OS-level I/O
errors on their own surface).
`apply_correction_file` streams a stored registration onto another file,
and `common_valid_region` gives the crop every corrected frame covers.

With `trace_path`, `frame_records_path` or `heartbeat_s` armed, both run
methods carry a `RunTelemetry` (obs/run.py, kcmc_tpu/corrector.py:61,
:841): stage, stall, dispatch, upload-staging and writer spans on a
Chrome trace, one quality record per drained frame, a heartbeat thread,
and the dispatch / device / drain latency segments in
`timing["latency"]`. Spans are host spans around the asynchronous
dispatch: no span, record or sample synchronizes the card or copies
frames to the host; the card's time shows where the drain already
waits (`drain_sync`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import os
import sys
import threading
import time

import numpy as np
import torch

from kcmc_tpu_torch.backends import get_backend
from kcmc_tpu_torch.config import SIG_NEUTRAL_FIELDS, CorrectorConfig, port_fields
from kcmc_tpu_torch.obs.log import advise
from kcmc_tpu_torch.ops.warp import (
    coverage_mask,
    coverage_mask_3d,
    fast_apply_fields,
    fast_apply_matrix,
    warp_volume,
)
from kcmc_tpu_torch.utils import faults
from kcmc_tpu_torch.utils.device import resolve_device
from kcmc_tpu_torch.utils.dtypes import int_clip_bounds
from kcmc_tpu_torch.utils.metrics import RobustnessReport, StageTimer

# Config fields that shape failure recovery or I/O scheduling but never
# the results, pinned to their defaults inside correct_file's resume
# signature (kcmc_tpu/corrector.py:55): changing them between a killed
# run and its rerun resumes it instead of restarting.
_ROBUSTNESS_SIG_NEUTRAL = {
    f: CorrectorConfig.__dataclass_fields__[f].default
    for f in sorted(SIG_NEUTRAL_FIELDS)
}

def _telemetry_scope(fn):
    """Guarantee RunTelemetry teardown for a public run method
    (kcmc_tpu/corrector.py:61): on the error path the partial trace and
    records flush with the failure recorded; on success
    `finish(timing)` has already run and close() is a no-op."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        finally:
            t = getattr(self, "_telemetry", None)
            if t is not None:
                self._telemetry = None
                t.close(sys.exc_info()[1])

    return wrapper


def _make_backend(name: str, config: CorrectorConfig, device=None, mesh=None):
    """The backend registered under `name`, built through the registry.
    "torch" takes the device and the mesh; "numpy" is the host oracle,
    which runs on the CPU and refuses any other device; a third-party
    backend gets the options that were given."""
    if name == "numpy" and device is not None and torch.device(device).type != "cpu":
        raise ValueError(
            f"backend='numpy' runs on the host CPU; it cannot be combined "
            f"with device={device!r}"
        )
    options = {}
    if device is not None and name != "numpy":
        options["device"] = device
    if mesh is not None:
        options["mesh"] = mesh
    return get_backend(name, config, **options)


def twin_options(backend) -> dict:
    """`get_backend` options that build a backend on `backend`'s device
    and mesh: the escalation backend, the serve plane's degraded twin and
    its rebuilt primary (kcmc_tpu/corrector.py:1990-2000)."""
    options = {}
    if getattr(backend, "device", None) is not None:
        options["device"] = backend.device
    mesh = getattr(backend, "mesh", None)
    if mesh is not None:
        options["mesh"] = mesh
    return options


def _backend_device(backend) -> torch.device:
    """Where a backend's outputs live: its `device`, or the host for a
    backend without one (the numpy oracle, plugin backends)."""
    return torch.device(getattr(backend, "device", None) or "cpu")


@dataclasses.dataclass
class CorrectionResult:
    corrected: np.ndarray  # (T, H, W), or (T, D, H, W) for rigid3d
    transforms: np.ndarray | None  # (T, 3, 3) ref -> frame maps ((T, 4, 4)
    # for rigid3d); None for piecewise
    diagnostics: dict  # per-frame arrays
    timing: dict  # the reference's keys (obs/registry.py TIMING_KEYS)
    fields: np.ndarray | None = None  # (T, gh, gw, 2) for piecewise
    # the first frame the exact-warp escalation took (None: none did)
    escalated_at: int | None = None

    @property
    def frames_per_sec(self) -> float | None:
        return self.timing.get("frames_per_sec")

    @property
    def robustness(self) -> dict | None:
        """The run's RobustnessReport dict (retries, failovers, rescued
        frames, quarantined checkpoint parts), or None when the run had
        no retry machinery active."""
        return self.timing.get("robustness")


def _cast_output(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Float32 frames to the output dtype; integer targets are rounded
    and clipped to the dtype's range."""
    if arr.dtype == dtype:
        return arr
    if np.issubdtype(dtype, np.integer):
        fdt = arr.dtype if np.issubdtype(arr.dtype, np.floating) else np.float64
        lo, hi = int_clip_bounds(dtype, fdt)
        return np.clip(np.rint(arr), lo, hi).astype(dtype)
    return arr.astype(dtype)


def merge_outputs(outs: list[dict], cat=np.concatenate) -> dict:
    """Per-batch output dicts merged into one dict of concatenated
    arrays (corrector.py:212); the keys come from the first batch, as
    the batches of one run are key-uniform. `correct`, `correct_file`
    and the serve sessions merge through it."""
    return {k: cat([o[k] for o in outs]) for k in outs[0]} if outs else {}


def _resolve_dtype(output_dtype, input_dtype) -> np.dtype:
    """"input" keeps the stack's dtype (corrector.py:431)."""
    if isinstance(output_dtype, str) and output_dtype == "input":
        return np.dtype(input_dtype)
    return np.dtype(output_dtype)


def _stack_dtype(stack) -> np.dtype:
    if isinstance(stack, torch.Tensor):
        return np.dtype(str(stack.dtype).removeprefix("torch."))
    return stack.dtype


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on_device(out: dict, device) -> dict:
    """Host outputs as tensors on `device` (`device_outputs` runs)."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in out.items()}


def _host_float(batch, backend):
    """A batch for a backend without the asynchronous seam: host frames,
    cast to float32 unless the backend declares `accepts_native_dtype`
    (corrector.py:1205, :1741-1747)."""
    batch = _host(batch)
    if not getattr(backend, "accepts_native_dtype", False) and batch.dtype != np.float32:
        batch = batch.astype(np.float32)
    return batch


def apply_correction(
    stack,
    transforms: np.ndarray | None = None,
    fields: np.ndarray | None = None,
    batch_size: int = 32,
    output_dtype="float32",
    device=None,
) -> np.ndarray:
    """Resample a stack through transforms or fields recovered earlier:
    register one channel with `MotionCorrector.correct`, apply its
    transforms to another (corrector.py:242).

    Exactly one of `transforms` ((T, 3, 3), or (T, 4, 4) for a (T, D, H,
    W) stack) or `fields` ((T, gh, gw, 2), 2D stacks) must be given.
    Batches of `batch_size` frames go to `device` (the card unless
    "cpu"): 2D matrix applies through `fast_apply_matrix` (K7 on the
    card), field applies through `fast_apply_fields` (K8 on the card),
    each with an exact per-frame gather for the frames the kernel flags;
    on the CPU the gather; volumes through the trilinear gather. Integer
    `output_dtype` rounds and clips ("input" keeps the stack's dtype).
    Returns numpy."""
    if (transforms is None) == (fields is None):
        raise ValueError("pass exactly one of transforms= or fields=")
    if not isinstance(stack, torch.Tensor):
        stack = np.asarray(stack)
    if fields is not None and stack.ndim != 3:
        raise ValueError(
            "fields= (piecewise) applies to 2D (T, H, W) stacks only; "
            f"got stack shape {tuple(stack.shape)}"
        )
    n = len(stack)
    maps = transforms if transforms is not None else fields
    if len(maps) != n:
        raise ValueError(f"stack has {n} frames but {len(maps)} transforms/fields")
    if transforms is not None:
        want = 4 if stack.ndim == 4 else 3
        if np.asarray(transforms).shape[-1] != want:
            raise ValueError(
                f"stack of rank {stack.ndim} needs ({want}, {want}) "
                f"transforms, got {np.asarray(transforms).shape[-2:]} — "
                "a 4x4 rigid3d registration cannot be applied to a 2D "
                "stack (and vice versa)"
            )
    out_dt = _resolve_dtype(output_dtype, _stack_dtype(stack))
    if n == 0:
        return np.empty(tuple(stack.shape), out_dt)
    dev = resolve_device(device)
    maps = torch.as_tensor(np.asarray(maps, np.float32))
    if transforms is not None and stack.ndim == 4:
        def warp(fr, m):
            return warp_volume(fr, m)
    elif transforms is not None:
        def warp(fr, m):
            return fast_apply_matrix(fr, m)
    else:
        def warp(fr, m):
            return fast_apply_fields(fr, m)
    outs = []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        fr = torch.as_tensor(stack[lo:hi], device=dev).to(torch.float32).contiguous()
        got = warp(fr, maps[lo:hi].to(dev).contiguous())
        outs.append(_cast_output(got.cpu().numpy(), out_dt))
    return np.concatenate(outs)


def apply_correction_file(
    path,
    output: str,
    transforms: np.ndarray | None = None,
    fields: np.ndarray | None = None,
    chunk_size: int = 256,
    compression: str = "none",
    output_dtype="input",
    n_threads: int = 0,
    progress: bool = False,
    reader_options: dict | None = None,
    writer_depth: int = 2,
    io_prefetch: int = 0,
    device=None,
) -> None:
    """Streaming `apply_correction` (corrector.py:341): a file in, the
    corrected TIFF (or Zarr / HDF5, by extension) out, constant host
    memory — the file-scale pass 2 of the multi-channel and
    stabilization workflows (register one channel with
    `correct_file(..., emit_frames=False)`, apply its transforms to the
    others; or apply smoothed transforms back to the original).

    Chunks of `chunk_size` pages decode ahead (`io_prefetch` chunks; 0 =
    auto), go through `apply_correction` on `device` (the card unless
    "cpu": K7 / K8 with the exact gather for the frames they flag) and
    are written behind a background writer of `writer_depth` batches (0
    = synchronous). `n_threads` follows `io_workers` (0 = auto).
    `transforms` / `fields` cover every page of `path`; 2D stacks only.
    Output dtype as in `apply_correction` ("input" keeps the file's);
    BigTIFF engages past 4 GiB."""
    from kcmc_tpu_torch.io import ChunkedStackLoader, feeder, open_stack
    from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
    from kcmc_tpu_torch.io.formats import make_writer

    if (transforms is None) == (fields is None):
        raise ValueError("pass exactly one of transforms= or fields=")
    maps = transforms if transforms is not None else fields
    workers = feeder.resolve_workers(n_threads)
    with open_stack(path, n_threads=n_threads, **(reader_options or {})) as ts:
        if len(maps) != len(ts):
            raise ValueError(
                f"{path} has {len(ts)} pages but {len(maps)} transforms/fields"
            )
        if len(ts.frame_shape) != 2:
            raise ValueError("apply_correction_file covers 2D stacks only")
        out_dt = _resolve_dtype(output_dtype, ts.dtype)
        writer = make_writer(
            output, len(ts), ts.frame_shape, out_dt, compression=compression,
            bigtiff=_wants_bigtiff(len(ts), ts.frame_shape, out_dt),
        )
        if writer_depth > 0:
            writer = AsyncBatchWriter(writer, depth=writer_depth)
        loader = ChunkedStackLoader(
            ts, chunk_size=chunk_size,
            prefetch=feeder.derive_prefetch(io_prefetch, chunk_size, chunk_size, depth=1),
            io_workers=workers,
            source_path=path if isinstance(path, (str, os.PathLike)) else None,
            reader_options=reader_options,
        )
        chunks = iter(loader)
        try:
            for lo, hi, chunk in chunks:
                got = apply_correction(
                    np.asarray(chunk),
                    transforms=None if transforms is None else transforms[lo:hi],
                    fields=None if fields is None else fields[lo:hi],
                    output_dtype=out_dt, device=device,
                )
                writer.append_batch(got, n_threads=n_threads)
                if progress:
                    print(f"[kcmc] applied {hi}/{len(ts)}", flush=True)
        finally:
            chunks.close()  # stop and join the prefetch thread
            writer.close()


def _wants_bigtiff(n_frames: int, frame_shape, out_dt: np.dtype) -> bool:
    """BigTIFF for outputs past classic TIFF's 4 GiB offsets: pixel data
    (+1%, PackBits can expand) plus ~256 B of IFD per page
    (corrector.py:437)."""
    frame_bytes = int(np.prod(frame_shape)) * out_dt.itemsize
    est = n_frames * (frame_bytes + frame_bytes // 100 + 256)
    return est + (1 << 20) >= 2**32


def _prev_smaller(hts: np.ndarray) -> np.ndarray:
    """Per row, the nearest column to the left holding a STRICTLY
    smaller value (-1 where none), by binary lifting over a power-of-two
    range-minimum table: O(log W) full-matrix rounds."""
    R, W = hts.shape
    st = [hts]  # st[k][:, j] = min(hts[:, j : j + 2**k])
    while (1 << len(st)) <= W:
        half = 1 << (len(st) - 1)
        prev = st[-1]
        st.append(np.minimum(prev[:, :-half], prev[:, half:]))
    cur = np.tile(np.arange(W), (R, 1))  # leftmost col with span-min >= own h
    for k in range(len(st) - 1, -1, -1):
        start = cur - (1 << k)
        sk = st[k]
        m = np.take_along_axis(sk, np.clip(start, 0, sk.shape[1] - 1), axis=1)
        ok = (start >= 0) & (m >= hts)
        cur = np.where(ok, start, cur)
    return cur - 1


def _largest_true_rect(mask: np.ndarray) -> tuple[slice, slice] | None:
    """Largest axis-aligned all-True rectangle of a 2D boolean mask: the
    per-row histogram formulation, vectorized (corrector.py:486)."""
    H, W = mask.shape
    ys = np.arange(H, dtype=np.int32)[:, None]
    last_false = np.maximum.accumulate(np.where(mask, -1, ys), axis=0)
    hts = ys - last_false  # consecutive True count ending at each row
    # row blocks of ~0.5M elements bound the range-minimum tables
    rb = max(1, (1 << 19) // max(W, 1))
    left = np.concatenate([_prev_smaller(hts[i:i + rb]) for i in range(0, H, rb)])
    right = (W - 1) - np.concatenate(
        [_prev_smaller(hts[i:i + rb, ::-1]) for i in range(0, H, rb)]
    )[:, ::-1]
    area = hts * (right - left - 1)
    flat = int(area.argmax())
    if area.flat[flat] == 0:
        return None
    y, x = divmod(flat, W)
    h = int(hts[y, x])
    return (slice(y - h + 1, y + 1), slice(int(left[y, x]) + 1, int(right[y, x])))


def _longest_true_run(v: np.ndarray) -> slice | None:
    """Longest contiguous True run of a 1D boolean array."""
    best, run_start, best_len = None, None, 0
    for i in range(len(v) + 1):
        if i < len(v) and v[i]:
            if run_start is None:
                run_start = i
        elif run_start is not None:
            if i - run_start > best_len:
                best_len, best = i - run_start, slice(run_start, i)
            run_start = None
    return best


def common_valid_region(transforms: np.ndarray, shape, device=None) -> tuple[slice, ...]:
    """The largest axis-aligned crop covered by EVERY corrected frame
    (corrector.py:457): every pixel inside the returned slices had an
    in-bounds source sample under every transform — the inscribed
    upright rectangle, not a bounding box.

        ys, xs = common_valid_region(res.transforms, stack.shape[1:])
        cropped = res.corrected[:, ys, xs]

    2D: transforms (T, 3, 3), shape (H, W) -> (ys, xs). 3D (rigid3d):
    transforms (T, 4, 4), shape (D, H, W) -> (zs, ys, xs), a z-run and a
    rectangle every plane of the run covers. The coverage masks are the
    port's `coverage_mask` / `coverage_mask_3d` on `device` (the card
    unless "cpu"), ANDed over batches of 256 transforms. Raises
    ValueError when no region is covered by every frame."""
    transforms = np.asarray(transforms, np.float32)
    d = transforms.shape[-1]
    if d == 4 and len(shape) != 3:
        raise ValueError("(T, 4, 4) transforms need shape=(D, H, W)")
    if d == 3 and len(shape) != 2:
        raise ValueError("(T, 3, 3) transforms need shape=(H, W)")
    mask_fn = coverage_mask_3d if d == 4 else coverage_mask
    shape = tuple(int(s) for s in shape)
    dev = resolve_device(device)
    # a running AND over transform batches: never a (T, *shape) mask
    common = torch.ones(shape, dtype=torch.bool, device=dev)
    for lo in range(0, len(transforms), 256):
        M = torch.as_tensor(transforms[lo:lo + 256], device=dev)
        common &= mask_fn(shape, M).all(dim=0)
    common = common.cpu().numpy()

    empty = ValueError(
        "no region is covered by every frame — the motion exceeds the "
        "frame overlap; inspect diagnostics['coverage'] / n_inliers"
    )
    if d == 3:
        rect = _largest_true_rect(common)
        if rect is None:
            raise empty
        return rect
    # 3D: start from the longest run of planes with any common coverage
    # and shrink it from the end that covers less until the AND over
    # the run holds a rectangle (per-pixel counts, one compare a step)
    zs = _longest_true_run(common.any(axis=(1, 2)))
    if zs is None:
        raise empty
    z0, z1 = zs.start, zs.stop
    count = common[z0:z1].sum(axis=0, dtype=np.int32)
    while z1 > z0:
        cur = count == (z1 - z0)
        if cur.any():
            rect = _largest_true_rect(cur)
            return (slice(z0, z1), rect[0], rect[1])
        if common[z0].sum() <= common[z1 - 1].sum():
            count -= common[z0]
            z0 += 1
        else:
            z1 -= 1
            count -= common[z1]
    raise empty


def _fingerprint(ref) -> str:
    """Identity of a reference selector in a resume signature: explicit
    arrays by content, everything else by repr (corrector.py:81)."""
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().cpu().numpy()
    if isinstance(ref, np.ndarray):
        h = hashlib.sha1(np.ascontiguousarray(ref).tobytes())
        h.update(str(ref.shape).encode())
        return f"array:{h.hexdigest()[:16]}"
    return repr(ref)


def _input_fingerprint(path) -> list:
    """Input identity of a source path (corrector.py:94): [size,
    mtime_ns] of a file; for a directory store (Zarr) the total bytes,
    newest mtime and entry count of its tree, which change whenever any
    chunk is rewritten; for an object-store URL, which has no stat
    identity, ["object", sha256 of its manifest]."""
    from kcmc_tpu_torch.io import objectstore

    if objectstore.is_object_url(path):
        client = objectstore.client_for_url(path)
        return ["object", objectstore.sha256_hex(client.get(objectstore.MANIFEST_KEY))]
    st = os.stat(path)
    if not os.path.isdir(path):
        return [int(st.st_size), int(st.st_mtime_ns)]
    total, newest, count = 0, 0, 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            s = os.stat(os.path.join(root, f))
            total += s.st_size
            newest = max(newest, s.st_mtime_ns)
            count += 1
    return [int(total), int(newest), int(count)]


class _StallWatchdog:
    """Hard-exit the process when frame progress freezes
    (`correct_file(stall_abort=)`, corrector.py:126): a wedged device
    wait cannot be interrupted by an exception, so a daemon thread
    samples the progress counter and calls os._exit(3). Pair with
    `checkpoint=` so the rerun resumes."""

    def __init__(self, timeout_s: float, get_done, total: int):
        self._timeout = float(timeout_s)
        self._get_done = get_done
        self._total = total
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kcmc-stall-watchdog", daemon=True
        )
        self._thread.start()

    def _run(self):
        last = self._get_done()
        last_change = time.monotonic()
        while not self._stop.wait(min(10.0, self._timeout / 4.0)):
            done = self._get_done()
            if done != last:
                last, last_change = done, time.monotonic()
            elif time.monotonic() - last_change > self._timeout:
                print(
                    f"[kcmc] STALL: no frame progress for {self._timeout:.0f}s "
                    f"(stuck at {done}/{self._total}); the device is likely "
                    "wedged. Exiting 3 — rerun with the same checkpoint to "
                    "resume.",
                    file=sys.stderr, flush=True,
                )
                os._exit(3)

    def stop(self):
        self._stop.set()


class _UploadWorker:
    """The single-thread upload executor of the pipelined dispatch
    (`upload_overlap`, kcmc_tpu/corrector.py:172): it runs only
    self-contained staging closures and touches no corrector state."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kcmc-upload")

    def submit(self, work):
        return self._ex.submit(work)

    def shutdown(self, wait: bool = True):
        self._ex.shutdown(wait=wait)


class MotionCorrector:
    """Register every frame of a (T, H, W) stack (model="rigid3d": every
    volume of a (T, D, H, W) z-stack series) to a reference and resample
    it.

    `device`: None runs on the card and raises when there is none;
    "cpu" runs every kernel's plain version (the tests' route).
    `backend`: a registered name (`backends.available_backends()`):
    None or "torch" builds a TorchBackend on `device`, "numpy" the
    pure-NumPy host oracle (it refuses a CUDA `device`); a backend
    instance is shared (the serving seam; its config must equal this
    corrector's). A plugin needs only `prepare_reference` and
    `process_batch`; the optional methods are probed.
    `reference`: a frame index, "first", "mean" (mean of the first
    `reference_window` frames) or an explicit (H, W) / (D, H, W) array.
    `template_iters`: rounds of template refinement (register the first
    `template_window` frames, default max(reference_window, 32), and
    take the mean of those the warp kept as the new reference).
    `template_update_every` / `template_update_alpha`: rolling template
    updates every that many frames, (1 - alpha) * template + alpha *
    the mean of the last `template_window` corrected frames.
    `mesh`: a tuple of devices (`parallel.make_mesh`) to shard every
    batch over; `mesh_devices` (or KCMC_DEVICES) resolves one.
    `config` / **overrides: a CorrectorConfig or keyword overrides
    (reference fields that are not ported raise NotImplementedError
    naming their ROADMAP.md item).

    `correct(stack)` registers an in-memory stack; `correct_file(path)`
    streams one from a file, with checkpoints and resume.
    """

    def __init__(
        self,
        model: str = "translation",
        reference=0,
        config: CorrectorConfig | None = None,
        device=None,
        reference_window: int = 16,
        template_iters: int = 0,
        template_window: int | None = None,
        template_update_every: int = 0,
        template_update_alpha: float = 0.5,
        mesh=None,
        backend=None,
        **overrides,
    ):
        base = config if config is not None else CorrectorConfig()
        self.config = base.replace(model=model, **port_fields(overrides))
        if backend is None or isinstance(backend, str):
            self.backend_name = backend or "torch"
            self.backend = _make_backend(self.backend_name, self.config, device, mesh)
        else:
            # a backend INSTANCE: the serving seam, many per-stream
            # correctors sharing one warm backend (corrector.py:689-711)
            if mesh is not None:
                raise ValueError(
                    "mesh= cannot be combined with a backend instance "
                    "(the instance already owns its mesh)"
                )
            shared_cfg = getattr(backend, "config", None)
            if shared_cfg is not None and shared_cfg != self.config:
                raise ValueError(
                    "shared backend instance was built for a different "
                    "CorrectorConfig than this corrector's — construct "
                    "the corrector with the backend's config (serve "
                    "sessions must not change compiled-program knobs)"
                )
            self.backend_name = getattr(backend, "name", type(backend).__name__)
            self.backend = backend
        self.reference = reference
        self.reference_window = reference_window
        self.template_iters = template_iters
        self.template_window = (
            template_window if template_window is not None else max(reference_window, 32)
        )
        if self.template_window < 1:
            raise ValueError(
                f"template_window must be >= 1 frame, got {self.template_window}"
            )
        if template_update_every < 0:
            raise ValueError(
                f"template_update_every must be >= 0 frames, got {template_update_every}"
            )
        if not 0.0 < template_update_alpha <= 1.0:
            raise ValueError(
                f"template_update_alpha must be in (0, 1], got {template_update_alpha}"
            )
        self.template_update_every = template_update_every
        self.template_update_alpha = template_update_alpha
        fb = self.config.failover_backend
        if fb:
            from kcmc_tpu_torch.backends import available_backends

            if fb not in available_backends():
                raise ValueError(
                    f"failover_backend must be a registered backend or None "
                    f"(no failover rung), got {fb!r}; available: "
                    f"{available_backends()}"
                )
        self._escalation_backend = None
        self._reset_rescue_policy()
        # robustness machinery, reset per run by _begin_robust_run
        self._fault_plan = None
        self._retry_policy = None
        self._io_retry_policy = None
        self._robustness = None
        self._out_template = None
        self._failover_backend = None
        self._failover_ref = None
        # armed by _begin_telemetry; None = everything off
        self._telemetry = None

    def stream_view(self, reference=None, template_update_every: int | None = None,
                    template_update_alpha: float | None = None) -> MotionCorrector:
        """A per-stream corrector that shares this corrector's backend
        (corrector.py:757): it builds no backend and holds its own
        reference, rolling-template cadence and rescue counters."""
        return MotionCorrector(
            model=self.config.model,
            backend=self.backend,
            reference=self.reference if reference is None else reference,
            config=self.config,
            reference_window=self.reference_window,
            template_iters=self.template_iters,
            template_window=self.template_window,
            template_update_every=(self.template_update_every
                                   if template_update_every is None
                                   else template_update_every),
            template_update_alpha=(self.template_update_alpha
                                   if template_update_alpha is None
                                   else template_update_alpha),
        )

    # -- execution plans (plans/) ------------------------------------------

    def warmup(self, buckets=None, dtypes=None, programs=None, progress=False) -> dict:
        """Run every hot program once for the declared shape buckets
        (`plan_buckets`, or `buckets=`), on zero-filled inputs through
        the backend's real entry points (corrector.py:798-822), so the
        first real batch finds its kernel libraries loaded, its allocator
        blocks and library handles made. The kernel libraries the
        programs launch are built first, in one parallel nvcc round.

        With `compile_cache_dir` / KCMC_COMPILE_CACHE the libraries live
        in that directory and every program is stamped there: a new
        process running the same warmup builds nothing (`stamp_misses
        == 0`, every library `cached`).

        dtypes: input dtypes to warm per bucket (default float32;
        integer dtypes also warm the device-side output cast).
        programs: subset of ("reference", "register",
        "update_reference", "apply"); default all that apply. Returns
        the build summary (programs built, stamp hits and misses,
        seconds, the libraries built and their seconds, and the
        backend's plan-cache snapshot)."""
        from kcmc_tpu_torch.plans.plan import ExecutionPlan

        return ExecutionPlan(self, buckets=buckets, dtypes=dtypes,
                             programs=programs).build(progress=progress)

    def _plan_timing(self, timing: dict) -> None:
        """Attach the backend's plan-cache snapshot to a run's timing
        whenever execution plans are configured or any program was built
        on the card (corrector.py:824-837). The CPU route compiles
        nothing, like the numpy backend, whose timing carries no
        plan_cache either; its first runs stay counted in
        `backend.plan_cache_stats()`. A backend without that method
        reports nothing."""
        stats_fn = getattr(self.backend, "plan_cache_stats", None)
        if stats_fn is None:
            return
        stats = stats_fn()
        built = stats.get("programs_compiled") and _backend_device(self.backend).type == "cuda"
        if stats.get("enabled") or built:
            timing["plan_cache"] = stats

    # -- observability ---------------------------------------------------

    def _begin_telemetry(self, timer: StageTimer, total: int | None = None):
        """Arm the run's telemetry (tracer, frame records, heartbeat)
        when any obs knob is set, else None (corrector.py:841). The
        @_telemetry_scope decorator on the public run methods owns
        teardown."""
        cfg = self.config
        if not cfg.observability_enabled:
            self._telemetry = None
            return None
        from kcmc_tpu_torch.obs.run import RunTelemetry

        self._telemetry = RunTelemetry.begin(
            cfg, backend=self.backend, backend_name=self.backend_name, timer=timer,
            report=self._robustness, total=total,
        )
        return self._telemetry

    def _reset_rescue_policy(self) -> None:
        """Out-of-bound telemetry, the escalation decision and the warm
        start's seed, reset at the start of every correct()
        (corrector.py:1627-1642)."""
        self._rescue_seen = 0
        self._rescue_count = 0
        self._rescue_window: list[tuple[int, int]] = []  # (frames, rescued)
        self._escalated = False
        self._escalated_at = None  # first frame the escalation backend took
        self._escalation_allowed = True  # checkpointed runs warn only
        self._rescue_warned = False
        self._warm_seed = None

    def _get_escalation_backend(self):
        """The same backend with warp="jnp" (exact, unbounded), built
        through the registry the first time the escalation trips, on the
        main backend's device and mesh (corrector.py:1990-2000); it takes
        the reference prepared by the main backend."""
        if self._escalation_backend is None:
            self._escalation_backend = get_backend(
                self.backend_name, self.config.replace(warp="jnp"), **twin_options(self.backend))
        return self._escalation_backend

    def _select_reference(self, stack):
        """The reference frame: an explicit array, or a slice of the
        stack (a tensor stack is sliced where it lies, then the one frame
        or window is converted)."""
        ref = self.reference
        if isinstance(ref, (np.ndarray, torch.Tensor)):
            if tuple(ref.shape) != tuple(stack.shape[1:]):
                raise ValueError(
                    f"reference shape {tuple(ref.shape)} != frame shape "
                    f"{tuple(stack.shape[1:])}"
                )
            return ref.float() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
        if isinstance(ref, str) and ref == "first":
            ref = 0
        if isinstance(ref, str) and ref == "mean":
            n = min(self.reference_window, len(stack))
            if isinstance(stack, torch.Tensor):
                return stack[:n].float().mean(dim=0)
            return np.mean(stack[:n], axis=0, dtype=np.float32)
        if isinstance(ref, (int, np.integer)):
            idx = int(ref)
            if not -len(stack) <= idx < len(stack):
                raise ValueError(
                    f"reference index {idx} out of range for {len(stack)} frames"
                )
            if isinstance(stack, torch.Tensor):
                return stack[idx].float()
            return np.asarray(stack[idx], np.float32)
        raise ValueError(f"bad reference selector: {ref!r}")

    @staticmethod
    def _pad_batch(batch, idx: np.ndarray, B: int):
        """Pad a tail batch to B frames by repeating its last frame;
        returns (n_valid, frames, indices). A tensor batch stays where it
        lies."""
        n = len(batch)
        if n < B:
            if isinstance(batch, torch.Tensor):
                batch = torch.cat([batch, batch[-1:].expand(B - n, *batch.shape[1:])])
            else:
                batch = np.concatenate([batch, np.repeat(batch[-1:], B - n, axis=0)])
            idx = np.concatenate([idx, np.repeat(idx[-1:], B - n)])
        return n, batch, idx

    def _segment_bounds(self, start: int, stop: int) -> list[tuple[int, int]]:
        """Frame ranges between rolling-template updates: boundaries at
        absolute multiples of `template_update_every`, so chunked runs
        update at the same frames as one-shot runs (corrector.py:1532)."""
        E = self.template_update_every
        if E <= 0:
            return [(start, stop)]
        bounds, lo = [], start
        while lo < stop:
            hi = min(stop, (lo // E + 1) * E)
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def _refine_reference(self, stack, ref_frame):
        """`template_iters` rounds: register the first `template_window`
        frames to the current reference (no quality metric, no rescue)
        and take the mean of the frames with warp_ok; stop when none has
        it (corrector.py:1188)."""
        W = min(len(stack), self.template_window)
        B = self.config.batch_size
        for _ in range(self.template_iters):
            ref = dict(self.backend.prepare_reference(ref_frame), _skip_quality=True)
            corrected, ok = [], []
            for lo in range(0, W, B):
                hi = min(lo + B, W)
                n, batch, idx = self._pad_batch(stack[lo:hi], np.arange(lo, hi), B)
                if getattr(self.backend, "process_batch_async", None) is None:
                    batch = _host_float(batch, self.backend)
                out = self.backend.process_batch(batch, ref, idx)
                corrected.append(out["corrected"][:n])
                ok.append(np.asarray(out["warp_ok"][:n], bool))
            frames = np.concatenate(corrected)[np.concatenate(ok)]
            if len(frames) == 0:  # every warp out of bounds: keep the ref
                break
            ref_frame = np.mean(frames, axis=0, dtype=np.float32)
        return ref_frame

    def _rolled_template(self, ref_frame, tail_corrected, tail_ok, window: int) -> np.ndarray:
        """One rolling update on the host: blend the mean of the last
        `window` frames the warp kept into the template, or keep it when
        there are none (corrector.py:1235)."""
        if not tail_corrected:
            return ref_frame
        frames = np.concatenate([_host(c).astype(np.float32) for c in tail_corrected])[-window:]
        ok = np.concatenate([_host(k).astype(bool) for k in tail_ok])[-window:]
        frames = frames[ok]
        if len(frames) == 0:
            return ref_frame
        mean = np.mean(frames, axis=0, dtype=np.float32)
        a = self.template_update_alpha
        return (1.0 - a) * _host(ref_frame).astype(np.float32) + a * mean

    def _template_tail(self, outs: list[dict], window: int):
        """(corrected, warp_ok) arrays covering the last `window` frames of
        the merged batch outputs (corrector.py:1298)."""
        tail_c, tail_ok, have = [], [], 0
        for host in reversed(outs):
            c = host["corrected"]
            k = host.get("warp_ok")
            k = np.ones(len(c), bool) if k is None else _host(k).astype(bool)
            take = min(len(c), window - have)
            tail_c.append(c[len(c) - take:])
            tail_ok.append(k[len(k) - take:])
            have += take
            if have >= window:
                break
        return list(reversed(tail_c)), list(reversed(tail_ok))

    @staticmethod
    def _collect_tail(tail: list, n: int, out: dict, window: int) -> None:
        """Keep each batch's (n_valid, corrected, warp_ok) device outputs,
        before any rescue, trimmed to batches covering the last `window`
        frames (corrector.py:1260); a batch without frames adds none."""
        if "corrected" not in out:
            return
        tail.append((n, out["corrected"], out.get("warp_ok")))
        while len(tail) > 1 and sum(t[0] for t in tail) - tail[0][0] >= window:
            tail.pop(0)

    def _update_reference_device(self, ref: dict, dev_tail: list, window: int) -> dict:
        """One update through the backend's `update_reference`; consumes
        the collected tail (corrector.py:1281)."""
        ref = self.backend.update_reference(
            ref,
            [c[:n] for n, c, _ in dev_tail],
            [np.ones(n, bool) if k is None else k[:n] for n, _, k in dev_tail],
            window,
            self.template_update_alpha,
        )
        dev_tail.clear()
        return ref

    def _maybe_escalate(self) -> None:
        """When more than `rescue_warn_fraction` of the frames seen so far,
        or of the sliding window, took the rescue, warn once and (with
        `rescue_escalate`) switch the remaining batches to the exact
        gather warp (corrector.py:2002-2045); checkpointed file runs
        only warn, so a resume stays byte-identical."""
        cfg = self.config
        if self._rescue_warned or self._rescue_seen < cfg.batch_size:
            return
        frac = self._rescue_count / max(self._rescue_seen, 1)
        wn = sum(n for n, _ in self._rescue_window)
        wr = sum(r for _, r in self._rescue_window)
        if wn >= cfg.batch_size:
            frac = max(frac, wr / wn)
        if frac <= cfg.rescue_warn_fraction:
            return
        self._rescue_warned = True
        detail = (
            f"{self._rescue_count}/{self._rescue_seen} frames "
            f"({100.0 * frac:.0f}%) exceeded the bounded warp kernel's "
            "static motion bound and took the per-frame exact-warp "
            "rescue path"
        )
        can_escalate = (cfg.rescue_escalate and self._escalation_allowed
                        and getattr(self.backend, "process_batch_async", None) is not None)
        if can_escalate:
            # decided at drain; the dispatch records the first frame the
            # escalation backend takes (`_escalated_at`)
            self._escalated = True
            advise(
                f"kcmc: {detail}; switching the remaining batches to the "
                "exact unbounded warp (one recompile, then full batch "
                "speed). Raise max_shear_px / set max_rotation_deg to "
                "keep such stacks on the fast bounded kernels.",
                stacklevel=3,
            )
        else:
            advise(
                f"kcmc: {detail}. Use warp='jnp', or raise max_shear_px / "
                "set max_rotation_deg, for stacks with persistently "
                "large motion.",
                stacklevel=3,
            )

    def _rescue_flagged(self, host: dict, batch, n: int, ref: dict) -> None:
        """Re-warp frames the bounded warp (K3, K7, K8, the separable
        chain or the rigid3d volume warp) zeroed (warp_ok False) through
        the exact gather path, in place; `warp_rescued` records which,
        and with `quality_metrics` their template_corr is recomputed
        (corrector.py:2093). Counts the batch for the out-of-bound policy
        first: the window holds the newest batches totalling at least
        max(256, 4 x batch) frames (corrector.py:2051-2066)."""
        ok = host.get("warp_ok")
        if ok is None or getattr(self.backend, "rescue_warp", None) is None:
            return
        ok = np.asarray(ok, bool)
        host["warp_rescued"] = ~ok
        n_bad = int((~ok).sum())
        self._rescue_seen += len(ok)
        self._rescue_count += n_bad
        self._rescue_window.append((len(ok), n_bad))
        win = max(256, 4 * self.config.batch_size)
        while sum(m for m, _ in self._rescue_window[:-1]) >= win:
            self._rescue_window.pop(0)
        self._maybe_escalate()
        if ok.all() or "corrected" not in host:
            return
        bad = np.nonzero(~ok)[0]
        sub = {k: host[k][bad] for k in ("transform", "field") if k in host}
        rescued = self.backend.rescue_warp(batch[:n][bad], sub, ref=ref)
        corrected = np.array(host["corrected"])
        # rounded and clipped like the batch when it came back cast
        corrected[bad] = _cast_output(rescued, corrected.dtype)
        host["corrected"] = corrected
        if "transform" in sub:
            # the rescue polished the flagged frames' transforms
            transforms = np.array(host["transform"])
            transforms[bad] = sub["transform"]
            host["transform"] = transforms
        host["warp_ok"] = np.ones_like(ok)
        if "template_corr" in host and ref is not None and hasattr(self.backend, "quality"):
            dev = _backend_device(self.backend)
            maps = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in sub.items()}
            corr, _ = self.backend.quality(
                torch.as_tensor(rescued, device=dev), maps, ref["frame"])
            tc = np.array(host["template_corr"])
            tc[bad] = corr.cpu().numpy()
            host["template_corr"] = tc

    # -- robustness: retry engine and degradation ladder ----------------

    def _begin_robust_run(self) -> None:
        """Arm the per-run robustness state (corrector.py:864): the fault
        plan (config spec or KCMC_FAULT_PLAN), one retry policy for the
        device surface and one for chunk reads (the prefetch thread has
        its own jitter stream), and a fresh RobustnessReport."""
        cfg = self.config
        self._fault_plan = faults.resolve_fault_plan(cfg.fault_plan, seed=cfg.seed)
        self._retry_policy = faults.default_io_retry_policy(cfg, seed_offset=0)
        self._io_retry_policy = faults.default_io_retry_policy(cfg, seed_offset=1)
        self._robustness = RobustnessReport()
        self._out_template = None
        # the failover backend stays cached; its reference is per run
        self._failover_ref = None

    def _robust_active(self) -> bool:
        return self._retry_policy is not None or self._fault_plan is not None

    def _note_out_template(self, out: dict) -> None:
        """Per-key (frame shape, dtype) of the first successful host
        batch: the synthesis template of the mark-failed rung."""
        if self._out_template is None:
            self._out_template = {
                k: (tuple(np.shape(v)[1:]), np.asarray(v).dtype) for k, v in out.items()
            }

    def _get_failover_backend(self):
        """Rung 2 (corrector.py:914): the failover backend through the
        registry (`get_backend(failover_backend, config)`), or None when
        disabled, identical to the primary or not constructible for this
        config. "numpy" is the host oracle, which ignores the mesh and
        the buckets; a banded config fails over to its dense matcher
        (the oracle refuses `match_radius`, and the dense matcher finds
        a superset of the banded matches)."""
        cfg = self.config
        name = cfg.failover_backend
        if not name or name == self.backend_name:
            return None
        if self._failover_backend is None:
            fb_cfg = cfg if cfg.match_radius is None else cfg.replace(match_radius=None)
            try:
                self._failover_backend = get_backend(name, fb_cfg)
            except Exception:
                return None
        return self._failover_backend

    def _failover_reference(self, fb, ref: dict) -> dict:
        """The failover backend's own prepared reference, rebuilt from
        the reference frame and cached per reference (corrector.py:936)."""
        cached = self._failover_ref
        if cached is not None and cached[0] is ref:
            return cached[1]
        frame = ref["frame"]
        if getattr(fb, "process_batch_async", None) is None:
            frame = _host(frame).astype(np.float32)  # a host backend gets host frames
        fb_ref = fb.prepare_reference(frame)
        if ref.get("_skip_quality"):
            fb_ref = dict(fb_ref, _skip_quality=True)
        self._failover_ref = (ref, fb_ref)
        return fb_ref

    @staticmethod
    def _apply_out_options(out: dict, emit_frames: bool, cast_dtype=None) -> dict:
        """A ladder result in the fast path's output contract:
        registration-only runs carry no frames, and an integer
        `cast_dtype` the card would have applied is applied on the host
        (corrector.py:961)."""
        if not emit_frames and "corrected" in out:
            out = {k: v for k, v in out.items() if k != "corrected"}
        if cast_dtype is not None and "corrected" in out:
            out = dict(out, corrected=_cast_output(np.asarray(out["corrected"]),
                                                   np.dtype(cast_dtype)))
        return out

    @staticmethod
    def _attempt_batch(backend, batch, ref, idx, seed, cast_dtype) -> dict:
        """One synchronous (re-)attempt of a batch on `backend`, as host
        arrays (corrector.py:950): a backend with the asynchronous seam
        takes the dispatch's seed and output cast; any other runs the
        plain `process_batch(frames, ref, indices)` on float32 frames
        unless it declares `accepts_native_dtype`."""
        if getattr(backend, "process_batch_async", None) is not None:
            kw = {} if cast_dtype is None else {"cast_dtype": cast_dtype}
            return backend.process_batch(batch, ref, idx, seed=seed, **kw)
        return {k: _host(v) for k, v in
                backend.process_batch(_host_float(batch, backend), ref, idx).items()}

    def _synthesize_failed_batch(self, batch, idx, emit_frames: bool, cast_dtype=None) -> dict:
        """Rung 3 (corrector.py:982): a placeholder for a batch every
        rung refused, shaped like the run's outputs — identity
        transforms (interpolated after the run), the raw input pixels,
        zero counts, NaN quality and warp_ok False (a rolling template
        must not blend unregistered pixels)."""
        B = len(idx)
        frames = None if batch is None else _host(batch).astype(np.float32)
        tshape = self._out_template.get("transform", ((3, 3), None))[0]
        d = tshape[-1] if tshape else 3
        out: dict[str, np.ndarray] = {}
        for k, (shape, dt) in self._out_template.items():
            if k == "corrected":
                out[k] = _cast_output(frames, dt)
            elif k == "transform":
                out[k] = np.tile(np.eye(d, dtype=dt), (B, 1, 1))
            elif k == "warp_ok":
                out[k] = np.zeros(B, dt)
            elif k in ("template_corr", "coverage"):
                out[k] = np.full((B,) + shape, np.nan, dt)
            else:  # field, n_keypoints, n_matches, n_inliers, rms_residual, ...
                out[k] = np.zeros((B,) + shape, dt)
        return self._apply_out_options(out, emit_frames, cast_dtype)

    def _ladder_batch(self, first_exc, backend, batch, ref, idx, seed, step,
                      n: int, emit_frames: bool, cast_dtype=None) -> tuple[dict, bool]:
        """Walk the degradation ladder for one failed batch
        (corrector.py:1010): (1) bounded retries with backoff on the same
        backend, (2) the failover backend, (3) mark the frames failed.
        Only injected TransientFaultErrors enter it
        (`faults.classify_device_transient`: the batch program does no
        I/O, so an OSError from it is a fault of the program, and the
        backend declares no transient device errors) — and a fatal error
        raises from any rung: the ladder outlives infrastructure, it
        never hides a fault of the program. Returns (host outputs,
        marked failed)."""
        plan, policy, report = self._fault_plan, self._retry_policy, self._robustness
        extra = tuple(getattr(backend, "transient_error_types", ()))
        if not faults.classify_device_transient(first_exc, extra):
            raise first_exc
        last = first_exc
        attempts = policy.attempts if policy is not None else 1
        for retry in range(attempts - 1):
            report.device_retries += 1
            policy.sleep(policy.delay(retry))
            try:
                if plan is not None:
                    plan.maybe_fail("device", step)
                out = self._apply_out_options(
                    self._attempt_batch(backend, batch, ref, idx, seed, cast_dtype),
                    emit_frames, cast_dtype)
                self._note_out_template(out)
                return out, False
            except Exception as e:
                last = e
                if not faults.classify_device_transient(e, extra):
                    raise
        fb = self._get_failover_backend()
        if fb is not None:
            try:
                if plan is not None:
                    plan.maybe_fail("failover", step)
                fb_ref = self._failover_reference(fb, ref)
                out = self._apply_out_options(
                    self._attempt_batch(fb, batch, fb_ref, idx, seed, cast_dtype),
                    emit_frames, cast_dtype)
                self._note_out_template(out)
                report.backend_failovers += 1
                report.failover_frame_indices.extend(int(i) for i in idx[:n])
                advise(
                    f"kcmc: device batch at frames {int(idx[0])}.."
                    f"{int(idx[n - 1])} failed {attempts} attempt(s) "
                    f"({type(last).__name__}: {last}); recovered on the "
                    f"'{self.config.failover_backend}' failover backend",
                    stacklevel=2,
                )
                return out, False
            except Exception as e:
                if not faults.classify_device_transient(
                        e, extra + tuple(getattr(fb, "transient_error_types", ()))):
                    raise
                last = e
        if not self.config.degrade_mark_failed or self._out_template is None:
            raise last
        report.failed_frame_indices.extend(int(i) for i in idx[:n])
        advise(
            f"kcmc: device batch at frames {int(idx[0])}..{int(idx[n - 1])} "
            f"failed on every ladder rung ({type(last).__name__}: {last}); "
            f"marking its {n} frame(s) failed — matrix-model transforms "
            "are rescued by trajectory interpolation, pixels stay "
            "uncorrected (diagnostics['frames_failed'])",
            stacklevel=2,
        )
        return self._synthesize_failed_batch(batch, idx, emit_frames, cast_dtype), True

    def _finalize_robustness(self, merged: dict, transforms, offset: int, length: int,
                             timing: dict, host: bool = True):
        """Publish the RobustnessReport into timing, expose the
        frames_failed mask and interpolate failed frames' matrix
        transforms (corrector.py:1124; piecewise failures stay marked
        only). Returns the transforms."""
        report = self._robustness
        if report is None:
            return transforms
        if self._fault_plan is not None:
            report.faults_injected = self._fault_plan.injected
        if report.failed_frame_indices and length > 0:
            local = np.asarray(report.failed_frame_indices, int) - offset
            local = local[(local >= 0) & (local < length)]
            mask = np.zeros(length, bool)
            mask[local] = True
            merged["frames_failed"] = mask
            if host and transforms is not None and (~mask).any() and mask.any():
                from kcmc_tpu_torch.utils.trajectory import interpolate_failed

                transforms = interpolate_failed(np.asarray(transforms), ~mask)
                report.rescued_frames += int(mask.sum())
        if self._robust_active() or report.any():
            timing["robustness"] = report.as_dict()
        return transforms

    @staticmethod
    def _new_dispatch_state() -> dict:
        """Cross-call state of the pipelined dispatch (corrector.py:1560):
        the in-flight window, the upload worker and the telemetry.
        Segmented runs pass one state through every `_dispatch_batches`
        call, so the window survives segment boundaries."""
        return {
            "inflight": [],  # in-flight entries, oldest first
            "flushes": 0,  # full drains of the window
            "timer": None,  # StageTimer of the drain_sync / upload_wait stalls
            "uploader": None,  # the upload worker, made at the first staging
            "upload_waits": 0,  # staged uploads the dispatch waited on
            "upload_overlap": False,  # whether any batch took a staged slot
            "frames": 0,  # frames dispatched so far in the run
        }

    @staticmethod
    def _close_dispatch(state: dict) -> None:
        """Join the upload worker (its slot, if any, is finished first)
        and drop what is still in flight: the end of a run or its
        failure. Idempotent."""
        uploader, state["uploader"] = state["uploader"], None
        if uploader is not None:
            uploader.shutdown(wait=True)
        state["inflight"].clear()

    def _dispatch_batches(self, batches, ref, drain, depth: int = 3, to_host: bool = True,
                          keep_frames: bool = False, emit_frames: bool = True,
                          on_dispatched=None, cast_dtype=None, state=None,
                          flush: bool = True, timer=None) -> None:
        """The pipelined dispatch core of `correct()` and `correct_file()`
        (corrector.py:1577-1923): for each (n_valid, frames, indices) of
        `batches`, dispatch the batch program on the current backend (the
        escalation backend once the out-of-bound policy tripped), seeded
        by the previous batch's transform with `warm_start`, keep `depth`
        batches in flight and drain the oldest with `drain(n,
        outputs[:n], frames or None, ref, failed)`, `ref` being the
        reference the batch was dispatched against. With `upload_overlap`
        the upload worker stages the next batch's upload
        (`backend.stage_upload`) while this one dispatches; the dispatch
        waits on it (the `upload_wait` stall). A slot staged for a
        backend the escalation has since replaced is dropped and the
        batch uploads inline. A batch that raises at dispatch drains the
        window first, then goes down the degradation ladder; a deferred
        device error surfaces at drain and enters the ladder there.
        Outputs are host numpy arrays, or device tensors with
        `to_host=False`; `keep_frames` hands the input frames to drain
        (the rescue needs them); `emit_frames=False` never downloads the
        corrected frames; `on_dispatched(n, out, idx)` sees every batch's
        device outputs at dispatch (the device template's tail);
        `cast_dtype` (an integer dtype) casts the corrected frames on the
        device. `state` (`_new_dispatch_state`) carries the window across
        calls; with `flush=False` the call returns with batches still in
        flight."""
        cfg = self.config
        cast_dtype = cast_dtype if emit_frames else None
        warm = cfg.warm_start and cfg.model != "piecewise"
        plan = self._fault_plan
        if state is None:
            state = self._new_dispatch_state()
        if timer is not None:
            state["timer"] = timer
        timer = state["timer"]
        inflight = state["inflight"]
        # obs seams (corrector.py:1645-1670): per-batch dispatch spans on
        # the consumer's track, upload spans on the worker's, and the
        # dispatch / device / drain latency segments; None when off
        tracer = getattr(timer, "tracer", None)
        tel = self._telemetry
        lat = tel.latency if tel is not None else None
        shard_args = None
        mesh = getattr(self.backend, "mesh", None)
        if tracer is not None and mesh is not None:
            shard_args = {
                "shards": len(mesh),
                "shard_devices": [d.index if d.index is not None else j
                                  for j, d in enumerate(mesh)][:16],
            }
        # the drain-time ladder re-runs a batch from its host frames
        keep_for_ladder = self._robust_active() and to_host and (keep_frames or emit_frames)

        def flush_inflight():
            if inflight:
                state["flushes"] += 1
            while inflight:
                self._drain_entry(inflight.pop(0), drain, to_host, state)

        def stage_on(backend, nxt_batch):
            """Submit the next batch's upload: (future, backend id), or
            None with upload_overlap off or a backend without the
            staging seam."""
            if not cfg.upload_overlap or getattr(backend, "stage_upload", None) is None:
                return None
            if state["uploader"] is None:
                state["uploader"] = _UploadWorker()
            work = functools.partial(backend.stage_upload, nxt_batch)
            if tracer is not None:
                inner = work

                def work():
                    t0 = time.perf_counter()
                    staged = inner()
                    tracer.complete("upload.stage", t0, time.perf_counter() - t0,
                                    cat="upload", args={"frames": int(nxt_batch.shape[0])})
                    return staged

            return state["uploader"].submit(work), id(backend)

        it = iter(batches)
        cur = next(it, None)
        slot = None  # the staged upload of `cur`: (future, backend id)
        try:
            while cur is not None:
                n, batch, idx = cur
                backend = self._get_escalation_backend() if self._escalated else self.backend
                if backend is not self.backend and self._escalated_at is None:
                    self._escalated_at = state["frames"]
                # a backend without the asynchronous seam runs each batch
                # inside a plain process_batch call (corrector.py:1768)
                dispatch = getattr(backend, "process_batch_async", None)
                if dispatch is None:
                    batch = _host_float(batch, backend)
                disp = batch  # what dispatch receives; `batch` stays the host frames
                if slot is not None:
                    (fut, owner), slot = slot, None
                    t_wait = time.perf_counter()
                    staged = fut.result()
                    if timer is not None:
                        timer.add_stall("upload_wait", time.perf_counter() - t_wait)
                    state["upload_waits"] += 1
                    if owner == id(backend):
                        disp = staged
                        state["upload_overlap"] = True
                    # else: the escalation replaced the backend between
                    # staging and dispatch; the batch uploads inline
                seed = (self._warm_seed, True) if warm and self._warm_seed is not None else None
                kept = batch if keep_frames else None
                # the next batch's upload runs on the worker while this
                # one dispatches and executes
                cur = next(it, None)
                if cur is not None and dispatch is not None:
                    slot = stage_on(backend, cur[1])
                step = plan.op_index("device") if plan is not None else None
                state["frames"] += n
                t_disp = time.perf_counter() if tracer is not None or lat is not None else 0.0
                try:
                    if plan is not None:
                        plan.maybe_fail("device", step)
                    if dispatch is not None:
                        out = dispatch(disp, ref, idx, seed=seed, to_host=to_host,
                                       cast_dtype=cast_dtype, emit_frames=emit_frames)
                    else:
                        out = {k: _host(v) for k, v in backend.process_batch(batch, ref, idx).items()}
                except Exception as e:
                    # the window drains first, so outputs stay in order
                    # and the ladder's synthesis template exists
                    flush_inflight()
                    res, failed = self._ladder_batch(e, backend, batch, ref, idx, seed,
                                                     step, n, emit_frames, cast_dtype)
                    if on_dispatched is not None:
                        on_dispatched(n, res, idx)
                    kept = self._failed_kept(res, kept, failed)
                    if not to_host:
                        res = _on_device(res, _backend_device(self.backend))
                    drain(n, {k: v[:n] for k, v in res.items()}, kept, ref, failed)
                    continue
                if warm and "transform" in out:
                    # the newest transform, still on the device, seeds
                    # the next batch's consensus
                    self._warm_seed = out["transform"][n - 1]
                if tracer is not None:
                    span_args = {"first_frame": int(idx[0]), "frames": int(n)}
                    if shard_args is not None:
                        span_args.update(shard_args)
                        span_args["frames_per_shard"] = -(-len(idx) // shard_args["shards"])
                    tracer.complete("dispatch_batch", t_disp, time.perf_counter() - t_disp,
                                    cat="dispatch", args=span_args)
                t_disp_done = 0.0
                if lat is not None:
                    t_disp_done = time.perf_counter()
                    if dispatch is not None:
                        # a synchronous backend ran the batch inside the
                        # call: that interval is its device segment
                        lat.observe("request.dispatch", t_disp_done - t_disp, n=n)
                if on_dispatched is not None:
                    on_dispatched(n, out, idx)
                if dispatch is None:
                    self._drain_sync(n, out, kept, ref, drain, to_host, emit_frames,
                                     t_disp, t_disp_done, timer)
                    continue
                # the staged tensor rides in the entry until its batch drains
                inflight.append((n, out, kept, batch if keep_for_ladder else None, idx, step,
                                 backend, seed, emit_frames, cast_dtype, ref, t_disp_done,
                                 disp if disp is not batch else None))
                if len(inflight) >= depth:
                    self._drain_entry(inflight.pop(0), drain, to_host, state)
            if flush:
                flush_inflight()
                self._close_dispatch(state)
        except BaseException:
            if slot is not None:
                slot[0].cancel()
            self._close_dispatch(state)
            raise

    def _drain_entry(self, entry, drain, to_host: bool, state: dict) -> None:
        """Drain one in-flight batch (corrector.py:1925): its downloads
        are materialized here (the `drain_sync` stall), where a deferred
        device error surfaces and enters the degradation ladder against
        the reference the batch was dispatched with. With latency
        telemetry the device segment runs from the dispatch's return to
        the materialized outputs, the drain segment over the callback
        (corrector.py:1950-1962)."""
        (n, out, kept, batch, idx, step, backend, seed, emit2, cast2, ref, t_disp_done,
         _staged) = entry
        failed = False
        if to_host:
            timer = state["timer"]
            try:
                with timer.stall("drain_sync") if timer is not None else contextlib.nullcontext():
                    to_host_fn = getattr(backend, "to_host", None)
                    res = (to_host_fn(out) if to_host_fn is not None
                           else {k: _host(v) for k, v in out.items()})
                if self._robust_active():
                    self._note_out_template(res)
            except Exception as e:
                res, failed = self._ladder_batch(e, backend, batch, ref, idx, seed, step, n,
                                                 emit2, cast2)
                kept = self._failed_kept(res, kept, failed)
        else:
            res = self._apply_out_options(dict(out), emit2)
        tel = self._telemetry
        lat = tel.latency if tel is not None else None
        if lat is not None and t_disp_done:
            t_host = time.perf_counter()
            lat.observe("request.device", t_host - t_disp_done, n=n)
            drain(n, {k: v[:n] for k, v in res.items()}, kept, ref, failed)
            lat.observe("request.drain", time.perf_counter() - t_host, n=n)
        else:
            drain(n, {k: v[:n] for k, v in res.items()}, kept, ref, failed)

    def _drain_sync(self, n, out, kept, ref, drain, to_host: bool, emit_frames: bool,
                    t_disp: float, t_disp_done: float, timer=None) -> None:
        """Drain a batch a synchronous backend returned, in order, right
        after its dispatch (corrector.py:1880-1897): frames dropped on
        registration-only runs, tensors on the backend's device with
        `to_host=False` (else the `drain_sync` stall of its host copy, as
        corrector.py:1418-1425 times it), and the call's interval as the
        device segment."""
        if not emit_frames and "corrected" in out:
            out = {k: v for k, v in out.items() if k != "corrected"}
        if self._robust_active():
            self._note_out_template(out)
        if not to_host:
            out = _on_device(out, _backend_device(self.backend))
        elif timer is not None:
            with timer.stall("drain_sync"):
                out = {k: np.asarray(v) for k, v in out.items()}
        tel = self._telemetry
        lat = tel.latency if tel is not None else None
        if lat is not None:
            lat.observe("request.device", t_disp_done - t_disp, n=n)
            t_host = time.perf_counter()
        drain(n, {k: v[:n] for k, v in out.items()}, kept, ref, False)
        if lat is not None:
            lat.observe("request.drain", time.perf_counter() - t_host, n=n)

    @staticmethod
    def _failed_kept(out: dict, kept, failed: bool):
        """A mark-failed batch's kept frames are withheld from drain, so
        the rescue cannot re-warp its synthesized output; its
        `warp_rescued` is preset to all False to keep the merged keys
        uniform (corrector.py:1963)."""
        if not failed:
            return kept
        if kept is not None and "warp_ok" in out:
            out["warp_rescued"] = np.zeros(len(out["warp_ok"]), bool)
        return None

    @staticmethod
    def _pipeline_report(state: dict, n_updates: int, dev_tmpl: bool) -> dict:
        """timing["pipeline"] (corrector.py:1505-1511)."""
        return {
            "drain_flushes": state["flushes"],
            "template_updates": n_updates,
            "device_templates": bool(dev_tmpl),
            "upload_overlap": state["upload_overlap"],
            "upload_waits": state["upload_waits"],
        }

    @_telemetry_scope
    def correct(self, stack, start_frame: int = 0, end_frame: int | None = None,
                progress: bool = False, device_outputs: bool = False,
                output_dtype="float32") -> CorrectionResult:
        """Correct a (T, H, W) stack, or a (T, D, H, W) one for rigid3d.

        `stack`: a numpy array, or a tensor (a CUDA tensor is sliced on
        the card, never copied whole to the host). `start_frame` /
        `end_frame` bound the frames processed; indices stay global, so
        chunked runs give the one-shot run's transforms (a rolling
        template restarts from the initial template in each call).
        `progress` prints "[kcmc] frames {hi}/{T}" per batch.
        `device_outputs` returns the arrays as tensors on the backend's
        device, without the rescue, in float32 (`output_dtype` ignored).
        `output_dtype`: "float32", "input" (the stack's dtype; integers
        rounded and clipped) or a dtype. Every batch runs under the
        robustness ladder; `timing["robustness"]` counts its rungs, and
        `diagnostics["frames_failed"]` marks frames it gave up on.
        `timing` carries the reference's keys (obs/registry.py
        TIMING_KEYS): the StageTimer report, `warp_escalated`,
        `pipeline`, `plan_cache`, `robustness` and, with telemetry
        armed, `latency`; `escalated_at` is the first frame the
        escalation backend took."""
        if not isinstance(stack, torch.Tensor) or (
                getattr(self.backend, "process_batch_async", None) is None):
            stack = _host(stack)  # a host backend reads host frames
        if stack.ndim not in (3, 4):
            raise ValueError(
                f"stack must be (T, H, W) or (T, D, H, W), got shape {tuple(stack.shape)}"
            )
        if stack.ndim == 4 and self.config.model != "rigid3d":
            raise ValueError(
                "4D (volumetric) stacks require model='rigid3d', got "
                f"{self.config.model!r}"
            )
        if stack.ndim == 3 and self.config.model == "rigid3d":
            raise ValueError("model='rigid3d' requires a (T, D, H, W) stack")
        cfg = self.config
        T = len(stack) if end_frame is None else min(end_frame, len(stack))
        self._reset_rescue_policy()
        self._begin_robust_run()
        timer = StageTimer()
        telemetry = self._begin_telemetry(timer, total=max(T - start_frame, 0))
        with timer.stage("prepare_reference"):
            ref_frame = self._select_reference(stack)
        if self.template_iters > 0:
            with timer.stage("refine_template"):
                ref_frame = self._refine_reference(stack, ref_frame)
        with timer.stage("prepare_reference"):
            ref = self.backend.prepare_reference(ref_frame)
        B = cfg.batch_size
        do_rescue = cfg.rescue_warp and not device_outputs
        out_dt = None if device_outputs else _resolve_dtype(output_dtype, _stack_dtype(stack))
        # integer targets are cast on the card before the download (half
        # the bytes for uint16); rolling templates keep float32 frames so
        # the template blends unrounded pixels (corrector.py:1401-1412)
        cast = (out_dt if out_dt is not None and np.issubdtype(out_dt, np.integer)
                and self.template_update_every <= 0 else None)
        segs = self._segment_bounds(start_frame, T)
        dev_tmpl = (len(segs) > 1 and cfg.device_templates
                    and hasattr(self.backend, "update_reference"))
        E = self.template_update_every
        tail_window = min(self.template_window, E) if E > 0 else 0
        dev_tail: list[tuple] = []
        outs = []
        n_updates = 0
        state = self._new_dispatch_state()
        rec_pos = [start_frame]  # global index of the next drained frame

        def batches(slo, shi):
            for lo in range(slo, shi, B):
                hi = min(lo + B, shi)
                yield self._pad_batch(stack[lo:hi], np.arange(lo, hi), B)
                if progress:
                    print(f"[kcmc] frames {hi}/{T}", flush=True)

        def drain(n, host, batch, eref, failed):
            if do_rescue and batch is not None:
                self._rescue_flagged(host, batch, n, eref)
            outs.append(host)
            if telemetry is not None:
                telemetry.note_batch(rec_pos[0], n, host, escalated=self._escalated)
            rec_pos[0] += n

        def on_dispatched(n, out, idx):
            self._collect_tail(dev_tail, n, out, tail_window)

        try:
            with timer.stage("register_batches"):
                for si, (slo, shi) in enumerate(segs):
                    last = si == len(segs) - 1
                    # device templates keep the window in flight across
                    # the boundaries; the host blend needs the segment
                    # drained
                    self._dispatch_batches(
                        batches(slo, shi), ref, drain, to_host=not device_outputs,
                        keep_frames=do_rescue,
                        on_dispatched=on_dispatched if dev_tmpl else None,
                        cast_dtype=cast, state=state, flush=last or not dev_tmpl, timer=timer,
                    )
                    if not last:  # rolling template update
                        W = min(self.template_window, shi - slo)
                        n_updates += 1
                        with timer.stall("template_update"):
                            if dev_tmpl:
                                ref = self._update_reference_device(ref, dev_tail, W)
                                ref_frame = ref["frame"]
                            else:
                                tail_c, tail_ok = self._template_tail(outs, W)
                                ref_frame = self._rolled_template(ref_frame, tail_c, tail_ok, W)
                                ref = self.backend.prepare_reference(ref_frame)
        finally:
            self._close_dispatch(state)
        if device_outputs:
            cat = torch.cat
            empty = torch.empty((0,) + tuple(stack.shape[1:]), dtype=torch.float32,
                                device=_backend_device(self.backend))
        else:
            cat = np.concatenate
            empty = np.empty((0,) + tuple(stack.shape[1:]), np.float32)
        merged = merge_outputs(outs, cat)
        corrected = merged.pop("corrected", empty)
        if not device_outputs:
            corrected = _cast_output(corrected, out_dt)  # a no-op when cast on the card
        n_frames = max(T - start_frame, 0)
        timing = timer.report(n_frames=n_frames)
        timing["warp_escalated"] = self._escalated
        self._plan_timing(timing)
        timing["pipeline"] = self._pipeline_report(state, n_updates, dev_tmpl)
        fields = merged.pop("field", None)
        transforms = self._finalize_robustness(
            merged, merged.pop("transform", None), start_frame, n_frames, timing,
            host=not device_outputs,
        )
        if telemetry is not None:
            telemetry.finish(timing)
        return CorrectionResult(corrected=corrected, transforms=transforms,
                                fields=fields, diagnostics=merged, timing=timing,
                                escalated_at=self._escalated_at)

    @_telemetry_scope
    def correct_file(self, path, output: str | None = None, chunk_size: int | None = None,
                     compression: str = "none", progress: bool = False, n_threads: int = 0,
                     output_dtype="input", checkpoint: str | None = None,
                     checkpoint_every: int = 512, stall_abort: float | None = None,
                     emit_frames: bool = True,
                     reader_options: dict | None = None) -> CorrectionResult:
        """Stream-correct a file-scale stack (corrector.py:2110).

        `path`: a multi-page TIFF, a Zarr v2 store, an HDF5 file, a .npy,
        a headerless .raw/.bin (shape and dtype through
        `reader_options`), an object-store URL (``emu://``; hedged,
        checksummed ranged reads under the run's retry policy and
        fault plan, io/objectstore.py), an array or a reader object
        (io/formats.py).
        Chunks of `chunk_size` frames (rounded up to whole batches)
        decode ahead of the card — the native threaded TIFF decoder, a
        decode pool with `io_workers >= 2` for GIL-bound codecs, else a
        prefetch thread — and with `output` the corrected frames stream
        to a TIFF (Zarr by .zarr, HDF5 by .h5, a chunked bucket with a
        durable manifest by an object-store URL) behind a background
        writer, so stacks larger than host memory run at steady state;
        `corrected` is then empty. `n_threads` (0 = `io_workers`) is the
        decode/encode worker budget.

        `output_dtype`: "input" (default: the file's dtype, integers
        rounded and clipped), "float32" or a dtype. `compression`:
        "none", "deflate" or "packbits".

        `checkpoint` (.npz; needs `output` and a file path): every
        `checkpoint_every` frames (whole batches; rolling-template runs
        wait for a window-safe cursor) the transforms and diagnostics
        and the writer's exact cursor are saved; a killed run called
        again with the same arguments resumes after the last saved frame
        and writes the bytes of an uninterrupted run (a torn tail page
        is truncated; a deflate output pins its zlib build). Checkpointed
        runs never escalate to the gather warp, so a resume stays
        byte-identical. `stall_abort`: seconds without progress after
        which the process exits with code 3. `emit_frames=False`:
        registration only (no `output`), the pass 1 of
        `apply_correction_file`.
        """
        from kcmc_tpu_torch.io import ChunkedStackLoader, feeder, objectstore, open_stack
        from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
        from kcmc_tpu_torch.io.formats import make_writer, resume_writer
        from kcmc_tpu_torch.utils.checkpoint import (
            load_stream_checkpoint,
            save_stream_checkpoint,
        )
        from kcmc_tpu_torch.utils.faults import default_io_retry_policy

        cfg = self.config
        B = cfg.batch_size
        chunk = chunk_size or max(B, 64)
        chunk = ((chunk + B - 1) // B) * B  # a multiple of the batch size
        io_workers = feeder.resolve_workers(n_threads if n_threads else cfg.io_workers)
        feed_prefetch = feeder.derive_prefetch(cfg.io_prefetch, B, chunk)
        feed_stats: dict = {}
        if checkpoint is not None and output is None:
            raise ValueError(
                "checkpoint requires output= (corrected frames are "
                "persisted in the output TIFF, not the checkpoint)"
            )
        if checkpoint is not None and not isinstance(path, (str, os.PathLike)):
            raise ValueError(
                "checkpoint= requires a file-path source — the resume "
                "signature fingerprints the file (size/mtime); an "
                "in-memory source has no cross-process identity"
            )
        if not emit_frames and output is not None:
            raise ValueError(
                "emit_frames=False is registration-only; it cannot be "
                "combined with output= (which asks for corrected frames)"
            )
        if stall_abort is not None and stall_abort <= 0:
            raise ValueError(
                f"stall_abort must be positive seconds, got {stall_abort} "
                "(use None to disable)"
            )
        self._reset_rescue_policy()
        # checkpointed runs stay on one warp kernel: the escalation's
        # switch shows at the interpolation level of in-bound frames
        self._escalation_allowed = checkpoint is None
        self._begin_robust_run()
        timer = StageTimer()
        telemetry = self._begin_telemetry(timer)
        tracer = telemetry.tracer if telemetry is not None else None

        with open_stack(path, n_threads=n_threads if n_threads else cfg.io_workers,
                        **(reader_options or {})) as ts:
            if isinstance(ts, objectstore.ObjectStack):
                # the run's robustness wiring: the shared fault plan, the
                # io retry policy (deadline-capped), retry/quarantine
                # accounting and the hedge knobs
                ts.arm(fault_plan=self._fault_plan, retry=self._io_retry_policy,
                       report=self._robustness, tracer=tracer, hedge_ms=cfg.object_hedge_ms,
                       timeout_s=cfg.object_timeout_s)
            if telemetry is not None:
                telemetry.set_total(len(ts))
            decoder = getattr(ts, "backend", type(ts).__name__)  # which decode ran
            want = 3 if cfg.model == "rigid3d" else 2
            if len(ts.frame_shape) != want:
                raise ValueError(
                    f"model {cfg.model!r} needs {want}D frames, got frame shape "
                    f"{tuple(ts.frame_shape)}"
                )
            with timer.stage("prepare_reference"):
                if isinstance(self.reference, (int, np.integer)):
                    idx = int(self.reference)
                    if not -len(ts) <= idx < len(ts):
                        raise ValueError(
                            f"reference index {idx} out of range for {len(ts)} frames"
                        )
                    if idx < 0:
                        idx += len(ts)
                    ref_frame = np.asarray(ts.read(idx, idx + 1)[0], np.float32)
                else:
                    is_first = isinstance(self.reference, str) and self.reference == "first"
                    head = ts.read(0, 1 if is_first else self.reference_window)
                    ref_frame = self._select_reference(np.asarray(head, np.float32))
            if self.template_iters > 0:
                with timer.stage("refine_template"):
                    W = min(len(ts), self.template_window)
                    head = np.asarray(ts.read(0, W), np.float32)
                    ref_frame = self._refine_reference(head, ref_frame)
            with timer.stage("prepare_reference"):
                ref = self.backend.prepare_reference(ref_frame)

            out_dt = _resolve_dtype(output_dtype, ts.dtype)
            outs = []
            writer = None
            start = 0
            n_parts = 0
            part_history: list = []
            ckpt_sig = None
            object_opts = None
            if output is not None and objectstore.is_object_url(output):
                # egress wiring with its own retry policy (seed_offset=2):
                # uploads run on the background writer's thread, and numpy
                # Generators are not thread-safe across the read side's
                object_opts = {
                    "chunk_frames": cfg.object_chunk_frames,
                    "part_bytes": cfg.object_part_bytes,
                    "fault_plan": self._fault_plan,
                    "retry": default_io_retry_policy(cfg, seed_offset=2),
                    "report": self._robustness,
                    "tracer": tracer,
                }
            if checkpoint is not None:
                # everything that changes the results or the output file;
                # the robustness and I/O knobs are normalized out, so a
                # rerun with another retry budget or fault plan resumes
                ckpt_sig = {
                    "config": repr(cfg.replace(**_ROBUSTNESS_SIG_NEUTRAL)),
                    "n_frames": len(ts),
                    "frame_shape": list(ts.frame_shape),
                    "dtype": str(ts.dtype),
                    "input": _input_fingerprint(path),
                    "backend": self.backend_name,
                    # an object URL is already absolute; abspath would
                    # glue the cwd onto its scheme
                    "output": (str(output) if object_opts is not None
                               else os.path.abspath(output)),
                    "reference": _fingerprint(self.reference),
                    "reference_window": self.reference_window,
                    "template_iters": self.template_iters,
                    "template_update_every": self.template_update_every,
                    "template_update_alpha": self.template_update_alpha,
                    "template_window": self.template_window,
                    "output_dtype": str(out_dt),
                    "compression": compression,
                }
                state = load_stream_checkpoint(
                    checkpoint, fault_plan=self._fault_plan, report=self._robustness
                )
                if state is not None and state[0].get("sig") == ckpt_sig:
                    meta, segments = state
                    try:
                        writer = resume_writer(output, meta["writer"], compression=compression,
                                               object_opts=object_opts)
                        start = int(meta["done"])
                        outs = segments
                        n_parts = int(meta.get("n_parts", 0))
                        part_history = list(meta.get("parts", []))[:n_parts]
                        # frames the ladder marked failed before the kill
                        self._robustness.failed_frame_indices.extend(
                            int(i) for i in meta.get("failed", []) if int(i) < start
                        )
                        tmpl = meta.get("arrays", {}).get("template")
                        if tmpl is not None:
                            # rolling templates: the template at the cursor
                            ref_frame = np.asarray(tmpl, np.float32)
                            ref = self.backend.prepare_reference(ref_frame)
                    except OSError:
                        # the output vanished or is shorter than the cursor
                        writer, start, outs, n_parts, part_history = None, 0, [], 0, []
                # a signature mismatch is a stale checkpoint: restart
            if writer is None and output:
                writer = make_writer(
                    output, len(ts), ts.frame_shape, out_dt, compression=compression,
                    bigtiff=_wants_bigtiff(len(ts), ts.frame_shape, out_dt),
                    object_opts=object_opts,
                )
            if writer is not None and cfg.writer_depth > 0:
                # checkpoint saves flush it to the durable mark first
                writer = AsyncBatchWriter(writer, depth=cfg.writer_depth, tracer=tracer)
            restored = start
            if telemetry is not None and start > 0:
                telemetry.resumed(start)
            cursor = {"done": start, "saved": start, "part": n_parts,
                      "seg_saved": len(outs), "history": part_history}
            roll = self.template_update_every > 0
            E = self.template_update_every
            W_roll = min(self.template_window, E) if roll else 0
            dev_tmpl = roll and cfg.device_templates and hasattr(self.backend, "update_reference")
            dp_state = self._new_dispatch_state()
            dev_tail: list[tuple] = []
            tail: list[dict] = []  # host path: last-window (corrected, warp_ok)
            # (boundary frame, template) pairs: a save pairs the drained
            # cursor with the template that governs it
            tmpl_hist: list[tuple] = [(start, ref_frame)]
            n_updates = 0

            def tmpl_at_cursor():
                while len(tmpl_hist) > 1 and tmpl_hist[1][0] <= cursor["done"]:
                    tmpl_hist.pop(0)
                return tmpl_hist[0][1]

            def save_ckpt():
                saved_meta = save_stream_checkpoint(
                    checkpoint,
                    {
                        "sig": ckpt_sig,
                        "done": cursor["done"],
                        "n_parts": cursor["part"],
                        "writer": writer.checkpoint_state(),
                        "parts": cursor["history"],
                        "failed": [int(i) for i in self._robustness.failed_frame_indices],
                    },
                    outs[cursor["seg_saved"]:],
                    cursor["part"],
                    arrays=({"template": _host(tmpl_at_cursor()).astype(np.float32)}
                            if roll else None),
                )
                cursor["history"] = saved_meta.get("parts", cursor["history"])
                if len(outs) > cursor["seg_saved"]:
                    cursor["part"] += 1
                cursor["seg_saved"] = len(outs)
                cursor["saved"] = cursor["done"]
                if telemetry is not None:
                    telemetry.checkpoint_saved(cursor["done"])

            def drain(n, host, batch, eref, failed):
                tail_src = host
                if cfg.rescue_warp and batch is not None and emit_frames:
                    self._rescue_flagged(host, batch, n, eref)
                else:
                    if cfg.rescue_warp and batch is not None and not dev_tmpl:
                        # the averaging window of a registration-only
                        # rolling run: rescue a copy for the template only
                        tail_src = dict(host)
                        self._rescue_flagged(tail_src, batch, n, eref)
                    if "template_corr" in host and "warp_ok" in host:
                        # measured on a frame the bounded warp zeroed
                        host["template_corr"] = np.where(
                            host["warp_ok"], host["template_corr"], np.nan)
                corrected = host.pop("corrected", None)
                if roll and not dev_tmpl and corrected is not None:
                    # pre-cast float32 pixels (post-rescue), trimmed at
                    # batch granularity; _rolled_template slices exactly
                    tail.append({
                        "corrected": tail_src.get("corrected", corrected),
                        "warp_ok": tail_src.get("warp_ok", np.ones(len(corrected), bool)),
                    })
                    have = sum(len(t["corrected"]) for t in tail)
                    while have - len(tail[0]["corrected"]) >= W_roll:
                        have -= len(tail.pop(0)["corrected"])
                if corrected is not None:
                    corrected = _cast_output(corrected, out_dt)  # no-op if cast on the card
                if writer is not None and corrected is not None:
                    writer.append_batch(corrected, n_threads=io_workers)
                elif corrected is not None and emit_frames:
                    host["corrected"] = corrected
                outs.append(host)
                if telemetry is not None:
                    telemetry.note_batch(cursor["done"], n, host, escalated=self._escalated)
                cursor["done"] += n
                # rolling runs save mid-segment only outside the next
                # boundary's averaging window (a resume inside it could
                # not rebuild the window), and at a boundary once its
                # update is recorded
                done = cursor["done"]
                boundary_ok = (roll and done > 0 and done % E == 0
                               and any(b == done for b, _ in tmpl_hist))
                safe = not roll or boundary_ok or 0 < done % E <= E - W_roll
                if (safe and checkpoint is not None
                        and cursor["done"] - cursor["saved"] >= checkpoint_every):
                    save_ckpt()

            def batches(loader):
                chunks = iter(loader)
                try:
                    for lo, hi, frames in chunks:
                        # native dtype: the batch program casts on the card
                        frames = np.asarray(frames)
                        for blo in range(lo, hi, B):
                            bhi = min(blo + B, hi)
                            yield self._pad_batch(frames[blo - lo:bhi - lo],
                                                  np.arange(blo, bhi), B)
                        if progress:
                            print(f"[kcmc] frames {hi}/{len(ts)}", flush=True)
                finally:
                    chunks.close()  # stop and join the prefetch thread

            def on_dispatched(n, out, idx):
                self._collect_tail(dev_tail, n, out, W_roll)

            # integer outputs are cast on the card (half the bytes of
            # the download), except on rolling runs, whose template must
            # blend unrounded pixels: drain casts those on the host
            cast = out_dt if np.issubdtype(out_dt, np.integer) and not roll else None
            watchdog = (_StallWatchdog(stall_abort, lambda: cursor["done"], len(ts))
                        if stall_abort else None)
            seg_bounds = self._segment_bounds(start, len(ts))
            batch_gen = None
            try:
                with timer.stage("register_batches"):
                    for si, (slo, shi) in enumerate(seg_bounds):
                        last_seg = si == len(seg_bounds) - 1
                        # registration-only rolling runs bring only each
                        # segment's averaging window off the card
                        if roll and not emit_frames and not last_seg:
                            W = min(self.template_window, shi - slo)
                            spans = ([(slo, shi - W, False), (shi - W, shi, True)]
                                     if shi - W > slo else [(slo, shi, True)])
                        else:
                            spans = [(slo, shi, emit_frames)]
                        for spi, (lo2, hi2, emit2) in enumerate(spans):
                            loader = ChunkedStackLoader(
                                ts, chunk_size=chunk, start=lo2, stop=hi2,
                                prefetch=feed_prefetch, fault_plan=self._fault_plan,
                                retry=self._io_retry_policy, report=self._robustness,
                                on_wait=lambda sec: timer.add_stall("prefetch_wait", sec),
                                io_workers=io_workers,
                                source_path=(path if isinstance(path, (str, os.PathLike))
                                             else None),
                                reader_options=reader_options, tracer=tracer,
                                stats=feed_stats,
                            )
                            batch_gen = batches(loader)
                            try:
                                self._dispatch_batches(
                                    batch_gen, ref, drain,
                                    keep_frames=(cfg.rescue_warp and emit2
                                                 and (emit_frames or not dev_tmpl)),
                                    emit_frames=emit2 and not (
                                        dev_tmpl and not emit_frames),
                                    on_dispatched=on_dispatched if dev_tmpl else None,
                                    cast_dtype=cast, state=dp_state, timer=timer,
                                    # device templates keep the window in
                                    # flight; only the very last span flushes
                                    flush=not dev_tmpl or (last_seg and spi == len(spans) - 1),
                                )
                            finally:
                                batch_gen.close()
                                batch_gen = None
                        if roll and not last_seg:
                            # the rolling update at the boundary, then a
                            # save (a resume restores this template here)
                            W = min(self.template_window, shi - slo)
                            n_updates += 1
                            with timer.stall("template_update"):
                                if dev_tmpl:
                                    ref = self._update_reference_device(ref, dev_tail, W)
                                    ref_frame = ref["frame"]
                                else:
                                    ref_frame = self._rolled_template(
                                        ref_frame, [t["corrected"] for t in tail],
                                        [t["warp_ok"] for t in tail], W)
                                    tail.clear()
                                    ref = self.backend.prepare_reference(ref_frame)
                            if checkpoint is not None:
                                tmpl_hist.append((shi, ref_frame))
                                while len(tmpl_hist) > 1 and tmpl_hist[1][0] <= cursor["done"]:
                                    tmpl_hist.pop(0)
                            if (checkpoint is not None and cursor["done"] == shi
                                    and cursor["done"] - cursor["saved"] >= checkpoint_every):
                                save_ckpt()
                if checkpoint is not None and cursor["done"] > cursor["saved"]:
                    save_ckpt()
            finally:
                self._close_dispatch(dp_state)
                if watchdog is not None:
                    watchdog.stop()
                # stop the prefetch thread before the reader closes
                if batch_gen is not None:
                    batch_gen.close()
                if writer is not None:
                    writer.close()

        merged = merge_outputs(outs)
        corrected = merged.pop("corrected", np.empty((0,) + tuple(ts.frame_shape), np.float32))
        if isinstance(writer, AsyncBatchWriter):
            wst = writer.stats()
            # trace=False: the writer traced each backpressure and flush
            # wait at source; these are totals only
            timer.add_stall("writer_backpressure", wst["backpressure_s"],
                            count=int(wst["batches"]), trace=False)
            timer.add_stall("writer_flush", wst["flush_s"], trace=False)
        # frames/s over the frames this run registered, not the restored
        timing = timer.report(n_frames=cursor["done"] - restored)
        timing["warp_escalated"] = self._escalated
        self._plan_timing(timing)
        timing["pipeline"] = self._pipeline_report(dp_state, n_updates, dev_tmpl)
        obj_stats = {}
        if isinstance(ts, objectstore.ObjectStack):
            # ingest counters (hedges, retries, throttles, live p95),
            # shared per URL by the consumer and thread-flavor workers
            obj_stats["ingest"] = ts.stats_snapshot()
        if object_opts is not None:
            obj_stats["egress"] = objectstore.stats_snapshot(str(output))
        if feed_stats.get("chunks") or obj_stats:
            feed_stats.pop("single_core_advised", None)
            # `decoder`: which decode ran (the native TIFF decoder or a
            # reader class)
            timing["feeder"] = dict(feed_stats, prefetch_chunks=feed_prefetch, decoder=decoder)
            if obj_stats:
                timing["feeder"]["object"] = obj_stats
        if checkpoint is not None:
            timing["restored_frames"] = restored
        transforms = self._finalize_robustness(
            merged, merged.pop("transform", None), 0, cursor["done"], timing
        )
        if telemetry is not None:
            telemetry.finish(timing)
        return CorrectionResult(corrected=corrected, transforms=transforms,
                                fields=merged.pop("field", None), diagnostics=merged,
                                timing=timing, escalated_at=self._escalated_at)
