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
correctors that share one backend. The port dispatches synchronously.

File-scale runs (`correct_file`, kcmc_tpu/corrector.py:2110-2837) stream
chunks through `io/` (native TIFF decoder, Zarr, HDF5, npy, raw; a
prefetch thread or a decode pool) into the same dispatch core as
`correct()`, write the corrected frames incrementally (TIFF, Zarr or
HDF5, behind a background writer) and checkpoint the recovered
transforms with the writer's exact cursor, so a killed run resumes and
writes the bytes of an uninterrupted one. Every batch runs under the
degradation ladder (:864-1166): injected transient faults are retried
with backoff, then re-run on the CPU failover backend, then marked
failed and interpolated; any other error of the batch program raises
(chunk reads retry OS-level I/O errors on their own surface).
`apply_correction_file` streams a stored registration onto another file,
and `common_valid_region` gives the crop every corrected frame covers.
Object-store URLs are queue 1 item 15c.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import threading
import time

import numpy as np
import torch

from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import SIG_NEUTRAL_FIELDS, CorrectorConfig
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

# The failover backends `failover_backend` may name: "numpy" (the
# reference's name for its plain-numpy backend) is the same config on
# the CPU, the kernels' plain versions; "torch" names the primary
# itself, which turns the rung off, as in the reference.
_FAILOVER_NAMES = (None, "numpy", "torch")


@dataclasses.dataclass
class CorrectionResult:
    corrected: np.ndarray  # (T, H, W), or (T, D, H, W) for rigid3d
    transforms: np.ndarray | None  # (T, 3, 3) ref -> frame maps ((T, 4, 4)
    # for rigid3d); None for piecewise
    diagnostics: dict  # per-frame arrays
    timing: dict
    fields: np.ndarray | None = None  # (T, gh, gw, 2) for piecewise


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
    """Input identity of a local source path (corrector.py:94): [size,
    mtime_ns] of a file; for a directory store (Zarr) the total bytes,
    newest mtime and entry count of its tree, which change whenever any
    chunk is rewritten."""
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


class MotionCorrector:
    """Register every frame of a (T, H, W) stack (model="rigid3d": every
    volume of a (T, D, H, W) z-stack series) to a reference and resample
    it.

    `device`: None runs on the card and raises when there is none;
    "cpu" runs every kernel's plain version (the tests' route).
    `backend`: None or "torch" builds a TorchBackend; a TorchBackend
    instance is shared (the serving seam; its config must equal this
    corrector's, and its device is used).
    `reference`: a frame index, "first", "mean" (mean of the first
    `reference_window` frames) or an explicit (H, W) / (D, H, W) array.
    `template_iters`: rounds of template refinement (register the first
    `template_window` frames, default max(reference_window, 32), and
    take the mean of those the warp kept as the new reference).
    `template_update_every` / `template_update_alpha`: rolling template
    updates every that many frames, (1 - alpha) * template + alpha *
    the mean of the last `template_window` corrected frames.
    `config` / **overrides: a CorrectorConfig or keyword overrides.

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
        self.config = base.replace(model=model, **overrides)
        if isinstance(backend, TorchBackend):
            if mesh is not None:
                raise ValueError(
                    "mesh= cannot be combined with a backend instance "
                    "(the instance already owns its mesh)"
                )
            if backend.config != self.config:
                raise ValueError(
                    "shared backend instance was built for a different "
                    "CorrectorConfig than this corrector's — construct "
                    "the corrector with the backend's config (serve "
                    "sessions must not change compiled-program knobs)"
                )
            self.backend = backend
        elif backend in (None, "torch"):
            if mesh is not None:
                raise NotImplementedError(
                    "multi-device meshes are not ported yet (ROADMAP.md queue 1 "
                    "item 17)"
                )
            self.backend = TorchBackend(self.config, device=device)
        else:
            raise ValueError(f"backend must be 'torch' or a TorchBackend, got {backend!r}")
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
        if self.config.failover_backend not in _FAILOVER_NAMES:
            raise ValueError(
                "failover_backend must be 'numpy' (the same config on "
                "device='cpu'), 'torch' or None (no failover rung), got "
                f"{self.config.failover_backend!r}"
            )
        self.backend_name = self.backend.name
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

    def _get_escalation_backend(self) -> TorchBackend:
        """The same backend with warp="jnp" (exact, unbounded), built the
        first time the escalation trips; it takes the reference prepared
        by the main backend."""
        if self._escalation_backend is None:
            self._escalation_backend = TorchBackend(
                self.config.replace(warp="jnp"), device=self.backend.device
            )
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
        if cfg.rescue_escalate and self._escalation_allowed:
            self._escalated = True
            self._escalated_at = self._rescue_seen
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
        ok = np.asarray(host["warp_ok"], bool)
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
        corrected[bad] = rescued
        host["corrected"] = corrected
        if "transform" in sub:
            # the rescue polished the flagged frames' transforms
            transforms = np.array(host["transform"])
            transforms[bad] = sub["transform"]
            host["transform"] = transforms
        host["warp_ok"] = np.ones_like(ok)
        if "template_corr" in host and ref is not None:
            dev = self.backend.device
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
        """Rung 2 (corrector.py:914): the failover backend, or None when
        disabled or identical to the primary. "numpy" is a TorchBackend
        of the same config on the CPU: the kernels' plain versions, the
        same algorithm."""
        name = self.config.failover_backend
        if not name or name == self.backend_name:
            return None
        if self._failover_backend is None:
            self._failover_backend = TorchBackend(self.config, device="cpu")
        return self._failover_backend

    def _failover_reference(self, fb, ref: dict) -> dict:
        """The failover backend's own prepared reference, rebuilt from
        the reference frame and cached per reference (corrector.py:936)."""
        cached = self._failover_ref
        if cached is not None and cached[0] is ref:
            return cached[1]
        fb_ref = fb.prepare_reference(ref["frame"])
        if ref.get("_skip_quality"):
            fb_ref = dict(fb_ref, _skip_quality=True)
        self._failover_ref = (ref, fb_ref)
        return fb_ref

    @staticmethod
    def _apply_out_options(out: dict, emit_frames: bool) -> dict:
        """A ladder result in the fast path's output contract:
        registration-only runs carry no frames."""
        if not emit_frames and "corrected" in out:
            out = {k: v for k, v in out.items() if k != "corrected"}
        return out

    def _synthesize_failed_batch(self, batch, idx, emit_frames: bool) -> dict:
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
        return self._apply_out_options(out, emit_frames)

    def _ladder_batch(self, first_exc, backend, batch, ref, idx, seed, step,
                      n: int, emit_frames: bool) -> tuple[dict, bool]:
        """Walk the degradation ladder for one failed batch
        (corrector.py:1019): (1) bounded retries with backoff on the same
        backend, (2) the failover backend, (3) mark the frames failed.
        Only injected TransientFaultErrors enter it
        (`faults.classify_device_transient`: the batch program does no
        I/O, so an OSError from it is a fault of the program, and the
        backend declares no transient device errors) — and a fatal error
        raises from any rung: the ladder outlives infrastructure, it
        never hides a fault of the program. Returns (host outputs,
        marked failed)."""
        plan, policy, report = self._fault_plan, self._retry_policy, self._robustness
        extra = backend.transient_error_types
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
                    backend.process_batch(batch, ref, idx, seed=seed), emit_frames)
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
                    fb.process_batch(batch, fb_ref, idx, seed=seed), emit_frames)
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
                if not faults.classify_device_transient(e, extra + fb.transient_error_types):
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
        return self._synthesize_failed_batch(batch, idx, emit_frames), True

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

    def _dispatch_batches(self, batches, ref, drain, to_host: bool = True,
                          keep_frames: bool = False, emit_frames: bool = True,
                          on_dispatched=None) -> None:
        """The dispatch core of `correct()` and `correct_file()`
        (corrector.py:1577): for each (n_valid, frames, indices) of
        `batches`, run the batch program on the current backend (the
        escalation backend once the out-of-bound policy tripped), seeded
        by the previous batch's transform with `warm_start`, and call
        `drain(n, outputs[:n], frames or None, ref, failed)`. A batch
        that raises goes down the degradation ladder. Outputs are host
        numpy arrays, or device tensors with `to_host=False`;
        `keep_frames` hands the input frames to drain (the rescue needs
        them); `emit_frames=False` drops the corrected frames before
        they leave the device; `on_dispatched(n, out, idx)` sees every
        batch's outputs first (the device template's tail)."""
        cfg = self.config
        warm = cfg.warm_start and cfg.model != "piecewise"
        plan = self._fault_plan
        for n, batch, idx in batches:
            backend = self._get_escalation_backend() if self._escalated else self.backend
            seed = (self._warm_seed, True) if warm and self._warm_seed is not None else None
            step = plan.op_index("device") if plan is not None else None
            kept = batch if keep_frames else None
            try:
                if plan is not None:
                    plan.maybe_fail("device", step)
                out = backend.process_batch(batch, ref, idx, seed=seed, to_host=False)
                if on_dispatched is not None:
                    on_dispatched(n, out, idx)
                res = self._apply_out_options(out, emit_frames)
                if to_host:
                    # a deferred CUDA error surfaces here, inside the try
                    res = backend.to_host(res)
            except Exception as e:
                res, failed = self._ladder_batch(e, backend, batch, ref, idx, seed,
                                                 step, n, emit_frames)
                if on_dispatched is not None:
                    on_dispatched(n, res, idx)
                if failed:
                    if kept is not None and "warp_ok" in res:
                        # the rescue skips a synthesized batch; its key stays
                        res["warp_rescued"] = np.zeros(len(res["warp_ok"]), bool)
                    kept = None
                if not to_host:
                    dev = self.backend.device
                    res = {k: torch.as_tensor(v, device=dev) for k, v in res.items()}
                drain(n, {k: v[:n] for k, v in res.items()}, kept, ref, failed)
                continue
            if warm:
                # the newest transform seeds the next batch's consensus
                self._warm_seed = out["transform"][n - 1]
            if to_host and self._robust_active():
                self._note_out_template(res)
            drain(n, {k: v[:n] for k, v in res.items()}, kept, ref, False)

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
        `diagnostics["frames_failed"]` marks frames it gave up on."""
        if not isinstance(stack, torch.Tensor):
            stack = np.asarray(stack)
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
        t0 = time.perf_counter()
        self._reset_rescue_policy()
        self._begin_robust_run()
        ref_frame = self._select_reference(stack)
        if self.template_iters > 0:
            ref_frame = self._refine_reference(stack, ref_frame)
        ref = self.backend.prepare_reference(ref_frame)
        B = cfg.batch_size
        do_rescue = cfg.rescue_warp and not device_outputs
        segs = self._segment_bounds(start_frame, T)
        dev_tmpl = len(segs) > 1 and cfg.device_templates
        E = self.template_update_every
        tail_window = min(self.template_window, E) if E > 0 else 0
        dev_tail: list[tuple] = []
        outs = []
        n_updates = 0

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

        def on_dispatched(n, out, idx):
            self._collect_tail(dev_tail, n, out, tail_window)

        for si, (slo, shi) in enumerate(segs):
            self._dispatch_batches(
                batches(slo, shi), ref, drain, to_host=not device_outputs,
                keep_frames=do_rescue, on_dispatched=on_dispatched if dev_tmpl else None,
            )
            if si < len(segs) - 1:  # rolling template update
                W = min(self.template_window, shi - slo)
                n_updates += 1
                if dev_tmpl:
                    ref = self._update_reference_device(ref, dev_tail, W)
                    ref_frame = ref["frame"]
                else:
                    tail_c, tail_ok = self._template_tail(outs, W)
                    ref_frame = self._rolled_template(ref_frame, tail_c, tail_ok, W)
                    ref = self.backend.prepare_reference(ref_frame)
        if device_outputs:
            cat = torch.cat
            empty = torch.empty((0,) + tuple(stack.shape[1:]), dtype=torch.float32,
                                device=self.backend.device)
        else:
            cat = np.concatenate
            empty = np.empty((0,) + tuple(stack.shape[1:]), np.float32)
        merged = {k: cat([o[k] for o in outs]) for k in outs[0]} if outs else {}
        seconds = time.perf_counter() - t0
        corrected = merged.pop("corrected", empty)
        if not device_outputs:
            corrected = _cast_output(corrected, _resolve_dtype(output_dtype, _stack_dtype(stack)))
        n_frames = max(T - start_frame, 0)
        timing = {
            "seconds": seconds,
            "frames_per_sec": n_frames / seconds if seconds > 0 else None,
            "device": str(self.backend.device),
            "warp_escalated": self._escalated,
            "warp_escalated_at": self._escalated_at,
            "pipeline": {"template_updates": n_updates,
                         "device_templates": bool(dev_tmpl)},
        }
        fields = merged.pop("field", None)
        transforms = self._finalize_robustness(
            merged, merged.pop("transform", None), start_frame, n_frames, timing,
            host=not device_outputs,
        )
        return CorrectionResult(corrected=corrected, transforms=transforms,
                                fields=fields, diagnostics=merged, timing=timing)

    def correct_file(self, path, output: str | None = None, chunk_size: int | None = None,
                     compression: str = "none", progress: bool = False, n_threads: int = 0,
                     output_dtype="input", checkpoint: str | None = None,
                     checkpoint_every: int = 512, stall_abort: float | None = None,
                     emit_frames: bool = True,
                     reader_options: dict | None = None) -> CorrectionResult:
        """Stream-correct a file-scale stack (corrector.py:2110).

        `path`: a multi-page TIFF, a Zarr v2 store, an HDF5 file, a .npy,
        a headerless .raw/.bin (shape and dtype through
        `reader_options`), an array or a reader object (io/formats.py).
        Chunks of `chunk_size` frames (rounded up to whole batches)
        decode ahead of the card — the native threaded TIFF decoder, a
        decode pool with `io_workers >= 2` for GIL-bound codecs, else a
        prefetch thread — and with `output` the corrected frames stream
        to a TIFF (Zarr by .zarr, HDF5 by .h5) behind a background
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
        from kcmc_tpu_torch.io import ChunkedStackLoader, feeder, open_stack
        from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
        from kcmc_tpu_torch.io.formats import is_object_url, make_writer, resume_writer
        from kcmc_tpu_torch.utils.checkpoint import (
            load_stream_checkpoint,
            save_stream_checkpoint,
        )

        for url in (path, output):
            if is_object_url(url):
                raise NotImplementedError(
                    f"object-store URLs ({url!r}) are not ported yet "
                    "(ROADMAP.md queue 1 item 15c)"
                )
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

        with open_stack(path, n_threads=n_threads if n_threads else cfg.io_workers,
                        **(reader_options or {})) as ts:
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
                    "output": os.path.abspath(output),
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
                        writer = resume_writer(output, meta["writer"], compression=compression)
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
                )
            if writer is not None and cfg.writer_depth > 0:
                # checkpoint saves flush it to the durable mark first
                writer = AsyncBatchWriter(writer, depth=cfg.writer_depth)
            restored = start
            cursor = {"done": start, "saved": start, "part": n_parts,
                      "seg_saved": len(outs), "history": part_history}
            roll = self.template_update_every > 0
            E = self.template_update_every
            W_roll = min(self.template_window, E) if roll else 0
            dev_tmpl = roll and cfg.device_templates
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
                    corrected = _cast_output(corrected, out_dt)
                if writer is not None and corrected is not None:
                    writer.append_batch(corrected, n_threads=io_workers)
                elif corrected is not None and emit_frames:
                    host["corrected"] = corrected
                outs.append(host)
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
                        for lo2, hi2, emit2 in spans:
                            loader = ChunkedStackLoader(
                                ts, chunk_size=chunk, start=lo2, stop=hi2,
                                prefetch=feed_prefetch, fault_plan=self._fault_plan,
                                retry=self._io_retry_policy, report=self._robustness,
                                on_wait=lambda sec: timer.add_stall("prefetch_wait", sec),
                                io_workers=io_workers,
                                source_path=(path if isinstance(path, (str, os.PathLike))
                                             else None),
                                reader_options=reader_options, stats=feed_stats,
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
                if watchdog is not None:
                    watchdog.stop()
                # stop the prefetch thread before the reader closes
                if batch_gen is not None:
                    batch_gen.close()
                if writer is not None:
                    writer.close()

        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]} if outs else {}
        corrected = merged.pop("corrected", np.empty((0,) + tuple(ts.frame_shape), np.float32))
        if isinstance(writer, AsyncBatchWriter):
            wst = writer.stats()
            timer.add_stall("writer_backpressure", wst["backpressure_s"],
                            count=int(wst["batches"]))
            timer.add_stall("writer_flush", wst["flush_s"])
        # frames/s over the frames this run registered, not the restored
        timing = timer.report(n_frames=cursor["done"] - restored)
        timing.update({
            "device": str(self.backend.device),
            "decoder": decoder,
            "warp_escalated": self._escalated,
            "warp_escalated_at": self._escalated_at,
            "pipeline": {"template_updates": n_updates, "device_templates": bool(dev_tmpl)},
        })
        if feed_stats.get("chunks"):
            feed_stats.pop("single_core_advised", None)
            timing["feeder"] = dict(feed_stats, prefetch_chunks=feed_prefetch)
        if checkpoint is not None:
            timing["restored_frames"] = restored
        transforms = self._finalize_robustness(
            merged, merged.pop("transform", None), 0, cursor["done"], timing
        )
        return CorrectionResult(corrected=corrected, transforms=transforms,
                                fields=merged.pop("field", None), diagnostics=merged,
                                timing=timing)
