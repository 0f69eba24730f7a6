"""Pluggable streaming ingest: one reader protocol, many formats (the
port's copy of kcmc_tpu/io/formats.py).

The microscopy ecosystem ships HDF5 / Zarr / raw-binary stacks as often
as TIFF. The whole file-scale streaming machinery (prefetch
thread, checkpoint-resume, stall watchdog, registration-only passes)
only needs the small duck-typed protocol `TiffStack` already satisfies:

    len(reader)            -> frame count
    reader.frame_shape     -> per-frame shape tuple
    reader.dtype           -> numpy dtype of stored frames
    reader.read(lo, hi)    -> (hi-lo, *frame_shape) ndarray
    context manager        -> closes underlying handles

This module provides that protocol over:

* ``ZarrStack``   — Zarr v2 directory stores. Uses the ``zarr`` package
  when installed; otherwise a built-in pure-Python reader handles the
  common case (C-order, 3D/4D, raw/zlib/gzip chunks) with an explicit
  error for exotic compressors. No hard dependency either way.
* ``HDF5Stack``   — HDF5 datasets via ``h5py`` (guarded import), with
  single-3D-dataset auto-discovery.
* ``NpyStack``    — ``.npy`` arrays, memory-mapped (zero-copy slicing).
* ``RawStack``    — headerless binary via ``np.memmap`` (shape + dtype
  supplied by the caller).
* ``ArrayStack``  — any in-memory array-like with axis-0 slicing.
* object-store URLs (``emu://...``) — ``io/objectstore.ObjectStack``
  over the chunked bucket layout; ``ObjectStoreWriter`` writes one.

``open_stack`` dispatches on extension / source type and is what
``MotionCorrector.correct_file`` uses, so ``correct_file("stack.zarr",
checkpoint=...)`` streams with the same kill-safe resume machinery as a
TIFF. The WRITE side is pluggable too: ``ZarrWriter``
implements the TiffWriter streaming protocol (incremental append,
checkpoint_state/resume, parallel deflate) over a Zarr v2 directory
store, and ``HDF5Writer`` the same over a contiguous early-allocated
HDF5 dataset (uncompressed — the layout that keeps SIGKILL from
corrupting HDF5 metadata), so ``correct_file("in.zarr",
output="out.zarr")`` and ``correct_file("in.h5", output="out.h5")``
round-trip without transcoding to TIFF. Registration-only runs have no
output file at all.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np


class _BaseStack:
    """Context-manager plumbing shared by the readers."""

    frame_shape: tuple
    dtype: np.dtype

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):  # pragma: no cover - trivial default
        pass

    def __len__(self) -> int:
        return self._n


class ArrayStack(_BaseStack):
    """Adapter for any array-like with numpy-style axis-0 slicing
    (ndarray, memmap, dask/zarr arrays, h5py datasets...)."""

    def __init__(self, source):
        if getattr(source, "ndim", len(getattr(source, "shape", ()))) not in (3, 4):
            raise ValueError(
                "stack source must be 3D (T, H, W) or 4D (T, D, H, W), "
                f"got shape {getattr(source, 'shape', None)}"
            )
        self.source = source
        self._n = source.shape[0]
        self.frame_shape = tuple(source.shape[1:])
        self.dtype = np.dtype(source.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        return np.asarray(self.source[lo:hi])


class NpyStack(ArrayStack):
    """A ``.npy`` stack, memory-mapped: reads touch only the sliced
    frames, so 100 GB files stream fine."""

    def __init__(self, path):
        super().__init__(np.load(path, mmap_mode="r"))


class RawStack(ArrayStack):
    """Headerless binary: caller supplies shape and dtype (the usual
    acquisition-software dump: fixed-size frames, C order, optional
    fixed header skipped via ``offset`` bytes)."""

    def __init__(self, path, shape, dtype, offset: int = 0):
        mm = np.memmap(
            path, dtype=np.dtype(dtype), mode="r", offset=int(offset),
            shape=tuple(int(s) for s in shape),
        )
        super().__init__(mm)


class HDF5Stack(_BaseStack):
    """An HDF5 dataset. `dataset` names it; omitted, the file must
    contain exactly one 3D/4D dataset (auto-discovered)."""

    def __init__(self, path, dataset: str | None = None):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover - present on image
            raise ImportError(
                "HDF5 ingest needs the optional h5py package"
            ) from e
        self._f = h5py.File(path, "r")
        if dataset is None:
            cands = []

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset) and obj.ndim in (3, 4):
                    cands.append(name)

            self._f.visititems(visit)
            if len(cands) != 1:
                self._f.close()
                raise ValueError(
                    f"{path}: expected exactly one 3D/4D dataset, found "
                    f"{cands or 'none'} — pass dataset='name'"
                )
            dataset = cands[0]
        self._d = self._f[dataset]
        if self._d.ndim not in (3, 4):
            self._f.close()
            raise ValueError(
                f"dataset {dataset!r} is {self._d.ndim}D, need 3D/4D"
            )
        self._n = self._d.shape[0]
        self.frame_shape = tuple(self._d.shape[1:])
        self.dtype = np.dtype(self._d.dtype)

    def read(self, lo: int, hi: int) -> np.ndarray:
        return np.asarray(self._d[lo:hi])

    def close(self):
        self._f.close()


class _MiniZarr:
    """Pure-Python Zarr v2 array reader: C-order, raw/zlib/gzip chunks.

    Covers the stores scientific pipelines commonly write without
    pulling in the zarr/numcodecs stack; anything fancier (blosc, F
    order, filters) gets an explicit error pointing at the optional
    dependency.
    """

    def __init__(self, path):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{path}: only zarr v2 stores supported")
        if meta.get("order", "C") != "C":
            raise ValueError(
                f"{path}: F-order store needs the optional zarr package"
            )
        if meta.get("filters"):
            raise ValueError(
                f"{path}: filtered store needs the optional zarr package"
            )
        comp = meta.get("compressor")
        cid = None if comp is None else comp.get("id")
        if cid not in (None, "zlib", "gzip"):
            raise ValueError(
                f"{path}: compressor {cid!r} needs the optional zarr "
                "package (built-in reader handles raw/zlib/gzip)"
            )
        self._zlib = cid is not None
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill = meta.get("fill_value", 0) or 0
        self.sep = meta.get("dimension_separator", ".")
        self.ndim = len(self.shape)

    def _chunk(self, idx) -> np.ndarray:
        name = self.sep.join(str(i) for i in idx)
        p = os.path.join(self.path, name)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill, self.dtype)
        with open(p, "rb") as f:
            buf = f.read()
        if self._zlib:
            # zlib stream or gzip wrapper — wbits=47 accepts both
            buf = zlib.decompress(buf, 47)
        return np.frombuffer(buf, self.dtype).reshape(self.chunks)

    def __getitem__(self, sl) -> np.ndarray:
        lo, hi = sl.start or 0, sl.stop if sl.stop is not None else self.shape[0]
        hi = min(hi, self.shape[0])
        out = np.empty((hi - lo,) + self.shape[1:], self.dtype)
        c0 = self.chunks[0]
        grids = [
            -(-s // c) for s, c in zip(self.shape[1:], self.chunks[1:])
        ]
        for ci in range(lo // c0, -(-hi // c0)):
            t0 = ci * c0
            s_lo, s_hi = max(lo, t0), min(hi, t0 + c0)
            idx_rest = np.ndindex(*grids)
            for rest in idx_rest:
                chunk = self._chunk((ci,) + rest)
                # destination window of this chunk in the spatial dims
                dst = [slice(s_lo - lo, s_hi - lo)]
                src = [slice(s_lo - t0, s_hi - t0)]
                ok = True
                for _d, (ri, c, s) in enumerate(
                    zip(rest, self.chunks[1:], self.shape[1:])
                ):
                    a, b = ri * c, min((ri + 1) * c, s)
                    if a >= b:
                        ok = False
                        break
                    dst.append(slice(a, b))
                    src.append(slice(0, b - a))
                if ok:
                    out[tuple(dst)] = chunk[tuple(src)]
        return out


class ZarrStack(ArrayStack):
    """A Zarr v2 array store (directory). Prefers the optional ``zarr``
    package (full format coverage); falls back to the built-in reader
    for plain C-order raw/zlib/gzip stores."""

    def __init__(self, path):
        path = os.fspath(path)
        self.path = path
        try:
            import zarr  # optional

            arr = zarr.open_array(path, mode="r")
        except ImportError:
            arr = _MiniZarr(path)
        if len(arr.shape) not in (3, 4):
            raise ValueError(
                f"{path}: zarr array is {len(arr.shape)}D, need 3D/4D"
            )
        super().__init__(arr)


class ZarrWriter:
    """Incremental Zarr v2 directory-store writer with the TiffWriter
    streaming protocol: frames append one (or one batch) at a time as
    the stream comes off the device, with kill-safe checkpoint/resume.

    Layout: C-order, chunks of ONE frame ((1, *frame_shape) — the
    time-chunked layout streaming pipelines re-read), dimension
    separator ".", compression "none" or "deflate" (zlib level 6, the
    same codec/level as the TIFF deflate path). One chunk file per
    frame makes resume semantics trivial: chunks below the checkpoint
    cursor were completely written before the checkpoint saved, a torn
    tail chunk is simply overwritten when its frame is re-appended,
    and — unlike TIFF — there is no offset chain, so already-written
    bytes can never be perturbed by a resume.
    """

    def __init__(
        self,
        path,
        n_frames: int,
        frame_shape: tuple,
        dtype,
        compression: str = "none",
    ):
        if compression not in ("none", "deflate"):
            raise ValueError(
                "zarr output supports compression 'none' or 'deflate', "
                f"got {compression!r}"
            )
        self.path = os.fspath(path)
        self.compression = compression
        self.shape = (int(n_frames),) + tuple(int(s) for s in frame_shape)
        self.dtype = np.dtype(dtype)
        os.makedirs(self.path, exist_ok=True)
        # fresh construction = fresh run: drop stale chunk entries from
        # a previous (different) run so a shorter rerun can't leave a
        # mix. Nested layouts (dimension_separator "/", which the
        # READER supports) store chunks as subdirectories — remove
        # those trees too, not just flat files.
        import shutil

        for name in os.listdir(self.path):
            if name[:1].isdigit():
                p = os.path.join(self.path, name)
                if os.path.isdir(p):
                    shutil.rmtree(p)
                else:
                    os.remove(p)
        meta = {
            "zarr_format": 2,
            "shape": list(self.shape),
            "chunks": [1] + list(self.shape[1:]),
            "dtype": self.dtype.str,
            "compressor": (
                {"id": "zlib", "level": 6}
                if compression == "deflate" else None
            ),
            "fill_value": 0,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        with open(os.path.join(self.path, ".zarray"), "w") as f:
            json.dump(meta, f)
        self.n_pages = 0

    def _chunk_path(self, t: int) -> str:
        name = ".".join([str(t)] + ["0"] * (len(self.shape) - 1))
        return os.path.join(self.path, name)

    def _encode(self, frame: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(frame, self.dtype).tobytes()
        return zlib.compress(raw, 6) if self.compression == "deflate" else raw

    def append_batch(self, frames: np.ndarray, n_threads: int = 0) -> None:
        frames = np.asarray(frames)
        if tuple(frames.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"frame shape {frames.shape[1:]} != store {self.shape[1:]}"
            )
        if self.n_pages + len(frames) > self.shape[0]:
            raise ValueError(
                f"appending {len(frames)} frames past the store's "
                f"{self.shape[0]}-frame shape (at {self.n_pages})"
            )
        if n_threads > 1 and self.compression == "deflate":
            # zlib releases the GIL on large buffers; encode in parallel,
            # write in order (same thread-budget contract as TiffWriter)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_threads) as ex:
                blobs = list(ex.map(self._encode, frames))
        else:
            blobs = [self._encode(f) for f in frames]
        for blob in blobs:
            with open(self._chunk_path(self.n_pages), "wb") as f:
                f.write(blob)
            self.n_pages += 1

    def checkpoint_state(self) -> dict:
        return {
            "format": "zarr",
            "n_pages": int(self.n_pages),
            # recorded for parity with the TIFF deflate pin; zarr resume
            # never re-touches written bytes, so a zlib build change
            # only affects frames not yet written
            "zlib": zlib.ZLIB_RUNTIME_VERSION,
        }

    @classmethod
    def resume(cls, path, state: dict, compression: str = "none") -> "ZarrWriter":
        path = os.fspath(path)
        if state.get("format") != "zarr":
            raise OSError(f"{path}: checkpoint writer state is not zarr")
        try:
            with open(os.path.join(path, ".zarray")) as f:
                meta = json.load(f)
        except (ValueError, KeyError) as e:
            # torn/corrupt metadata must surface as OSError — the
            # corrector's resume handler restarts from scratch on
            # OSError, exactly like a torn TIFF
            raise OSError(
                f"{path}: unreadable .zarray at resume: {e}"
            ) from e
        self = object.__new__(cls)
        self.path = path
        self.compression = compression
        self.shape = tuple(meta["shape"])
        self.dtype = np.dtype(meta["dtype"])
        comp = meta.get("compressor")
        want = {"id": "zlib", "level": 6} if compression == "deflate" else None
        if comp != want:
            raise OSError(
                f"{path}: store compressor {comp} does not match the "
                f"resume compression {compression!r}"
            )
        try:
            n = int(state["n_pages"])
        except (KeyError, TypeError, ValueError) as e:
            raise OSError(
                f"{path}: malformed zarr writer state: {e}"
            ) from e
        # all checkpointed chunks must exist (the output is the
        # persistence layer, exactly like the TIFF resume contract)
        if n > 0 and not os.path.exists(self._chunk_path(n - 1)):
            raise OSError(f"{path}: chunk {n - 1} missing at resume")
        self.n_pages = n
        return self

    def close(self):
        pass


class HDF5Writer:
    """Incremental HDF5 writer with the TiffWriter streaming protocol.

    Kill-safety is the design constraint: HDF5's chunked layout updates
    a B-tree on every chunk write, and a SIGKILL mid-update can corrupt
    the FILE — not just the tail frame — which would break the resume
    contract (already-written frames must survive any kill). So the
    dataset is CONTIGUOUS with early allocation: all space and all
    metadata are written at creation, after which appends are pure data
    writes at fixed offsets (raw-file semantics — a torn tail frame is
    simply overwritten when re-appended; the resumed DATASET is
    bit-identical to an uninterrupted run's, though whole-file bytes
    are not — HDF5 object headers embed creation timestamps). Contiguous layout cannot
    compress; `compression="deflate"` is refused with a pointer to the
    `.zarr` egress, whose one-chunk-per-frame layout compresses AND
    keeps the same kill-safety.
    """

    dataset_name = "data"

    def __init__(
        self,
        path,
        n_frames: int,
        frame_shape: tuple,
        dtype,
        compression: str = "none",
    ):
        import h5py

        if compression != "none":
            raise ValueError(
                "HDF5 egress is uncompressed (contiguous layout is what "
                "makes kill+resume safe — chunked+gzip HDF5 can corrupt "
                "the whole file on SIGKILL); use a .zarr output for "
                "compressed kill-safe egress"
            )
        self.path = os.fspath(path)
        self.compression = compression
        self.shape = (int(n_frames),) + tuple(int(s) for s in frame_shape)
        self.dtype = np.dtype(dtype)
        self._f = h5py.File(self.path, "w")
        # contiguous + ALLOC_TIME_EARLY: the whole dataset (and every
        # byte of metadata) exists on disk before the first append
        space = h5py.h5s.create_simple(self.shape)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.CONTIGUOUS)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(
            self._f.id, self.dataset_name.encode(),
            h5py.h5t.py_create(self.dtype, logical=True), space, dcpl,
        ).close()
        self._f.flush()
        self._d = self._f[self.dataset_name]
        self.n_pages = 0

    def append_batch(self, frames: np.ndarray, n_threads: int = 0) -> None:
        del n_threads  # uncompressed: the write is I/O-bound
        frames = np.asarray(frames)
        if tuple(frames.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"frame shape {frames.shape[1:]} != dataset {self.shape[1:]}"
            )
        if self.n_pages + len(frames) > self.shape[0]:
            raise ValueError(
                f"appending {len(frames)} frames past the dataset's "
                f"{self.shape[0]}-frame shape (at {self.n_pages})"
            )
        self._d[self.n_pages : self.n_pages + len(frames)] = frames.astype(
            self.dtype, copy=False
        )
        self._f.flush()
        self.n_pages += len(frames)

    def checkpoint_state(self) -> dict:
        return {"format": "hdf5", "n_pages": int(self.n_pages)}

    @classmethod
    def resume(cls, path, state: dict, compression: str = "none") -> "HDF5Writer":
        import h5py

        path = os.fspath(path)
        if state.get("format") != "hdf5":
            raise OSError(f"{path}: checkpoint writer state is not hdf5")
        if compression != "none":
            raise OSError(
                f"{path}: HDF5 egress is uncompressed; resume asked for "
                f"{compression!r}"
            )
        self = object.__new__(cls)
        self.path = path
        self.compression = compression
        try:
            self._f = h5py.File(path, "r+")
            self._d = self._f[cls.dataset_name]
        except (OSError, KeyError) as e:
            raise OSError(
                f"{path}: unreadable HDF5 output at resume: {e}"
            ) from e
        self.shape = tuple(self._d.shape)
        self.dtype = np.dtype(self._d.dtype)
        try:
            n = int(state["n_pages"])
        except (KeyError, TypeError, ValueError) as e:
            raise OSError(
                f"{path}: malformed hdf5 writer state: {e}"
            ) from e
        if n > self.shape[0]:
            raise OSError(
                f"{path}: checkpoint cursor {n} beyond dataset "
                f"length {self.shape[0]}"
            )
        self.n_pages = n
        return self

    def close(self):
        self._f.close()


def make_writer(
    output, n_frames: int, frame_shape: tuple, dtype,
    compression: str = "none", bigtiff: bool = False,
    object_opts: dict | None = None,
):
    """Streaming-writer factory: dispatch on the output extension
    (.zarr -> ZarrWriter, .h5/.hdf5 -> HDF5Writer, object-store URLs
    -> ObjectStoreWriter, else TiffWriter). `object_opts` carries the
    object-path robustness wiring (chunk_frames/part_bytes/fault_plan/
    retry/report/client) and applies to URL outputs only."""
    from kcmc_tpu_torch.io import objectstore

    if objectstore.is_object_url(output):
        return objectstore.ObjectStoreWriter(
            output, n_frames, frame_shape, dtype,
            compression=compression, **dict(object_opts or {}),
        )
    out = os.fspath(output).lower()
    if out.endswith(".zarr"):
        return ZarrWriter(
            output, n_frames, frame_shape, dtype, compression=compression
        )
    if out.endswith((".h5", ".hdf5")):
        return HDF5Writer(
            output, n_frames, frame_shape, dtype, compression=compression
        )
    from kcmc_tpu_torch.io.tiff import TiffWriter

    return TiffWriter(output, compression=compression, bigtiff=bigtiff)


def resume_writer(
    output, state: dict, compression: str = "none",
    object_opts: dict | None = None,
):
    """Resume-side counterpart of `make_writer`."""
    from kcmc_tpu_torch.io import objectstore

    if objectstore.is_object_url(output):
        return objectstore.ObjectStoreWriter.resume(
            output, state, compression=compression, object_opts=object_opts
        )
    out = os.fspath(output).lower()
    if out.endswith(".zarr"):
        return ZarrWriter.resume(output, state, compression=compression)
    if out.endswith((".h5", ".hdf5")):
        return HDF5Writer.resume(output, state, compression=compression)
    from kcmc_tpu_torch.io.tiff import TiffWriter

    return TiffWriter.resume(output, state, compression=compression)


def open_stack(source, n_threads: int = 0, **reader_options):
    """Open any supported stack source with the streaming-reader
    protocol.

    source: a path (dispatched on extension: .tif/.tiff, .zarr
    directory, .h5/.hdf5, .npy, .raw/.bin/.dat), an object-store URL
    (``emu://...`` -> ObjectStack over the chunked bucket layout), an
    object already implementing the protocol (returned as-is), or an
    array-like (wrapped in ArrayStack). reader_options are
    format-specific (HDF5Stack's ``dataset``, RawStack's ``shape``/
    ``dtype``/``offset``).
    """
    def no_options(fmt):
        # Silently absorbing options a format doesn't take would let a
        # stale reader_options dict (e.g. an HDF5 dataset= against a
        # TIFF) "succeed" while reading something else entirely.
        if reader_options:
            raise ValueError(
                f"{fmt} sources take no reader_options, got "
                f"{sorted(reader_options)}"
            )

    if not isinstance(source, (str, os.PathLike)):
        no_options("array/reader")
        if hasattr(source, "read") and hasattr(source, "frame_shape"):
            return source  # already a protocol reader
        return ArrayStack(source)
    from kcmc_tpu_torch.io import objectstore

    if objectstore.is_object_url(source):
        no_options("object-store")
        return objectstore.ObjectStack(source, n_threads=n_threads)
    path = os.fspath(source)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        from kcmc_tpu_torch.io.tiff import TiffStack

        opts = dict(reader_options)
        force_python = bool(opts.pop("force_python", False))
        if opts:
            raise ValueError(
                f"TIFF sources take no reader_options beyond "
                f"'force_python', got {sorted(opts)}"
            )
        return TiffStack(
            path, n_threads=n_threads, force_python=force_python
        )
    if ext == ".zarr" or os.path.isdir(path) and os.path.exists(
        os.path.join(path, ".zarray")
    ):
        no_options("Zarr")
        return ZarrStack(path)
    if ext in (".h5", ".hdf5"):
        return HDF5Stack(path, **reader_options)
    if ext == ".npy":
        no_options(".npy")
        return NpyStack(path)
    if ext in (".raw", ".bin", ".dat"):
        return RawStack(path, **reader_options)
    raise ValueError(
        f"unrecognized stack format {ext!r} for {path} — supported: "
        ".tif/.tiff, .zarr, .h5/.hdf5, .npy, .raw/.bin/.dat, or pass "
        "an array / reader object"
    )
