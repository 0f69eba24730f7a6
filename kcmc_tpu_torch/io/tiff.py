"""Multi-page TIFF stack I/O: native threaded decoder + NumPy fallback
(the port's copy of kcmc_tpu/io/tiff.py).

Microscopy motion-correction stacks arrive as multi-page grayscale TIFF
(often LZW/Deflate-compressed). Decoding is the host-side bottleneck the
card's pipeline streams from, so it is implemented natively
(kcmc_tpu_torch/native/stackio.cpp): IFD tables are parsed once, then
page ranges decode in parallel with a thread pool straight into a NumPy
buffer. The native library is built on first use with the system g++
(no Python build deps; ctypes ABI) into `build/kcmc_tpu_torch/` at the
root of the checkout, named by a hash of its source; when a toolchain is
unavailable the pure-NumPy fallback below implements the same format
subset (and doubles as the correctness oracle in tests).
`TiffStack.backend` says which decoder ran.

Supported subset (both paths): classic + BigTIFF, II/MM byte order,
single-sample grayscale, stripped layout, compression none / LZW /
Deflate / PackBits, 8/16/32-bit integer and 32/64-bit float samples.

Writing (`write_stack`) emits classic little-endian multi-page TIFF,
optionally Deflate- or PackBits-compressed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_DTYPES = {
    0: np.dtype(np.uint8),
    1: np.dtype(np.uint16),
    2: np.dtype(np.uint32),
    3: np.dtype(np.int8),
    4: np.dtype(np.int16),
    5: np.dtype(np.int32),
    6: np.dtype(np.float32),
    7: np.dtype(np.float64),
}

_NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "stackio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kcmc_tpu_torch"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-lz", "-pthread")
_native_lock = threading.Lock()
_native_lib = None
_native_failed = False


class _StackInfo(ctypes.Structure):
    _fields_ = [
        ("n_pages", ctypes.c_uint64),
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("dtype", ctypes.c_int32),
    ]


def _native_target() -> Path:
    """The built library's path in `build/kcmc_tpu_torch/`, named by a
    hash of the source and the flags, so a changed source rebuilds (as
    the CUDA kernels' build cache does)."""
    h = hashlib.sha256(
        _NATIVE_SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"stackio-{h}.so"


def _build_native() -> ctypes.CDLL | None:
    """Compile and load the native decoder; None if no toolchain."""
    try:
        so_path = _native_target()
    except OSError:  # source not shipped: degrade to the NumPy decoder
        return None
    if not so_path.exists():
        # compile beside the target, then rename: concurrent builders
        # (several test workers) never load a half-written library
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_GXX_FLAGS[:4], str(_NATIVE_SRC), "-o", str(tmp),
               *_GXX_FLAGS[4:]]
        try:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.kcmc_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(_StackInfo),
    ]
    lib.kcmc_open.restype = ctypes.c_int
    lib.kcmc_read_pages.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.kcmc_read_pages.restype = ctypes.c_int
    lib.kcmc_last_error.argtypes = [ctypes.c_void_p]
    lib.kcmc_last_error.restype = ctypes.c_char_p
    lib.kcmc_close.argtypes = [ctypes.c_void_p]
    lib.kcmc_close.restype = None
    try:  # encoder exports (absent in a stale cached .so: decode-only)
        lib.kcmc_deflate_bound.argtypes = [ctypes.c_uint64]
        lib.kcmc_deflate_bound.restype = ctypes.c_uint64
        lib.kcmc_deflate_pages.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ]
        lib.kcmc_deflate_pages.restype = ctypes.c_int
        lib.kcmc_zlib_version.argtypes = []
        lib.kcmc_zlib_version.restype = ctypes.c_char_p
    except AttributeError:
        pass
    return lib


def _deflate_encoder_id(pin_python: bool = False) -> str:
    """Identity of the zlib build(s) a deflate stream will be written
    with: recorded in resume checkpoints, because byte-identical resume
    holds only when the resumed run compresses through the same encoder
    (zlib output is deterministic per build+level, but zlib-ng or a
    version skew produces valid-yet-different bytes)."""
    py = f"py:{zlib.ZLIB_RUNTIME_VERSION}"
    if pin_python:
        return py
    lib = _get_native()
    if lib is not None and hasattr(lib, "kcmc_deflate_pages"):
        ver = (
            lib.kcmc_zlib_version().decode()
            if hasattr(lib, "kcmc_zlib_version")
            else "?"
        )
        return f"{py}+native:{ver}"
    return py


def _get_native():
    global _native_lib, _native_failed
    with _native_lock:
        if _native_lib is None and not _native_failed:
            _native_lib = _build_native()
            _native_failed = _native_lib is None
    return _native_lib


# ---------------------------------------------------------------------------
# pure-NumPy fallback parser (same subset; also the test oracle)
# ---------------------------------------------------------------------------

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _lzw_decode_py(data: bytes, expected: int) -> bytes:
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, next_code = 9, 258
    prev: bytes | None = None
    bitbuf, bits = 0, 0
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bits += 8
        while bits >= width:
            code = (bitbuf >> (bits - width)) & ((1 << width) - 1)
            bits -= width
            if code == 256:
                table = table[:258]
                width, next_code, prev = 9, 258, None
                continue
            if code == 257:
                return bytes(out[:expected])
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
                next_code += 1
            else:
                entry = prev + prev[:1]
                table.append(entry)
                next_code += 1
            out += entry
            prev = entry
            if next_code >= 2047:
                width = 12
            elif next_code >= 1023:
                width = 11
            elif next_code >= 511:
                width = 10
            if len(out) >= expected:
                return bytes(out[:expected])
    return bytes(out[:expected])


def _packbits_decode_py(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i : i + c + 1]
            i += c + 1
        elif c != 128:
            out += bytes([data[i]]) * (257 - c)
            i += 1
    return bytes(out[:expected])


class _PyTiffParser:
    """Minimal classic/BigTIFF IFD walker for the supported subset."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        hdr = self.f.read(4)
        if hdr[:2] == b"II":
            self.en = "<"
        elif hdr[:2] == b"MM":
            self.en = ">"
        else:
            raise ValueError(f"{path}: not a TIFF")
        magic = struct.unpack(self.en + "H", hdr[2:4])[0]
        if magic == 42:
            self.big = False
            (off,) = struct.unpack(self.en + "I", self.f.read(4))
        elif magic == 43:
            self.big = True
            osz, _ = struct.unpack(self.en + "HH", self.f.read(4))
            if osz != 8:
                raise ValueError("bad BigTIFF header")
            (off,) = struct.unpack(self.en + "Q", self.f.read(8))
        else:
            raise ValueError("bad TIFF magic")
        self.pages = []
        self.meta = None
        while off:
            off = self._read_ifd(off)

    def _values(self, type_, count, raw):
        tsz = _TYPE_SIZE.get(type_)
        if tsz is None:
            return None
        total = tsz * count
        field = 8 if self.big else 4
        if total <= field:
            buf = raw[:total]
        else:
            fmt = self.en + ("Q" if self.big else "I")
            (ptr,) = struct.unpack(fmt, raw)
            keep = self.f.tell()
            self.f.seek(ptr)
            buf = self.f.read(total)
            self.f.seek(keep)
        code = {1: "B", 2: "b", 3: "H", 4: "I", 5: "Q", 6: "b", 7: "B",
                8: "h", 9: "i", 16: "Q", 17: "q", 18: "Q"}.get(type_)
        if code is None:
            if type_ in (11, 12):
                code = "f" if type_ == 11 else "d"
            else:
                return None
        vals = struct.unpack(self.en + code * count, buf[: tsz * count])
        return list(vals)

    def _read_ifd(self, off):
        f = self.f
        f.seek(off)
        if self.big:
            (n,) = struct.unpack(self.en + "Q", f.read(8))
            esz = 20
        else:
            (n,) = struct.unpack(self.en + "H", f.read(2))
            esz = 12
        tags = {}
        base = f.tell()
        for i in range(n):
            f.seek(base + i * esz)
            tag, type_ = struct.unpack(self.en + "HH", f.read(4))
            if self.big:
                (count,) = struct.unpack(self.en + "Q", f.read(8))
                raw = f.read(8)
            else:
                (count,) = struct.unpack(self.en + "I", f.read(4))
                raw = f.read(4)
            vals = self._values(type_, count, raw)
            if vals is not None:
                tags[tag] = vals
        f.seek(base + n * esz)
        (nxt,) = struct.unpack(
            self.en + ("Q" if self.big else "I"),
            f.read(8 if self.big else 4),
        )

        if any(t in tags for t in (322, 323, 324, 325)):
            raise ValueError("tiled TIFF not supported")
        width = tags[256][0]
        height = tags[257][0]
        bits = tags.get(258, [8])[0]
        comp = tags.get(259, [1])[0]
        spp = tags.get(277, [1])[0]
        fmt = tags.get(339, [1])[0]
        if spp != 1:
            raise ValueError("only single-sample (grayscale) TIFF supported")
        if comp not in (1, 5, 8, 32946, 32773):
            raise ValueError(f"unsupported compression {comp}")
        offsets = tags[273]
        counts = tags[279]
        rps = tags.get(278, [height])[0] or height
        meta = (width, height, bits, comp, fmt)
        if self.meta is None:
            self.meta = meta
        elif meta != self.meta:
            raise ValueError("non-uniform pages")
        strips = []
        rows_left = height
        for o, c in zip(offsets, counts):
            rows = min(rps, rows_left)
            rows_left -= rows
            strips.append((o, c, rows))
        self.pages.append(strips)
        return nxt

    @property
    def dtype(self) -> np.dtype:
        _, _, bits, _, fmt = self.meta
        if fmt == 3:
            base = {32: np.float32, 64: np.float64}[bits]
        elif fmt == 2:
            base = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
        else:
            base = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
        return np.dtype(base).newbyteorder(self.en)

    def read_page(self, idx: int) -> np.ndarray:
        width, height, bits, comp, _ = self.meta
        row_bytes = width * (bits // 8)
        chunks = []
        for off, cnt, rows in self.pages[idx]:
            self.f.seek(off)
            data = self.f.read(cnt)
            want = row_bytes * rows
            if comp == 1:
                raw = data[:want]
            elif comp == 5:
                raw = _lzw_decode_py(data, want)
            elif comp in (8, 32946):
                raw = zlib.decompress(data)[:want]
            else:
                raw = _packbits_decode_py(data, want)
            if len(raw) < want:
                raw = raw + b"\0" * (want - len(raw))
            chunks.append(raw)
        buf = b"".join(chunks)
        arr = np.frombuffer(buf, dtype=self.dtype, count=width * height)
        return arr.reshape(height, width).astype(self.dtype.newbyteorder("="))

    def close(self):
        self.f.close()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class TiffStack:
    """A multi-page TIFF opened for random page-range access.

    Uses the native threaded decoder when available; NumPy fallback
    otherwise. Context-manager friendly.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        n_threads: int = 0,
        force_python: bool = False,
    ):
        # force_python (also the KCMC_FORCE_PY_TIFF env var) pins the
        # pure-NumPy decoder: decode-pool workers (io/feeder.py) respec
        # python-path sources with it so no worker races to build — or
        # silently switches to — the native library mid-run, and tests/
        # benchmarks use it to measure the GIL-bound fallback
        # deterministically on toolchain-equipped hosts.
        self.path = os.fspath(path)
        self.n_threads = n_threads
        self._handle = None
        self._py = None
        env = os.environ.get("KCMC_FORCE_PY_TIFF", "").strip().lower()
        if force_python or env not in ("", "0", "false", "no"):
            lib = None
        else:
            lib = _get_native()
        if lib is not None:
            handle = ctypes.c_void_p()
            info = _StackInfo()
            rc = lib.kcmc_open(
                self.path.encode(), ctypes.byref(handle), ctypes.byref(info)
            )
            if rc == 0:
                self._lib = lib
                self._handle = handle
                self.n_frames = int(info.n_pages)
                self.frame_shape = (int(info.height), int(info.width))
                self.dtype = _DTYPES[int(info.dtype)]
                return
            err = lib.kcmc_last_error(handle).decode()
            lib.kcmc_close(handle)
            # Fall through to the Python parser for a consistent error
            # message — or success, if only the native path is limited.
            self._native_error = err
        self._py = _PyTiffParser(self.path)
        self.n_frames = len(self._py.pages)
        self.frame_shape = (self._py.meta[1], self._py.meta[0])
        self.dtype = self._py.dtype.newbyteorder("=")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.n_frames,) + self.frame_shape

    def read(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """Decode pages [lo, hi) into a (n, H, W) array."""
        hi = self.n_frames if hi is None else min(hi, self.n_frames)
        if not 0 <= lo <= hi:
            raise IndexError(f"page range [{lo}, {hi})")
        n = hi - lo
        out = np.empty((n,) + self.frame_shape, self.dtype)
        if self._handle is not None:
            rc = self._lib.kcmc_read_pages(
                self._handle, lo, hi,
                out.ctypes.data_as(ctypes.c_void_p), self.n_threads,
            )
            if rc != 0:
                raise IOError(
                    f"{self.path}: "
                    f"{self._lib.kcmc_last_error(self._handle).decode()}"
                )
        else:
            for i in range(n):
                out[i] = self._py.read_page(lo + i)
        return out

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.n_frames)
            arr = self.read(lo, hi)
            return arr[::step] if step != 1 else arr
        if idx < 0:
            idx += self.n_frames
        return self.read(idx, idx + 1)[0]

    def close(self):
        if self._handle is not None:
            self._lib.kcmc_close(self._handle)
            self._handle = None
        if self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def backend(self) -> str:
        return "native" if self._handle is not None else "python"

    @property
    def compression(self) -> int | None:
        """TIFF compression tag of the stack's pages (1 = none, 5 =
        LZW, 8/32946 = deflate, 32773 = packbits), or None when only
        the native decoder parsed the file (it does not surface the
        tag). The feeder uses this to route GIL-bound pure-Python
        codecs through the process pool."""
        if self._py is not None:
            return int(self._py.meta[3])
        return None


def read_stack(path: str | os.PathLike, lo: int = 0, hi: int | None = None,
               n_threads: int = 0) -> np.ndarray:
    """Read a (T, H, W) stack from a multi-page TIFF."""
    with TiffStack(path, n_threads=n_threads) as ts:
        return ts.read(lo, hi)


_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}
_COMP_CODES = {"none": 1, "deflate": 8, "packbits": 32773}


def _packbits_encode(row: bytes) -> bytes:
    # Literal-only PackBits (valid, if not maximally compact).
    out = bytearray()
    i = 0
    while i < len(row):
        n = min(128, len(row) - i)
        out.append(n - 1)
        out += row[i : i + n]
        i += n
    return bytes(out)


class TiffWriter:
    """Incremental little-endian multi-page TIFF writer (classic or BigTIFF).

    Pages append one at a time (streaming pipelines write corrected
    frames as they come off the device); all pages must share shape and
    dtype. compression: "none" | "deflate" | "packbits".

    `bigtiff=True` writes 64-bit-offset BigTIFF — required for stacks
    past the classic format's 4 GiB offset ceiling (a 512x512x10k-frame
    uint16 stack is 5 GB); both this module's reader and the native C++
    decoder read it back.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        compression: str = "none",
        bigtiff: bool = False,
    ):
        if compression not in _COMP_CODES:
            raise ValueError(f"compression must be one of {sorted(_COMP_CODES)}")
        self.compression = compression
        self.bigtiff = bool(bigtiff)
        self._f = open(path, "wb")
        if self.bigtiff:
            # BigTIFF header: II, 43, offset size 8, pad 0, first-IFD u64
            self._f.write(b"II\x2b\x00" + struct.pack("<HH", 8, 0))
            self._f.write(struct.pack("<Q", 0))
            self._ifd_ptr_pos = 8
        else:
            self._f.write(b"II\x2a\x00")
            self._f.write(struct.pack("<I", 0))  # first-IFD offset patched later
            self._ifd_ptr_pos = 4
        self._meta = None  # (H, W, dtype)
        self.n_pages = 0
        # Set by resume() when the checkpointed stream was written by
        # the Python zlib path: keeps the resumed bytes identical even
        # if the native parallel encoder has become available since.
        self._pin_python_deflate = False

    # struct formats per flavor: next-IFD pointer, entry-count, entry
    @property
    def _ptr_fmt(self):
        return "<Q" if self.bigtiff else "<I"

    def _check_frame(self, frame: np.ndarray) -> np.ndarray:
        frame = np.ascontiguousarray(frame)
        if frame.ndim != 2:
            raise ValueError(f"frame must be 2D, got {frame.shape}")
        dt = frame.dtype
        if dt.kind not in _SAMPLE_FORMAT or dt.itemsize not in (1, 2, 4, 8):
            raise ValueError(f"unsupported dtype {dt}")
        meta = (frame.shape[0], frame.shape[1], dt)
        if self._meta is None:
            self._meta = meta
        elif meta != self._meta:
            raise ValueError(f"page {meta} != first page {self._meta}")
        return frame

    def append(self, frame: np.ndarray) -> None:
        frame = self._check_frame(frame)
        raw = frame.astype(frame.dtype.newbyteorder("<"), copy=False).tobytes()
        if self.compression == "deflate":
            data = zlib.compress(raw, 6)
        elif self.compression == "packbits":
            data = _packbits_encode(raw)
        else:
            data = raw
        self._write_page(frame.shape[0], frame.shape[1], frame.dtype, data)

    def append_batch(self, frames: np.ndarray, n_threads: int = 0) -> None:
        """Append a (T, H, W) batch of pages.

        With deflate compression and the native library available, the
        pages compress in parallel through `kcmc_deflate_pages` —
        bitwise-identical to the per-page Python path ONLY when both
        link the same zlib build (checkpoints record the encoder id and
        resume() pins/warns on mismatch; see _deflate_encoder_id);
        otherwise this is a plain per-page loop. The streaming drain
        hands whole batches here, keeping compressed streaming off the
        single-thread zlib ceiling.
        """
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"batch must be (T, H, W), got {frames.shape}")
        if (
            self.compression == "deflate"
            and len(frames) > 1
            and not self._pin_python_deflate
        ):
            lib = _get_native()
            if lib is not None and hasattr(lib, "kcmc_deflate_pages"):
                first = self._check_frame(frames[0])
                le = np.ascontiguousarray(
                    frames.astype(first.dtype.newbyteorder("<"), copy=False)
                )
                n = len(le)
                page_bytes = le[0].nbytes
                bound = int(lib.kcmc_deflate_bound(page_bytes))
                buf = ctypes.create_string_buffer(bound * n)
                sizes = (ctypes.c_uint64 * n)()
                rc = lib.kcmc_deflate_pages(
                    le.ctypes.data_as(ctypes.c_void_p), n, page_bytes, 6,
                    buf, bound, sizes, n_threads,
                )
                if rc == 0:
                    H, W = le.shape[1:]
                    mv = memoryview(buf)
                    for i in range(n):
                        self._write_page(
                            H, W, first.dtype,
                            bytes(mv[i * bound : i * bound + int(sizes[i])]),
                        )
                    return
                # encoder failure: fall through to the Python path
        for fr in frames:
            self.append(fr)

    def _write_page(self, H: int, W: int, dt: np.dtype, data: bytes) -> None:
        f = self._f
        strip_off = f.tell()
        # Classic TIFF carries 32-bit offsets; refuse to stream past them
        # with a clear error instead of corrupting the file mid-write.
        if not self.bigtiff and strip_off + len(data) + 256 >= 2**32:
            raise ValueError(
                "classic TIFF output would exceed 4 GiB; pass bigtiff=True "
                "(64-bit offsets), write compressed (compression='deflate'), "
                "or split the stack across files"
            )
        f.write(data)
        if f.tell() % 2:
            f.write(b"\0")  # word-align the IFD
        ifd_off = f.tell()
        # patch previous next-IFD (or the header's first-IFD) pointer
        f.seek(self._ifd_ptr_pos)
        f.write(struct.pack(self._ptr_fmt, ifd_off))
        f.seek(ifd_off)

        entries = [
            (256, 4, 1, W),                            # ImageWidth
            (257, 4, 1, H),                            # ImageLength
            (258, 3, 1, dt.itemsize * 8),              # BitsPerSample
            (259, 3, 1, _COMP_CODES[self.compression]),
            (262, 3, 1, 1),                            # Photometric: BlackIsZero
            (273, 16 if self.bigtiff else 4, 1, strip_off),  # StripOffsets
            (277, 3, 1, 1),                            # SamplesPerPixel
            (278, 4, 1, H),                            # RowsPerStrip
            (279, 4, 1, len(data)),                    # StripByteCounts
            (339, 3, 1, _SAMPLE_FORMAT[dt.kind]),      # SampleFormat
        ]
        if self.bigtiff:
            f.write(struct.pack("<Q", len(entries)))
            for tag, type_, count, value in entries:
                f.write(struct.pack("<HHQQ", tag, type_, count, value))
        else:
            f.write(struct.pack("<H", len(entries)))
            for tag, type_, count, value in entries:
                f.write(struct.pack("<HHII", tag, type_, count, value))
        self._ifd_ptr_pos = f.tell()
        f.write(struct.pack(self._ptr_fmt, 0))  # next IFD (patched on next append)
        self.n_pages += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- checkpoint/resume (streaming-resume support, corrector.py) --------

    def checkpoint_state(self) -> dict:
        """Flush and capture the writer's exact append cursor.

        The returned dict, stored in a resume checkpoint, lets
        `TiffWriter.resume` reopen the file mid-stream and continue
        producing a byte-identical TIFF: file size, the position of the
        open next-IFD pointer, page count, and page metadata.
        """
        self._f.flush()
        state = {
            "file_size": self._f.tell(),
            "ifd_ptr_pos": self._ifd_ptr_pos,
            "n_pages": self.n_pages,
            "bigtiff": self.bigtiff,
            "meta": None
            if self._meta is None
            else [self._meta[0], self._meta[1], self._meta[2].str],
        }
        if self.compression == "deflate":
            state["encoder"] = _deflate_encoder_id(self._pin_python_deflate)
        return state

    @classmethod
    def resume(cls, path, state: dict, compression: str = "none") -> "TiffWriter":
        """Reopen a partially-written TIFF at a checkpointed state.

        Truncates anything appended after the checkpoint (a kill can
        leave a torn page) and re-zeros the last completed page's
        next-IFD pointer, restoring the byte-exact writer state, so the
        resumed stream is indistinguishable from an uninterrupted one.

        For deflate streams the checkpoint records which zlib build(s)
        wrote the file; when the recorded encoder was the Python path,
        the resumed writer pins itself to it (so a native encoder that
        appeared since cannot change the bytes), and when the recorded
        encoder is no longer reproducible (zlib version skew) a warning
        downgrades the guarantee to pixel-identical for this resume.
        """
        if compression not in _COMP_CODES:
            raise ValueError(f"compression must be one of {sorted(_COMP_CODES)}")
        # A file SHORTER than the checkpoint (replaced/partial copy)
        # must not be zero-extended by truncate() into silent garbage
        # pages — fail so the caller restarts from scratch.
        if os.path.getsize(path) < int(state["file_size"]):
            raise OSError(
                f"{path}: shorter than the checkpointed cursor "
                f"({os.path.getsize(path)} < {state['file_size']} bytes)"
            )
        w = cls.__new__(cls)
        w.compression = compression
        w.bigtiff = bool(state.get("bigtiff", False))
        w._f = open(path, "r+b")
        # ...and an unrelated file that happens to be big enough must
        # not be truncated into a corrupt TIFF: the header must match
        # the checkpointed flavor before any destructive write.
        magic = w._f.read(4)
        want = b"II\x2b\x00" if w.bigtiff else b"II\x2a\x00"
        if magic != want:
            w._f.close()
            raise OSError(
                f"{path}: header {magic!r} does not match the "
                f"checkpointed output ({want!r}) — not resuming"
            )
        w._f.truncate(state["file_size"])
        w._ifd_ptr_pos = int(state["ifd_ptr_pos"])
        # a torn append may have patched the open next-IFD pointer
        w._f.seek(w._ifd_ptr_pos)
        w._f.write(struct.pack(w._ptr_fmt, 0))
        w._f.seek(int(state["file_size"]))
        meta = state.get("meta")
        w._meta = (
            None
            if meta is None
            else (int(meta[0]), int(meta[1]), np.dtype(meta[2]))
        )
        w.n_pages = int(state["n_pages"])
        w._pin_python_deflate = False
        if compression == "deflate":
            recorded = state.get("encoder")
            if recorded == _deflate_encoder_id(pin_python=True):
                # Stream written by Python zlib only: pin the resumed
                # writer to it so the bytes stay identical even if the
                # native encoder is available now.
                w._pin_python_deflate = True
            elif recorded is not None and recorded != _deflate_encoder_id():
                from kcmc_tpu_torch.obs.log import advise

                advise(
                    f"kcmc: resume checkpoint was written by deflate "
                    f"encoder {recorded!r} but this run would use "
                    f"{_deflate_encoder_id()!r}; the resumed file will "
                    "be pixel-identical but may not be byte-identical "
                    "to an uninterrupted run",
                    stacklevel=2,
                )
        return w


def write_stack(
    path: str | os.PathLike,
    stack: np.ndarray,
    compression: str = "none",
    bigtiff: bool = False,
) -> None:
    """Write a (T, H, W) array as little-endian multi-page TIFF
    (classic, or BigTIFF with `bigtiff=True` for >4 GiB stacks)."""
    stack = np.asarray(stack)
    if stack.ndim == 2:
        stack = stack[None]
    if stack.ndim != 3:
        raise ValueError(f"stack must be (T, H, W), got {stack.shape}")
    with TiffWriter(path, compression=compression, bigtiff=bigtiff) as w:
        for frame in stack:
            w.append(frame)
