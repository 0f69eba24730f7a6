"""The port's stack I/O (`kcmc_tpu_torch.io`) against kcmc_tpu.io, byte
for byte: TIFF writer bytes, checkpoint states and torn-tail resumes,
the native decoder and the NumPy parser on LZW, PackBits and deflate
pages, the Zarr writer's chunk files and reader, npy / raw / HDF5
readers, open_stack's dispatch and errors, the feeder's plans and
pooled chunks, and the background writer. kcmc_tpu.io imports no JAX,
so nothing here compiles."""

import json
import os
import struct

import numpy as np
import pytest

from kcmc_tpu.io import feeder as jfeeder
from kcmc_tpu.io import formats as jformats
from kcmc_tpu.io import tiff as jtiff
from kcmc_tpu_torch.io import feeder as tfeeder
from kcmc_tpu_torch.io import formats as tformats
from kcmc_tpu_torch.io import tiff as ttiff
from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
from kcmc_tpu_torch.io.reader import ChunkedStackLoader
from test_io import _lzw_encode_reference

SHAPE = (40, 56)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4000, size=(1,) + SHAPE)
    return (base + rng.integers(0, 64, size=(12,) + SHAPE)).astype(np.uint16)


def _write(mod, path, frames, compression, bigtiff, splits):
    with mod.TiffWriter(path, compression=compression, bigtiff=bigtiff) as w:
        lo = 0
        for hi in list(splits) + [len(frames)]:
            if hi > lo:
                w.append_batch(frames[lo:hi])
            lo = hi


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# TIFF writer and reader


@pytest.mark.parametrize("compression", ["none", "deflate", "packbits"])
@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("splits", [(), (1, 5), (3, 4, 11)])
def test_tiff_writer_bytes_match(tmp_path, frames, compression, bigtiff, splits):
    """The port's TiffWriter writes the reference's bytes for every
    codec, classic and BigTIFF, whatever the append_batch splits."""
    _write(jtiff, tmp_path / "j.tif", frames, compression, bigtiff, ())
    _write(ttiff, tmp_path / "t.tif", frames, compression, bigtiff, splits)
    assert _bytes(tmp_path / "t.tif") == _bytes(tmp_path / "j.tif")


@pytest.mark.parametrize("compression,bigtiff", [("none", False), ("deflate", False),
                                                 ("deflate", True)])
def test_checkpoint_state_and_torn_tail_resume(tmp_path, frames, compression, bigtiff):
    """checkpoint_state() equals the reference's; resuming after a torn
    tail page (garbage appended past the cursor) writes the bytes of an
    uninterrupted file."""
    states = []
    for mod, name in ((jtiff, "j.tif"), (ttiff, "t.tif")):
        w = mod.TiffWriter(tmp_path / name, compression=compression, bigtiff=bigtiff)
        w.append_batch(frames[:5])
        states.append(w.checkpoint_state())
        w.append_batch(frames[5:7])  # the pages a kill tears
        w._f.write(b"\x17" * 333)
        w._f.close()
    assert states[0] == states[1]
    w = ttiff.TiffWriter.resume(tmp_path / "t.tif", states[1], compression=compression)
    w.append_batch(frames[5:])
    w.close()
    _write(jtiff, tmp_path / "full.tif", frames, compression, bigtiff, ())
    assert _bytes(tmp_path / "t.tif") == _bytes(tmp_path / "full.tif")


def _lzw_tiff(path, img):
    """One 8-bit LZW page, hand-built (neither writer writes LZW)."""
    H, W = img.shape
    enc = _lzw_encode_reference(img.tobytes())
    with open(path, "wb") as f:
        f.write(b"II\x2a\x00" + struct.pack("<I", 0))
        strip_off = f.tell()
        f.write(enc + b"\0" * (len(enc) % 2))
        ifd = f.tell()
        f.seek(4)
        f.write(struct.pack("<I", ifd))
        f.seek(ifd)
        entries = [(256, 4, 1, W), (257, 4, 1, H), (258, 3, 1, 8), (259, 3, 1, 5),
                   (262, 3, 1, 1), (273, 4, 1, strip_off), (277, 3, 1, 1),
                   (278, 4, 1, H), (279, 4, 1, len(enc)), (339, 3, 1, 1)]
        f.write(struct.pack("<H", len(entries)))
        for tag, type_, count, value in entries:
            f.write(struct.pack("<HHII", tag, type_, count, value))
        f.write(struct.pack("<I", 0))


@pytest.mark.parametrize("codec", ["lzw", "packbits", "deflate"])
@pytest.mark.parametrize("force_python", [False, True])
def test_tiff_stack_reads_match(tmp_path, frames, codec, force_python):
    """TiffStack.read equals the reference's, through the native
    decoder and through the NumPy parser; `backend` names the one that
    ran."""
    path = str(tmp_path / f"{codec}.tif")
    if codec == "lzw":
        rng = np.random.default_rng(7)
        _lzw_tiff(path, rng.integers(0, 4, size=(100, 200), dtype=np.uint8))
    else:
        jtiff.write_stack(path, frames, compression=codec)
    with jtiff.TiffStack(path, force_python=True) as js:
        want = js.read(0, len(js))
    with ttiff.TiffStack(path, force_python=force_python) as ts:
        assert ts.backend == ("python" if force_python else "native")
        got = ts.read(0, len(ts))
        part = ts.read(len(ts) // 2, len(ts))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(part, want[len(want) // 2:])
    assert got.dtype == want.dtype


def test_native_build_lands_in_build_dir():
    """The native decoder builds into build/kcmc_tpu_torch/, named by a
    hash of its source (a changed source rebuilds)."""
    assert ttiff._get_native() is not None
    target = ttiff._native_target()
    assert target.parent.parts[-2:] == ("build", "kcmc_tpu_torch")
    assert target.exists() and target.name.startswith("stackio-")
    assert ttiff._deflate_encoder_id() == jtiff._deflate_encoder_id()


# ---------------------------------------------------------------------------
# Zarr, npy, raw, HDF5 and the dispatch


@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_zarr_writer_files_and_reader_match(tmp_path, frames, compression):
    """ZarrWriter's chunk files and .zarray equal the reference's, and
    both readers (ZarrStack over _MiniZarr) read the same frames."""
    for mod, name in ((jformats, "j.zarr"), (tformats, "t.zarr")):
        w = mod.ZarrWriter(str(tmp_path / name), len(frames), SHAPE, frames.dtype,
                           compression=compression)
        w.append_batch(frames[:5])
        w.append_batch(frames[5:])
        w.close()
    jfiles = sorted(os.listdir(tmp_path / "j.zarr"))
    assert jfiles == sorted(os.listdir(tmp_path / "t.zarr"))
    for f in jfiles:
        assert _bytes(tmp_path / "j.zarr" / f) == _bytes(tmp_path / "t.zarr" / f), f
    with jformats.open_stack(str(tmp_path / "j.zarr")) as js, \
            tformats.open_stack(str(tmp_path / "t.zarr")) as ts:
        assert isinstance(ts, tformats.ZarrStack)
        assert ts.frame_shape == js.frame_shape and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts.read(2, 9), js.read(2, 9))
        np.testing.assert_array_equal(ts.read(0, len(ts)), frames)


def test_npy_raw_and_array_readers(tmp_path, frames):
    np.save(tmp_path / "s.npy", frames)
    frames.tofile(tmp_path / "s.raw")
    opts = {"shape": frames.shape, "dtype": "uint16"}
    for src, kw, cls in ((str(tmp_path / "s.npy"), {}, tformats.NpyStack),
                         (str(tmp_path / "s.raw"), opts, tformats.RawStack),
                         (frames, {}, tformats.ArrayStack)):
        with tformats.open_stack(src, **kw) as ts, jformats.open_stack(src, **kw) as js:
            assert isinstance(ts, cls)
            assert (len(ts), ts.frame_shape, ts.dtype) == (len(js), js.frame_shape, js.dtype)
            np.testing.assert_array_equal(ts.read(3, 8), js.read(3, 8))


@pytest.mark.parametrize("source,kw,match", [
    ("x.czi", {}, "unrecognized stack format"),
    ("x.npy", {"dataset": "a"}, "take no reader_options"),
    ("x.tif", {"dataset": "a"}, "beyond 'force_python'"),
])
def test_open_stack_errors_match(tmp_path, source, kw, match):
    """open_stack raises the reference's errors with its messages."""
    path = str(tmp_path / source)
    errs = []
    for mod in (jformats, tformats):
        with pytest.raises(ValueError, match=match) as e:
            mod.open_stack(path, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_object_urls_name_the_roadmap_item(tmp_path):
    """Object-store URLs route to the object store, as the reference's do
    (they raised NotImplementedError naming the ROADMAP item until the
    port had one): a bucket without a manifest, a checkpoint state of
    another writer and a scheme with no registered client raise the
    reference's errors with its messages."""
    calls = [
        (lambda m: m.open_stack(f"emu://{tmp_path}/none"), FileNotFoundError),
        (lambda m: m.resume_writer("s3://b/out", {}), OSError),
        (lambda m: m.make_writer("gs://b/out", 4, SHAPE, np.uint16), ValueError),
    ]
    for call, exc in calls:
        errs = []
        for mod in (jformats, tformats):
            with pytest.raises(exc) as e:
                call(mod)
            errs.append(str(e.value).replace("kcmc_tpu_torch.", "kcmc_tpu."))
        assert errs[0] == errs[1]
    w = tformats.make_writer(f"emu://{tmp_path}/out", 4, SHAPE, np.uint16)
    assert type(w).__name__ == "ObjectStoreWriter"


def test_hdf5_reader_and_writer_match(tmp_path, frames):
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "in.h5", "w") as f:
        f.create_dataset("data", data=frames)
    with tformats.open_stack(str(tmp_path / "in.h5")) as ts, \
            jformats.open_stack(str(tmp_path / "in.h5")) as js:
        np.testing.assert_array_equal(ts.read(0, len(ts)), js.read(0, len(js)))
    states = []
    for mod, name in ((jformats, "j.h5"), (tformats, "t.h5")):
        w = mod.make_writer(str(tmp_path / name), len(frames), SHAPE, frames.dtype)
        w.append_batch(frames[:4])
        states.append(w.checkpoint_state())
        w.append_batch(frames[4:])
        w.close()
    assert states[0] == states[1]
    with h5py.File(tmp_path / "t.h5") as f, h5py.File(tmp_path / "j.h5") as g:
        key = list(g.keys())[0]
        np.testing.assert_array_equal(f[key][...], g[key][...])


# ---------------------------------------------------------------------------
# the feeder, the loader and the background writer


def test_feeder_plans_match():
    for n in (0, 1, 3):
        assert tfeeder.resolve_workers(n) == jfeeder.resolve_workers(n)
    for args in ((0, 4, 8), (0, 32, 64), (5, 4, 8), (0, 1, 256, 1)):
        assert tfeeder.derive_prefetch(*args) == jfeeder.derive_prefetch(*args)


@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_classify_and_pooled_chunks(tmp_path, frames, compression):
    """The pool flavour of a python-decoded TIFF, and a thread pool's
    ordered chunks equal the file."""
    path = str(tmp_path / "s.tif")
    jtiff.write_stack(path, frames, compression=compression)
    with ttiff.TiffStack(path, force_python=True) as ts, \
            jtiff.TiffStack(path, force_python=True) as js:
        assert tfeeder.classify_source(ts) == jfeeder.classify_source(js)
        spec = tfeeder.source_spec(ts, path, None)
        assert spec == jfeeder.source_spec(js, path, None)
    pool = tfeeder.DecodePool(2, kind="thread")
    try:
        stats = {}
        got = list(tfeeder.pooled_chunks(pool, spec, 1, 12, 4, 2, stats=stats))
    finally:
        pool.shutdown()
    assert [(lo, hi) for lo, hi, _ in got] == [(1, 5), (5, 9), (9, 12)]
    np.testing.assert_array_equal(np.concatenate([c for _, _, c in got]), frames[1:])
    assert stats["chunks"] == 3 and stats["frames"] == 11


def test_loader_prefetch_and_retry(tmp_path, frames):
    """The prefetch thread's chunks equal the source's; an injected
    transient read fault is retried and counted."""
    from kcmc_tpu_torch.utils.faults import FaultPlan, RetryPolicy
    from kcmc_tpu_torch.utils.metrics import RobustnessReport

    report = RobustnessReport()
    loader = ChunkedStackLoader(
        frames, chunk_size=5, start=2, prefetch=2,
        fault_plan=FaultPlan.from_spec("io_read:step=1:transient"),
        retry=RetryPolicy(backoff_s=1e-4, backoff_max_s=2e-4), report=report,
    )
    got = list(loader)
    assert [(lo, hi) for lo, hi, _ in got] == [(2, 7), (7, 12)]
    np.testing.assert_array_equal(np.concatenate([c for _, _, c in got]), frames[2:])
    assert report.io_retries == 1


def test_async_writer_bytes_and_checkpoint(tmp_path, frames):
    """Behind the background writer the file has the synchronous
    writer's bytes, and checkpoint_state flushes first."""
    w = AsyncBatchWriter(ttiff.TiffWriter(tmp_path / "a.tif"), depth=2)
    for lo in range(0, len(frames), 3):
        w.append_batch(frames[lo:lo + 3])
    state = w.checkpoint_state()
    assert state["n_pages"] == len(frames)
    w.close()
    assert w.stats()["batches"] == 4
    _write(jtiff, tmp_path / "s.tif", frames, "none", False, ())
    assert _bytes(tmp_path / "a.tif") == _bytes(tmp_path / "s.tif")
    assert json.loads(json.dumps(state)) == state
