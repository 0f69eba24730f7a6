"""The port's frame-axis mesh (parallel/) on the CPU's virtual shards,
against kcmc_tpu's on its 8-device virtual XLA mesh.

The pad and ring functions equal the reference's exactly; a sharded
run matches the single-device run (integer outputs equal, transforms
and frames within 1e-4) for translation, piecewise and rigid3d; the
port's mesh_devices=8 run (uneven batch, K padded) matches the
reference's (one JAX run); the `mesh_devices` / KCMC_DEVICES surface
fails as the reference's does; a checkpoint resumes across mesh shapes;
and two gloo processes, each feeding its host-local frames and its
rows of the reference, match the single-device run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.parallel import sharded as jsharded
from kcmc_tpu_torch.io import feeder
from kcmc_tpu_torch.parallel import make_mesh, resolve_mesh
from kcmc_tpu_torch.parallel import sharded as tsharded
from kcmc_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (96, 96)
TOL = 1e-4  # the reference's bound on sharded runs (tests/test_multichip_cpu.py)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic.make_drift_stack(n_frames=14, shape=SHAPE, model="translation",
                                      max_drift=4.0, seed=3)


def mk(**kw):
    return kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=6, max_keypoints=100, **kw)


def _close(a, b, keys=("n_keypoints", "n_matches", "n_inliers", "warp_ok")):
    for k in keys:
        np.testing.assert_array_equal(a.diagnostics[k], b.diagnostics[k])
    if a.transforms is not None:
        assert np.abs(a.transforms - b.transforms).max() <= TOL
    else:
        assert np.abs(a.fields - b.fields).max() <= TOL
    assert np.abs(a.corrected - b.corrected).max() <= TOL


# -- the pieces against the reference's ---------------------------------


@pytest.mark.parametrize("B", [6, 8, 13])
def test_pad_batch_to_mesh_equals_reference(B):
    rng = np.random.default_rng(B)
    frames = rng.random((B, 5, 7), dtype=np.float32)
    idx = np.arange(100, 100 + B, dtype=np.int64)
    jf, ji, jB = jsharded.pad_batch_to_mesh(frames, idx, 8)
    tf, ti, tB = tsharded.pad_batch_to_mesh(torch.as_tensor(frames), torch.as_tensor(idx), 8)
    assert tB == jB == B
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    nf, ni, _ = tsharded.pad_batch_to_mesh(frames, idx, 8)  # numpy stays numpy
    np.testing.assert_array_equal(nf, np.asarray(jf))
    np.testing.assert_array_equal(ni, np.asarray(ji))


@pytest.mark.parametrize("K", [100, 104, 7])
def test_pad_reference_to_mesh_equals_reference(K):
    rng = np.random.default_rng(K)
    ref = {"xy": rng.random((K, 2), dtype=np.float32),
           "desc": rng.integers(0, 2**31, (K, 8)).astype(np.int64),
           "valid": rng.random(K) > 0.3, "frame": np.zeros((4, 4), np.float32)}
    want = jsharded.pad_reference_to_mesh(ref, 8)
    got = tsharded.pad_reference_to_mesh({k: torch.as_tensor(v) for k, v in ref.items()}, 8)
    for k in ("xy", "desc", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["frame"] is not None and int(got["xy"].shape[0]) % 8 == 0


def test_ring_all_gather_equals_reference_ring():
    """The port's ring over 8 virtual shards gives every shard what the
    reference's ppermute ring gives on its 8-device mesh (the monolithic
    tiled gather), for uniform, uneven and clamped chunk counts."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]), ("i",))
    x = np.arange(8 * 6 * 3, dtype=np.float32).reshape(48, 3)
    shards = list(torch.as_tensor(x).split(6))
    for chunks in (1, 4, 64):
        f = jax.jit(jsharded.shard_map(
            lambda v, c=chunks: jsharded.ring_all_gather(v, "i", 8, c),
            mesh=mesh, in_specs=(P("i"),), out_specs=P()))
        want = np.asarray(f(x))
        got = tsharded.ring_all_gather(shards, chunks)
        assert len(got) == 8
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
        mono = tsharded.gather_reference(torch.as_tensor(x), make_mesh(8, device="cpu"))
        for g in mono:
            np.testing.assert_array_equal(g.numpy(), want)


def test_host_local_range_equals_reference():
    from kcmc_tpu.io.feeder import host_local_range as ref_range

    for n in (0, 1, 7, 8, 13, 1000):
        for count in (1, 2, 3, 8):
            for i in range(count):
                assert feeder.host_local_range(n, i, count) == ref_range(n, i, count)
    assert feeder.host_local_range(10) == (0, 10)  # no process group
    with pytest.raises(ValueError, match="out of range"):
        feeder.host_local_range(10, 2, 2)


# -- the config / environment surface ----------------------------------


def test_mesh_devices_config_resolves():
    assert mk(mesh_devices=8).backend.mesh == (torch.device("cpu"),) * 8
    assert len(mk(mesh_devices=-1).backend.mesh) == 8  # every virtual shard
    assert mk().backend.mesh is None
    mesh = (torch.device("cpu"),) * 3
    assert mk(mesh=mesh).backend.mesh == mesh


def test_kcmc_devices_env_resolves(monkeypatch):
    monkeypatch.setenv("KCMC_DEVICES", "4")
    assert len(mk().backend.mesh) == 4
    assert len(mk(mesh_devices=2).backend.mesh) == 2  # the config wins
    monkeypatch.setenv("KCMC_DEVICES", "all")
    assert len(mk().backend.mesh) == 8
    monkeypatch.setenv("KCMC_DEVICES", "0")
    assert mk().backend.mesh is None


def test_mesh_devices_validation_matches_reference():
    errs = []
    for cls in (kcmc_tpu.CorrectorConfig, kcmc_tpu_torch.CorrectorConfig):
        with pytest.raises(ValueError, match="mesh_devices") as e:
            cls(mesh_devices=-2)
        errs.append(str(e.value))
        with pytest.raises(ValueError, match="collective_chunks") as e:
            cls(collective_chunks=-1)
        errs.append(str(e.value))
    assert errs[:2] == errs[2:]
    with pytest.raises(ValueError, match="devices"):
        mk(mesh_devices=9)  # more than the 8 virtual shards: at construction


def test_kcmc_devices_env_failures_name_the_var(monkeypatch):
    monkeypatch.setenv("KCMC_DEVICES", "eight")
    with pytest.raises(ValueError, match="KCMC_DEVICES"):
        mk()
    monkeypatch.setenv("KCMC_DEVICES", "9")
    with pytest.raises(ValueError, match="KCMC_DEVICES"):
        mk()
    monkeypatch.delenv("KCMC_DEVICES")
    with pytest.raises(ValueError) as e:
        mk(mesh_devices=9)
    assert "KCMC_DEVICES" not in str(e.value)


def test_card_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_mesh(1, device="cuda")


def test_mesh_shape_is_in_the_plan_stamps(tmp_path):
    kw = dict(plan_buckets=(96,), compile_cache_dir=str(tmp_path))
    one = mk(**kw).backend._plan
    two = mk(mesh_devices=2, **kw).backend._plan
    assert one.mesh_shape is None and two.mesh_shape == (2,)
    assert (one.program_stamp_key("register", (96, 96), "float32")
            != two.program_stamp_key("register", (96, 96), "float32"))


# -- sharded execution --------------------------------------------------


@pytest.fixture(scope="module")
def single(data):
    return mk().correct(data.stack)


@pytest.mark.parametrize("kw", [{"mesh_devices": 4}, {"mesh_devices": 2, "collective_chunks": 3}],
                         ids=["mono4", "ring2"])
def test_sharded_translation_matches_single_device(data, single, kw):
    """14 frames in batches of 6 (a 2-frame tail), K=100: the sharded
    runs match the single-device run."""
    got = mk(**kw).correct(data.stack)
    _close(got, single)


def test_sharded_uneven_tail_and_k_padding_match_reference(data, single):
    """mesh_devices=8 with batch 6 and K=100 (both padded to the mesh)
    against the single-device run and kcmc_tpu's own 8-device run."""
    got = mk(mesh_devices=8).correct(data.stack)
    _close(got, single)
    want = kcmc_tpu.MotionCorrector(model="translation", backend="jax", batch_size=6,
                                    max_keypoints=100, mesh_devices=8).correct(data.stack)
    assert np.abs(got.transforms - want.transforms).max() < 1e-3
    np.testing.assert_array_equal(got.diagnostics["n_keypoints"],
                                  np.asarray(want.diagnostics["n_keypoints"]))


def test_sharded_piecewise_matches_single_device():
    p = synthetic.make_piecewise_stack(6, SHAPE, seed=0)
    kw = dict(model="piecewise", device="cpu", batch_size=4, max_keypoints=128)
    one = kcmc_tpu_torch.MotionCorrector(**kw).correct(p.stack)
    two = kcmc_tpu_torch.MotionCorrector(mesh_devices=2, **kw).correct(p.stack)
    _close(two, one)


def test_sharded_rigid3d_matches_single_device():
    v = synthetic.make_drift_stack_3d(4, (16, 64, 64), seed=0)
    kw = dict(model="rigid3d", device="cpu", batch_size=2, max_keypoints=64)
    one = kcmc_tpu_torch.MotionCorrector(**kw).correct(v.stack)
    two = kcmc_tpu_torch.MotionCorrector(mesh_devices=2, **kw).correct(v.stack)
    _close(two, one)


def test_escalation_backend_keeps_the_mesh():
    mc = mk(mesh_devices=2)
    esc = mc._get_escalation_backend()
    assert esc.mesh == mc.backend.mesh and esc.config.warp == "jnp"
    # the failover, the numpy oracle, ignores it
    assert getattr(mc._get_failover_backend(), "mesh", None) is None


def test_resume_across_mesh_shapes(data, tmp_path):
    """A checkpointed run killed on a 2-shard mesh resumes on 4 shards
    (mesh_devices is resume-neutral) and ends within 1e-4 of an
    uninterrupted 4-shard run."""
    from kcmc_tpu_torch.io.tiff import write_stack
    from kcmc_tpu_torch.utils.faults import FatalFaultError

    src = str(tmp_path / "in.tif")
    write_stack(src, np.clip(data.stack * 40000, 0, 65535).astype(np.uint16))
    kw = dict(batch_size=4, max_keypoints=100, retry_backoff_s=1e-4, retry_backoff_max_s=2e-4)
    args = dict(chunk_size=4, checkpoint_every=4)
    full = kcmc_tpu_torch.MotionCorrector(device="cpu", mesh_devices=4, **kw).correct_file(
        src, output=str(tmp_path / "full.tif"), **args)
    out, ckpt = str(tmp_path / "out.tif"), str(tmp_path / "run.ckpt.npz")
    with pytest.raises(FatalFaultError):
        kcmc_tpu_torch.MotionCorrector(device="cpu", mesh_devices=2,
                                       fault_plan="device:step=3:fatal", **kw).correct_file(
            src, output=out, checkpoint=ckpt, **args)
    res = kcmc_tpu_torch.MotionCorrector(device="cpu", mesh_devices=4, **kw).correct_file(
        src, output=out, checkpoint=ckpt, **args)
    assert res.timing["restored_frames"] == 12
    assert np.abs(res.transforms - full.transforms).max() <= TOL


# -- two processes --------------------------------------------------------

_WORKER = r"""
import functools, sys
import numpy as np, torch
torch.set_num_threads(1)
rank, port = int(sys.argv[1]), sys.argv[2]
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.io.feeder import host_local_range
from kcmc_tpu_torch.parallel import (initialize_multihost, make_mesh, make_sharded_batch_fn,
                                     mesh_size, shard_host_local_frames)
from kcmc_tpu_torch.utils import synthetic

initialize_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank, device="cpu")
B, K, SHAPE = 8, 64, (96, 96)
data = synthetic.make_drift_stack(n_frames=B, shape=SHAPE, model="translation",
                                  max_drift=5.0, seed=41)
cfg = CorrectorConfig(model="translation", max_keypoints=K, batch_size=B)
single = TorchBackend(cfg, device="cpu")
ref = single.prepare_reference(data.stack[0])
truth = single.process_batch(data.stack, ref, np.arange(B))

mesh = make_mesh(2, device="cpu")  # two shards here, four in all
assert mesh_size(mesh) == 4
lo, hi = host_local_range(B)
assert (lo, hi) == (rank * B // 2, (rank + 1) * B // 2), (lo, hi)
klo, khi = rank * K // 2, (rank + 1) * K // 2
frames = shard_host_local_frames(data.stack[lo:hi], mesh)
idx = shard_host_local_frames(torch.arange(lo, hi), mesh)
local = functools.partial(single._local_program, None, SHAPE, False)
for chunks in (0, 2):
    fn = make_sharded_batch_fn(local, mesh, collective_chunks=chunks)
    out = fn(frames, ref["xy"][klo:khi], ref["desc"][klo:khi], ref["valid"][klo:khi],
             ref["frame"], idx)
    err = float(np.abs(out["transform"].numpy() - truth["transform"][lo:hi]).max())
    assert err < 1e-4, (rank, chunks, err)
    for k in ("n_inliers", "n_matches", "warp_ok"):
        assert np.array_equal(out[k].numpy(), truth[k][lo:hi]), (rank, chunks, k)
    print(f"process {rank} chunks {chunks}: OK, max|dT|={err:.2e}", flush=True)
"""


def test_two_gloo_processes_match_single_device(tmp_path):
    """Two processes (gloo), two CPU shards each, every process feeding
    only its host-local half of the batch and its half of the
    K-sharded reference: the gathers cross the processes, monolithic
    and as a ring of 2 chunks, and each process's outputs match a
    single-device run of the same frames."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{out}\n{err[-3000:]}"
        assert f"process {r} chunks 0: OK" in out and f"process {r} chunks 2: OK" in out
