"""Sharded batch execution: frames split over the mesh, the reference
gathered (the counterpart of kcmc_tpu/parallel/sharded.py).

The frame batch is split along the mesh's frame axis: each shard
registers B / n frames on its own device, under `torch.cuda.device` of
that device, so the kernel wrappers take its stream and the C entry
points set their attributes and tensor maps there. The reference
keypoint arrays arrive sharded over K and are gathered on every shard
before the per-frame program runs, by one gather per array (device-to-
device copies within a process, `torch.distributed` across processes)
or, with `collective_chunks >= 2`, by a chunked ring. The reference
frame and the trailing arguments are replicated. Outputs come back
concatenated in shard order on the mesh's first device. RANSAC keys
fold the global frame index, so a shard computes what one device
computes for the same frames.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from kcmc_tpu_torch.parallel.mesh import process_rank_and_count


def on_device(d: torch.device):
    """The context a shard runs under: its card made current (the
    kernel wrappers read `torch.cuda.current_stream()`), nothing on the
    CPU."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def _world(processes: int | None) -> tuple[int, int]:
    """(rank, process count) the gathers span: an initialized
    torch.distributed group unless `processes` == 1."""
    return (0, 1) if processes == 1 else process_rank_and_count()


def mesh_size(mesh, processes: int | None = None) -> int:
    """Shards the frame axis spans: this process's mesh devices times
    the process count."""
    return len(mesh) * _world(processes)[1]


def _bounds(K: int, chunks: int) -> list[int]:
    chunks = max(1, min(chunks, K))
    return [round(j * K / chunks) for j in range(chunks + 1)]


def ring_all_gather(shards: list, chunks: int) -> list:
    """Every shard's rows concatenated in shard order, on every shard's
    device, as a chunked ring (kcmc_tpu/parallel/sharded.py:60): each
    shard's rows travel in `chunks` pieces (clamped to the row count),
    one hop to the next shard per step, and land at their shard's
    offset. Value-identical to the monolithic gather."""
    n = len(shards)
    if n <= 1:
        return list(shards)
    K = int(shards[0].shape[0])
    b = _bounds(K, chunks)
    devs = [s.device for s in shards]
    bufs = [[s[b[j]:b[j + 1]] for j in range(len(b) - 1)] for s in shards]
    outs = [torch.zeros((n * K,) + tuple(s.shape[1:]), dtype=s.dtype, device=s.device)
            for s in shards]
    for step in range(n):
        for i in range(n):
            # after `step` forward hops shard i holds the rows that
            # started on shard (i - step) % n
            src = (i - step) % n
            for j, buf in enumerate(bufs[i]):
                outs[i][src * K + b[j]: src * K + b[j + 1]] = buf
        if step != n - 1:
            bufs = [[buf.to(devs[i]) for buf in bufs[(i - 1) % n]] for i in range(n)]
    return outs


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool rows travel as uint8 (gloo has no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _process_all_gather(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """This process's rows of a K-sharded array gathered from every
    process, in rank order: one all-gather, or with `chunks >= 2` a ring
    of chunked isend/irecv hops."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    w = _wire(x.contiguous())
    K = int(w.shape[0])
    if chunks < 2:
        if dist.get_backend() == "nccl":
            out = torch.empty((world * K,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
            dist.all_gather_into_tensor(out, w)
        else:
            parts = [torch.empty_like(w) for _ in range(world)]
            dist.all_gather(parts, w)
            out = torch.cat(parts)
        return out.to(x.dtype)
    b = _bounds(K, chunks)
    bufs = [w[b[j]:b[j + 1]].contiguous() for j in range(len(b) - 1)]
    out = torch.zeros((world * K,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    for step in range(world):
        src = (rank - step) % world
        for j, buf in enumerate(bufs):
            out[src * K + b[j]: src * K + b[j + 1]] = buf
        if step != world - 1:
            nxt = [torch.empty_like(buf) for buf in bufs]
            reqs = []
            for buf, dst in zip(bufs, nxt):
                reqs.append(dist.isend(buf, (rank + 1) % world))
                reqs.append(dist.irecv(dst, (rank - 1) % world))
            for r in reqs:
                r.wait()
            bufs = nxt
    return out.to(x.dtype)


def gather_reference(arr: torch.Tensor, mesh, chunks: int = 0,
                     processes: int | None = None) -> list:
    """A reference array as the sharded program sees it: this process's
    rows split over its shards (K-sharded), then gathered onto every
    shard: [full array on mesh[j]] for each shard j."""
    parts = [p.to(d) for p, d in zip(torch.tensor_split(arr, len(mesh)), mesh)]
    _, world = _world(processes)
    if world > 1:
        full = _process_all_gather(torch.cat([p.to(mesh[0]) for p in parts]), chunks)
        return [full.to(d) for d in mesh]
    if chunks >= 2 and len(mesh) > 1:
        return ring_all_gather(parts, chunks)
    return [torch.cat([p.to(d) for p in parts]) for d in mesh]


def _split(x, mesh) -> list:
    if isinstance(x, (list, tuple)):
        return [t.to(d) for t, d in zip(x, mesh)]
    return [p.to(d) for p, d in zip(torch.tensor_split(x, len(mesh)), mesh)]


def make_sharded_batch_fn(local_batch_fn, mesh, extra_replicated: int = 0,
                          collective_chunks: int = 0, processes: int | None = None):
    """Wrap the backend's single-device batch program into a sharded one
    (kcmc_tpu/parallel/sharded.py:101).

    local_batch_fn(frames, ref_xy, ref_desc, ref_valid, ref_frame,
    indices, *extra) -> dict of (b, ...) tensors; indices are global
    frame indices. The returned fn takes this process's frames (a tensor
    whose rows split evenly over the mesh, or `shard_host_local_frames`'
    list) and indices, this process's rows of the K-sharded reference
    arrays (K divisible by the mesh: `pad_reference_to_mesh`), the
    replicated reference frame and `extra_replicated` replicated
    trailing tensors, and returns this process's outputs in shard order
    on mesh[0]. `collective_chunks >= 2` gathers the reference through
    the ring; the values are the same. `processes` = 1 keeps the
    gathers inside this process even under an initialized
    torch.distributed group."""
    mesh = tuple(torch.device(d) for d in mesh)
    chunks = int(collective_chunks)

    def fn(frames, ref_xy, ref_desc, ref_valid, ref_frame, indices, *extra):
        if len(extra) != extra_replicated:
            raise TypeError(f"expected {extra_replicated} replicated arguments, got {len(extra)}")
        fr, ix = _split(frames, mesh), _split(indices, mesh)
        xy, desc, valid = (gather_reference(a, mesh, chunks, processes)
                           for a in (ref_xy, ref_desc, ref_valid))
        outs = []
        for j, d in enumerate(mesh):
            with on_device(d):
                outs.append(local_batch_fn(
                    fr[j], xy[j], desc[j], valid[j], ref_frame.to(d), ix[j],
                    *(e.to(d) for e in extra)))
        home = mesh[0]
        return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}

    return fn


def pad_reference_to_mesh(ref: dict, n: int) -> dict:
    """Append masked rows (valid False, zero coordinates and
    descriptors) so the reference keypoint count divides the mesh
    (kcmc_tpu/parallel/sharded.py:180); the padded slots never match."""
    K = int(ref["xy"].shape[0])
    pad = (-K) % n
    if pad == 0:
        return ref
    out = dict(ref)
    for key in ("xy", "desc", "valid"):
        v = ref[key]
        if isinstance(v, torch.Tensor):
            out[key] = torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]), dtype=v.dtype,
                                                 device=v.device)])
        else:
            v = np.asarray(v)
            out[key] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
    return out


def pad_batch_to_mesh(frames, indices, n: int):
    """Repeat the last row of a (B, ...) batch and its frame indices so B
    divides the mesh (kcmc_tpu/parallel/sharded.py:205); the caller
    slices the outputs back to B. Returns (frames, indices, B)."""
    B = int(frames.shape[0])
    pad = (-B) % n
    if pad == 0:
        return frames, indices, B
    if isinstance(frames, torch.Tensor):
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
    else:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    if isinstance(indices, torch.Tensor):
        indices = torch.cat([indices, indices[-1:].expand(pad)])
    else:
        indices = np.concatenate([indices, np.repeat(indices[-1:], pad)])
    return frames, indices, B
