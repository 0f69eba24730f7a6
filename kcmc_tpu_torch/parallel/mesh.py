"""Device meshes of the port (the counterpart of kcmc_tpu/parallel/mesh.py).

A mesh is a 1-D tuple of `torch.device`s, one per frame shard of this
process: `cuda:0 .. cuda:N-1` on the card (a device may appear more
than once: a two-shard mesh on one card exercises the split, the
padding and the gather there), and N virtual shards on the CPU (the
counterpart of the 8 virtual XLA host devices the reference's CPU
tests run on). Across processes (`initialize_multihost`, one process
per device), each process holds its own shards and the frame axis spans
the processes in rank order.
"""

from __future__ import annotations

import os

import torch

from kcmc_tpu_torch.utils.device import resolve_device

# The single mesh axis of this pipeline: data parallelism over frames.
FRAME_AXIS = "frames"

# Virtual CPU shards a CPU mesh may span, as the reference's CPU tests
# force 8 virtual XLA host devices (tests/conftest.py).
CPU_VIRTUAL_DEVICES = 8


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh may span: every card by index, or the virtual
    CPU shards for device="cpu". With no card and no device this raises
    (the port's device rule)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_VIRTUAL_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_rank_and_count() -> tuple[int, int]:
    """(rank, world size) of an initialized torch.distributed group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: int | None = None, devices=None, device=None) -> tuple:
    """A 1-D mesh over the first `n_devices` (default: all) of `devices`
    (default: `visible_devices(device)`). Asking for more devices than
    exist raises. In a multi-process run on the card with no explicit
    devices, each process's default mesh is its own card
    (`cuda:rank % count`)."""
    if devices is None:
        devices = visible_devices(device)
        rank, world = process_rank_and_count()
        if n_devices is None and world > 1 and devices[0].type == "cuda":
            devices = [devices[rank % len(devices)]]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(devices)


def resolve_mesh(mesh_devices: int = 0, device=None) -> tuple | None:
    """The config -> mesh seam (`CorrectorConfig.mesh_devices`,
    KCMC_DEVICES): the 1-D frame-axis mesh a backend should shard over,
    or None for one device (kcmc_tpu/parallel/mesh.py:33).

    `mesh_devices`: 0 = auto (KCMC_DEVICES; absent or "0" keeps one
    device), N >= 1 = the first N visible devices, -1 = every visible
    device ("all" in the variable). A non-zero config value wins over
    the environment. More devices than exist raise; every failure of an
    environment value names KCMC_DEVICES."""
    n = int(mesh_devices)
    env_src = None
    if n == 0:
        env = os.environ.get("KCMC_DEVICES", "").strip()
        if not env:
            return None
        env_src = env
        if env.lower() == "all":
            n = -1
        else:
            try:
                n = int(env)
            except ValueError:
                raise ValueError(
                    f"KCMC_DEVICES must be 'all', '0' (single-chip), or "
                    f"a device count, got {env!r} — unset it or pass an "
                    "explicit --devices / mesh_devices"
                ) from None
        if n == 0:
            return None
    if n < -1:
        raise ValueError(
            f"mesh_devices must be -1 (all), 0 (single-chip), or a "
            f"positive device count, got {n}"
            + (f" (from KCMC_DEVICES={env_src!r})" if env_src else "")
        )
    try:
        return make_mesh(None if n == -1 else n, device=device)
    except ValueError as e:
        if env_src is not None:
            raise ValueError(
                f"{e} (from the KCMC_DEVICES={env_src!r} env var — "
                "unset it or pass an explicit --devices / mesh_devices)"
            ) from None
        raise


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None,
                         timeout_s: float | None = None) -> None:
    """Join this process to a multi-process run (kcmc_tpu/parallel/
    mesh.py:88): `torch.distributed.init_process_group` over TCP at
    `coordinator_address` ("host:port"; None reads MASTER_ADDR /
    MASTER_PORT), gloo on the CPU and NCCL on the card, where the
    process's current card becomes `cuda:process_id % count`.
    `timeout_s` bounds the group's collectives (torch's default
    otherwise)."""
    import datetime

    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(process_id or 0) % torch.cuda.device_count())
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id, **kw)


def shard_host_local_frames(frames, mesh) -> list[torch.Tensor]:
    """This process's frames as its shards of the global batch
    (kcmc_tpu/parallel/mesh.py:106): split evenly over the process's
    mesh devices, each shard on its device, no data crossing processes.
    The sharded batch program takes the list as its frame argument."""
    t = frames if isinstance(frames, torch.Tensor) else torch.as_tensor(frames)
    if t.shape[0] % len(mesh):
        raise ValueError(
            f"{t.shape[0]} host-local rows do not split over {len(mesh)} shards"
        )
    return [part.to(d) for part, d in zip(torch.tensor_split(t, len(mesh)), mesh)]
