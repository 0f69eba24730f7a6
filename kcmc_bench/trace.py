"""What a `--trace 1` run reads from torch.profiler.

The traced window is one `record_function` range (`WINDOW`) around whole
calls of the timed path, closed after the device has finished. From the
profile it takes, all on the profiler's one clock:

* the device's kernel and copy intervals inside the window: their union
  is the busy time, their sum by name the top device operations, the
  kernels' count and summed time the launches and the denominator of
  the roofline share;
* the program's host ranges (`kcmc.*`, `torch_backend.stage`): host
  seconds by name over every thread, and for each idle gap of the
  device the innermost range of the calling thread open at its
  midpoint, or "outside the batch program".

Imports torch only.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "kcmc_bench.window"
RANGE_PREFIX = "kcmc."
OUTSIDE = "outside the batch program"
NAME_CHARS = 160  # of a device operation's name in the breakdown


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float
    kernels: int
    host_s: dict  # host seconds by range name
    device_ops: list  # [[name, seconds]], longest first
    idle_gaps: list  # [[innermost host range, idle seconds]], longest first


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _events(prof):
    """(name, on the device, start us, end us, thread) of every event of a
    finished session, read from the profiler's raw results: building
    its FunctionEvent tree takes minutes for the ~10^6 events of a
    piecewise call."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        lo = e.start_ns() * 1e-3
        yield (e.name(), e.device_type() == DeviceType.CUDA, lo, lo + e.duration_ns() * 1e-3,
               e.start_thread_id())


def summarize(prof, top: int = 10) -> Summary:
    """The window's numbers from a finished profiler session."""
    events = list(_events(prof))
    windows = [e for e in events if e[0] == WINDOW and not e[1]]
    if not windows:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    w0 = min(e[2] for e in windows)
    w1 = max(e[3] for e in windows)
    caller = windows[0][4]
    device, ranges = [], []
    for name, on_device, lo, hi, thread in events:
        if hi <= w0 or lo >= w1:
            continue
        if on_device:
            if not name.startswith(RANGE_PREFIX) and name != WINDOW:
                device.append((max(lo, w0), min(hi, w1), name))
        elif name.startswith(RANGE_PREFIX):
            ranges.append((lo, hi, name, thread))
    device.sort()
    busy, gaps, end = 0.0, [], w0
    for lo, hi, _ in device:
        if lo > end:
            gaps.append((end, lo))
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if w1 > end:
        gaps.append((end, w1))
    by_op: dict[str, float] = {}
    kernel_us, n_kernels = 0.0, 0
    for lo, hi, name in device:
        by_op[name] = by_op.get(name, 0.0) + (hi - lo)
        if not _is_copy(name):
            kernel_us += hi - lo
            n_kernels += 1
    host: dict[str, float] = {}
    for lo, hi, name, _ in ranges:
        host[name] = host.get(name, 0.0) + (hi - lo) * 1e-6
    idle = _name_gaps(gaps, [r[:3] for r in ranges if r[3] == caller])
    return Summary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernel_s=kernel_us * 1e-6,
        kernels=n_kernels, host_s=host,
        device_ops=[[k[:NAME_CHARS], v * 1e-6]
                    for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])][:top],
        idle_gaps=[[k, v * 1e-6] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])][:top],
    )


def _name_gaps(gaps: list, ranges: list) -> dict[str, float]:
    """Idle microseconds by the innermost host range (the latest-starting
    one that covers the gap's midpoint)."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out: dict[str, float] = {}
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        name = OUTSIDE
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ranges[j][1] >= mid:
                name = ranges[j][2]
                break
        out[name] = out.get(name, 0.0) + (hi - lo)
    return out

