"""copy_host_ms: host milliseconds a batch inside the program's
`kcmc.upload` and `kcmc.download` ranges, over the traced calls."""

RANGES = ("kcmc.upload", "kcmc.download")


def read(run):
    if run.trace is None or not any(r in run.trace.host_s for r in RANGES):
        return None
    seconds = sum(run.trace.host_s.get(r, 0.0) for r in RANGES)
    return 1e3 * seconds / run.batches(run.traced_calls)
