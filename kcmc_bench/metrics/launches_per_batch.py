"""launches_per_batch: CUDA kernels that ran on the device inside the
traced window (the profiler's device events, copies and memsets left
out), per batch."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.trace.kernels / run.batches(run.traced_calls)
