"""setup_s: process start to the first timed call (import, CUDA start,
kernel libraries, the recording's generation and the warm-up call)."""


def read(run):
    return run.setup_s
