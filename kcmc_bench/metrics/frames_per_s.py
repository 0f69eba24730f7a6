"""frames_per_s: every frame of every call of the window over the time
from the first call's start to the last call's end (host clock)."""


def read(run):
    if not run.calls:
        return None
    frames = sum(c["frames"] for c in run.calls)
    return frames / (run.calls[-1]["end"] - run.calls[0]["start"])
