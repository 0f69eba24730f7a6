"""rescued_share: frames of the traced calls that the bounded warp
flagged and the gather rescue re-warped (diagnostics["warp_rescued"]),
as a share of their frames, %."""


def read(run):
    frames = sum(c["frames"] for c in run.traced_calls)
    if not frames:
        return None
    return 100.0 * sum(c["rescued"] for c in run.traced_calls) / frames
