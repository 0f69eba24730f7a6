"""Shape-bucket policy of the execution plans (the port's copy of
kcmc_tpu/plans/buckets.py, with its routing and its error texts).

Every distinct frame shape is its own set of warm kernel launches and
allocator blocks, so serving arbitrary input sizes from a warm process
needs a quantized shape space: a declared ladder of (H, W) buckets. An
input whose shape is not itself a bucket is zero-padded bottom/right to
the smallest covering bucket, registered there (detection masked to
the valid extent: backends/torch_backend.py's bucketed batch program),
and the outputs are sliced back.

This module is the pure policy layer: spec normalization, validation
and routing. It imports no torch, because `CorrectorConfig.__post_init__`
normalizes `plan_buckets` through it.
"""

from __future__ import annotations


def normalize_buckets(spec) -> tuple[tuple[int, int], ...]:
    """Canonicalize a bucket spec into a sorted tuple of (H, W) pairs.

    Accepts None/()/[], a bare int (one square bucket), or an iterable
    whose entries are positive ints (square buckets) or (H, W) pairs —
    so ``(512, 1024)`` is a ladder of two squares and ``((480, 640),)``
    one rectangular bucket. Result is area-sorted (routing picks the first
    cover, i.e. the smallest), deduplicated, hashable — the canonical
    form stored back into the frozen config so config digests and the
    plan stamps key on one spelling.
    """
    if spec is None:
        return ()
    if isinstance(spec, int):
        # bare int: a one-rung ladder of one square bucket
        spec = (spec,)
    out: list[tuple[int, int]] = []
    for entry in spec:
        if isinstance(entry, bool):
            raise ValueError(f"plan bucket entries must be ints, got {entry!r}")
        if isinstance(entry, int):
            hw = (entry, entry)
        elif (
            isinstance(entry, (tuple, list))
            and len(entry) == 2
            and all(isinstance(s, int) and not isinstance(s, bool) for s in entry)
        ):
            hw = (int(entry[0]), int(entry[1]))
        else:
            raise ValueError(
                "plan bucket entries must be a positive int (square) or "
                f"an (H, W) pair of positive ints, got {entry!r}"
            )
        if hw[0] < 32 or hw[1] < 32:
            raise ValueError(
                f"plan bucket {hw} is too small — buckets must be at "
                "least 32x32 (the detection border + descriptor patch "
                "leave no selectable interior below that)"
            )
        if hw not in out:
            out.append(hw)
    return tuple(sorted(out, key=lambda hw: (hw[0] * hw[1], hw[0])))


def route_shape(
    shape, buckets: tuple[tuple[int, int], ...]
) -> tuple[int, int] | None:
    """The smallest bucket covering `shape` (H <= bH and W <= bW), or
    None when no bucket covers it (the caller falls back to an
    exact-shape compile and counts a `bucket_fallback`)."""
    if len(shape) != 2:
        return None
    h, w = int(shape[0]), int(shape[1])
    for bh, bw in buckets:  # area-sorted: first cover is the smallest
        if h <= bh and w <= bw:
            return (bh, bw)
    return None


def batch_ladder(batch_size: int) -> tuple[int, ...]:
    """The halving batch-bucket ladder under `batch_size`: every power
    of two below it, plus the full window itself — e.g. 8 -> (1, 2, 4,
    8), 12 -> (1, 2, 4, 8, 12). The serve scheduler's deadline-forced
    partial dispatch pads a short window to the smallest covering rung
    (same quantized-shape-space argument as the (H, W) buckets: each
    rung is one warm program, and a 3-frame window on the 4-rung
    beats paying the full-window batch latency)."""
    b = int(batch_size)
    if b < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size!r}")
    out: list[int] = []
    rung = 1
    while rung < b:
        out.append(rung)
        rung *= 2
    out.append(b)
    return tuple(out)


def route_batch(n: int, ladder: tuple[int, ...]) -> int | None:
    """The smallest ladder rung covering `n` frames, or None when no
    rung covers it (n exceeds the full window — the caller splits the
    window instead). Ladder is ascending by construction
    (`batch_ladder`), so the first cover is the smallest."""
    n = int(n)
    if n < 1:
        return None
    for rung in ladder:  # ascending: first cover is the smallest
        if n <= rung:
            return int(rung)
    return None
