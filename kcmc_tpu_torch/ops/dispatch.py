"""Stable argsort of small integer keys by one packed sort.

Counterpart of `kcmc_tpu/ops/dispatch.py::stable_argsort_small_keys`,
the primitive the bins-first describe route groups keypoints with.
"""

from __future__ import annotations

import torch


def stable_argsort_small_keys(keys: torch.Tensor, max_key: int):
    """Stable argsort of small non-negative integer keys along the last
    axis via ONE packed sort: (key << sh) | index sorts by key with ties
    broken by ascending index, which is exactly a stable argsort.

    `max_key` is the largest possible key (the drop sentinel included);
    the pack must fit int32, as in the reference, which raises beyond.
    Keys are clamped to [0, max_key] before packing, so a corrupt key
    stays a wrong key of its own item and cannot scramble the order of
    the others. Returns (order, sorted_keys), int64 each, like
    (argsort(keys), keys[order])."""
    N = keys.shape[-1]
    sh = max(1, int(N - 1).bit_length())
    if (max_key << sh) + N >= 1 << 31:
        raise ValueError(
            f"packed stable argsort: max_key={max_key} << {sh} | index "
            f"overflows int32 at N={N}; use a key-value argsort for this scale"
        )
    k = torch.clamp(keys.to(torch.int64), 0, max_key)
    idx = torch.arange(N, dtype=torch.int64, device=keys.device)
    packed, _ = torch.sort((k << sh) | idx, dim=-1)
    return packed & ((1 << sh) - 1), packed >> sh
