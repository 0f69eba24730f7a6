"""Stable argsort of small integer keys by one packed sort, and the
fixed-capacity segment-by-key built on it.

Counterpart of `kcmc_tpu/ops/dispatch.py`: the primitives the oriented
describe routes group keypoints by orientation bin with (bins-first:
aligned runs; small K: fixed-capacity segments).
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


def segment_by_key(keys: torch.Tensor, n_groups: int, cap: int):
    """Group items by integer key, `cap` slots per group, along the last
    axis of keys (..., N) (dispatch.py:54). Keys >= n_groups are dropped
    (n_groups is the drop sentinel); out-of-range keys are clamped as in
    `stable_argsort_small_keys`. Returns (slot_idx (..., n_groups, cap)
    int64, the item per slot, and slot_ok (..., n_groups, cap) bool).
    The sort is stable, so items keep their order within a group and an
    overfull group drops its LAST items."""
    N = keys.shape[-1]
    order, sk = stable_argsort_small_keys(keys, n_groups)
    lead = tuple(sk.shape[:-1])
    bins = torch.arange(n_groups, dtype=sk.dtype, device=sk.device)
    bins = bins.expand(lead + (n_groups,)).contiguous()
    starts = torch.searchsorted(sk.contiguous(), bins, side="left")
    ends = torch.searchsorted(sk.contiguous(), bins, side="right")
    slots = starts[..., None] + torch.arange(cap, device=sk.device)
    slot_ok = slots < ends[..., None]
    flat = torch.clamp(slots, max=N - 1).reshape(lead + (n_groups * cap,))
    slot_idx = torch.gather(order, -1, flat).reshape(lead + (n_groups, cap))
    return slot_idx, slot_ok
