"""K5: per-block binned selection matmul, and its plain version.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::binned_select_rows`.
`binned_select_rows(flat, ibin, sel, align)` multiplies each `align`-row
block of the bin-sorted (B, Kp, L) bf16 rows by its own bin's (L, V)
matrix of the (nb, L, V) bf16 stack `sel` (block kb of frame b takes
sel[min(ibin[b, kb], nb - 1)]; the sentinel bin nb clamps to the last
matrix), accumulates in float32 and rounds to bf16: (B, Kp, V). The
function is a general matrix product (csrc/select.cu), exact for the
describe route's one-hot selection stack. Kernel on CUDA tensors (align
16, the MMA's M), plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def binned_select_rows_plain(flat, ibin, sel, align: int):
    """Plain PyTorch version of K5: one float32 matmul per bin over the
    rows whose block carries that bin."""
    B, Kp, L = flat.shape
    nb, _, V = sel.shape
    row_bin = torch.clamp(ibin.long(), 0, nb - 1).repeat_interleave(align, dim=1)
    rows = flat.reshape(B * Kp, L)
    rb = row_bin.reshape(-1)
    out = torch.empty((B * Kp, V), dtype=torch.float32, device=flat.device)
    for k in range(nb):
        idx = torch.nonzero(rb == k).reshape(-1)
        if idx.numel():
            out[idx] = torch.matmul(rows[idx].float(), sel[k].float())
    return out.to(torch.bfloat16).reshape(B, Kp, V)


def _lib():
    fn = cuda_build.load("select").kcmc_binned_select_rows
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def binned_select_rows(flat, ibin, sel, align: int):
    """(B, Kp, V) bf16: each align-row block of `flat` times its bin's
    selection matrix."""
    require_tensor(flat, "flat", torch.bfloat16, 3)
    require_tensor(ibin, "ibin", torch.int32, 2)
    require_tensor(sel, "sel", torch.bfloat16, 3)
    B, Kp, L = flat.shape
    nb, Ls, V = sel.shape
    if Ls != L or Kp % align or ibin.shape != (B, Kp // align):
        raise ValueError(
            f"shapes do not fit: flat {tuple(flat.shape)}, ibin "
            f"{tuple(ibin.shape)}, sel {tuple(sel.shape)}, align {align}"
        )
    if not kernel_route(flat, ibin, sel):
        return binned_select_rows_plain(flat, ibin, sel, align)
    if align != 16 or V % 8 or sel.data_ptr() % 16 or flat.data_ptr() % 16:
        raise ValueError(
            "the K5 kernel takes align=16, V a multiple of 8 and a 16-byte "
            f"aligned flat and sel (got align={align}, V={V})"
        )
    out = torch.empty((B, Kp, V), dtype=torch.bfloat16, device=flat.device)
    rc = _lib()(
        flat.data_ptr(), ibin.data_ptr(), sel.data_ptr(), out.data_ptr(),
        B, Kp, L, V, nb, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "binned_select_rows")
    cuda_build.LAUNCHES["binned_select_rows"] += 1
    return out
