"""Plain-torch proofs of the arithmetic that K7 and K5 skip or add on the
card, at small sizes on the CPU.

K7 (csrc/warp_matrix.cu) takes an exact affine branch: where the
normalized g and h are both +-0 it evaluates the source map and its
fixed-point steps without wq and without the division. Here the same
evaluation replaces `smap` inside `warp_batch_matrix_plain` and the
corrected frames and ok flags must not change by a bit, on affine maps
with positive, negative, tiny and degenerate M[2, 2], on a batch that
mixes them with projective frames (g = 1e-30 included) and on a frame
whose fixed-point rows overflow.

K5 (csrc/select.cu) computes a tile of 8 row blocks as one pass per
distinct bin in which the row blocks of other bins multiply zero rows.
Here that decomposition, in float32, must equal
`binned_select_rows_plain` bit for bit with the describe route's
one-hot selection stack, and within one bf16 ulp with a dense one.
"""

import numpy as np
import pytest
import torch

from kcmc_tpu_torch.ops import cuda_warp_matrix
from kcmc_tpu_torch.ops.cuda_select import binned_select_rows_plain
from kcmc_tpu_torch.ops.cuda_warp_matrix import matrix_scalars, warp_batch_matrix_plain
from kcmc_tpu_torch.ops.describe import RUN_ALIGN, sel_rot
from kcmc_tpu_torch.ops.warp_field import smap

# M[2, 2] of the affine maps: unit, negative, tiny but sound, and
# degenerate (|M[2, 2]| <= 1e-6: the map is used unnormalized)
M22 = {"unit": 1.0, "negative": -1.0, "negative_scaled": -0.37, "tiny": 3e-6,
       "degenerate": 4e-7}


def _affine_maps(rng, n, shape, m22, shift=3.0):
    H, W = shape
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    M = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        th = rng.uniform(-0.05, 0.05)
        A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        A = A @ (np.eye(2) + rng.uniform(-0.02, 0.02, (2, 2)))
        M[i, :2, :2] = A
        M[i, :2, 2] = rng.uniform(-shift, shift, 2) + c - A @ c
    M *= m22  # the same map, scaled: M[2, 2] = m22, g = h = 0
    if abs(m22) <= 1e-6:
        M[:, :2] /= m22  # degenerate M[2, 2]: the rows are used as they are
    return M.astype(np.float32)


def smap_affine_branch(m, x, y):
    """K7's source map: frames whose normalized g and h are both +-0
    skip wq and the division; the others evaluate `smap`."""
    shape = (m.shape[0],) + (1,) * (x.dim() - 1)

    def c(i, j):
        return m[:, i, j].reshape(shape)

    aff = ((m[:, 2, 0] == 0) & (m[:, 2, 1] == 0)).reshape(shape)
    sx_p, sy_p = smap(m, x, y)
    sx_a = c(0, 0) * x + c(0, 1) * y + c(0, 2)
    sy_a = c(1, 0) * x + c(1, 1) * y + c(1, 2)
    return torch.where(aff, sx_a, sx_p), torch.where(aff, sy_a, sy_p)


@pytest.mark.parametrize("m22", sorted(M22))
def test_affine_source_map_needs_no_division(m22):
    """On pixel coordinates and on arbitrary finite rows (the
    fixed-point iterates), wq is exactly 1 and s / wq == s."""
    rng = np.random.default_rng(len(m22))
    M = torch.as_tensor(_affine_maps(rng, 6, (64, 80), M22[m22]))
    m = matrix_scalars(M, (64, 80))[0]
    assert bool((m[:, 2, :2] == 0).all())
    xs = torch.arange(80, dtype=torch.float32)[None, None, :]
    ys = torch.arange(64, dtype=torch.float32)[None, :, None]
    yc = torch.as_tensor(rng.uniform(-3000, 3000, (6, 64, 80)).astype(np.float32))
    for y in (ys, yc):
        want = smap(m, xs, y)
        got = smap_affine_branch(m, xs, y)
        for w, g in zip(want, got):
            assert torch.equal(w.view(torch.int32), g.view(torch.int32))


def _mixed_case(shape, m22, seed):
    """Affine frames at m22, two projective frames (one with g =
    1e-30), and a frame whose fixed-point rows overflow."""
    rng = np.random.default_rng(seed)
    H, W = shape
    M = _affine_maps(rng, 6, shape, M22[m22])
    M[1, 2, 0] = 1e-30 * M[1, 2, 2]
    M[2, 2, :2] = np.float32(2e-4) * M[2, 2, 2]
    M[3, 1, 1] = 3e38  # s_y overflows: wq would be NaN, the branch gives inf
    fr = rng.normal(0, 1, (6, H, W)).astype(np.float32)
    return torch.as_tensor(fr), torch.as_tensor(M)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
@pytest.mark.parametrize("m22", sorted(M22))
def test_affine_branch_warp_bitwise(monkeypatch, shape, m22):
    fr, M = _mixed_case(shape, m22, seed=len(m22) + shape[1])
    want, want_ok = warp_batch_matrix_plain(fr, M, 6)
    m = matrix_scalars(M, shape)[0]
    aff = ((m[:, 2, 0] == 0) & (m[:, 2, 1] == 0)).tolist()
    assert aff == [True, False, False, True, True, True]
    monkeypatch.setattr(cuda_warp_matrix, "smap", smap_affine_branch)
    got, ok = warp_batch_matrix_plain(fr, M, 6)
    assert torch.equal(ok, want_ok)
    assert not bool(want_ok[3])
    # a degenerate M[2, 2] clears every frame; the others keep the affine ones
    assert bool(want_ok[[0, 4, 5]].all()) == (m22 != "degenerate")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def tile_passes(flat, ibin, sel, align=RUN_ALIGN, tile=8):
    """K5's decomposition: per tile of `tile` row blocks, one float32
    pass per distinct bin, rows of other bins zeroed, summed."""
    B, Kp, L = flat.shape
    nb, _, V = sel.shape
    nblk = Kp // align
    out = torch.empty((B, Kp, V), dtype=torch.float32)
    for b in range(B):
        for t0 in range(0, nblk, tile):
            bins = torch.clamp(ibin[b, t0:t0 + tile].long(), 0, nb - 1)
            rows = flat[b, t0 * align:(t0 + len(bins)) * align].float()
            row_bin = bins.repeat_interleave(align)
            acc = torch.zeros((rows.shape[0], V))
            for pb in dict.fromkeys(bins.tolist()):
                acc = acc + torch.matmul(rows * (row_bin == pb)[:, None], sel[pb].float())
            out[b, t0 * align:(t0 + len(bins)) * align] = acc
    return out.to(torch.bfloat16)


BIN_PATTERNS = {
    "every_block": lambda n: [(7 * i) % 17 for i in range(n)],  # 16: the sentinel
    "one_bin": lambda n: [5] * n,
    "runs": lambda n: sorted((3 * i) % 16 for i in range(n))[:-1] + [16],
}


@pytest.mark.parametrize("pattern", sorted(BIN_PATTERNS))
@pytest.mark.parametrize("B,Kp", [(1, 144), (2, 48), (2, 208)])
def test_k5_tile_passes_match_plain(pattern, B, Kp):
    rng = np.random.default_rng(Kp)
    sel = sel_rot("cpu")
    L = sel.shape[1]
    n = Kp // RUN_ALIGN
    flat = torch.as_tensor(rng.normal(0, 1, (B, Kp, L)).astype(np.float32)).to(torch.bfloat16)
    ibin = torch.tensor([BIN_PATTERNS[pattern](n)] * B, dtype=torch.int32)
    want = binned_select_rows_plain(flat, ibin, sel, RUN_ALIGN)
    got = tile_passes(flat, ibin, sel)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    dense = torch.as_tensor(rng.normal(0, 1, (4,) + tuple(sel.shape[1:])).astype(np.float32))
    dense = dense.to(torch.bfloat16)
    ib = torch.clamp(ibin, max=4)  # 4: the sentinel of a 4-bin stack
    gd, wd = tile_passes(flat, ib, dense).float(), binned_select_rows_plain(flat, ib, dense, 16).float()
    mag = torch.maximum(gd.abs(), wd.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    assert bool(((gd - wd).abs() <= ulp + 1e-5 * wd.abs().max()).all())
