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

K1, K8, K9 and K6 are emulated below in the structure of their kernels
(tiles, strips, the x-march, the moment lanes), each bit for bit
against its plain version.
"""

import numpy as np
import pytest
import torch

from kcmc_tpu_torch.ops import cuda_warp_matrix
from kcmc_tpu_torch.ops.cuda_detect import _DF, _SM, detect_response_plain, gauss_taps
from kcmc_tpu_torch.ops.cuda_detect3d import _harris3, response_fields_3d_plain
from kcmc_tpu_torch.ops.cuda_moments import band_structure, moment_maps_plain
from kcmc_tpu_torch.ops.cuda_patch import MOMENT_SLOTS, _fma, _moments_plain
from kcmc_tpu_torch.ops.cuda_patch3d import extract_blended_3d_plain
from kcmc_tpu_torch.ops.cuda_select import binned_select_rows_plain
from kcmc_tpu_torch.ops.cuda_warp_field import warp_batch_field_plain
from kcmc_tpu_torch.ops.cuda_warp_matrix import matrix_scalars, warp_batch_matrix_plain
from kcmc_tpu_torch.ops.describe import RUN_ALIGN, sel_rot
from kcmc_tpu_torch.ops.warp_field import floor_int, smap

@pytest.fixture(autouse=True)
def _one_thread():
    """The emulations run thousands of small tensor ops, which torch's
    intra-op threads only slow down when several test processes share
    the host; every op here is elementwise, so the bits are the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# K1 (csrc/detect.cu): one block per TH x TW output tile stages the tile and
# a halo of the reach the parameters imply, and computes each stage only on
# the region the next one reads (blur on the tile, gradients and products on
# the tile +- e, window sums and response on the tile +- m). The emulation
# below runs that decomposition tile by tile in the kernel's operation order
# and must equal detect_response_plain bit for bit on all four outputs.

K1_TILE = (32, 64)  # (TH, TW) of csrc/detect.cu


def _chain(v, taps, dim, n):
    """One tap chain along `dim`: acc = t0 v[0:n], then += t_i v[i:i+n]."""
    acc = taps[0] * v.narrow(dim, 0, n)
    for i in range(1, len(taps)):
        acc = acc + taps[i] * v.narrow(dim, i, n)
    return acc


def k1_tiles(frames, nms_size, window_sigma, smooth_sigma, harris_k=0.04, tile=K1_TILE):
    """K1's per-tile stages on shrinking regions, assembled into frames."""
    B, H, W = frames.shape
    th, tw = tile
    g = gauss_taps(window_sigma)
    s = gauss_taps(smooth_sigma) if smooth_sigma is not None else None
    gr, sr = len(g) // 2, (len(s) // 2 if s else 0)
    lo, hi = -((nms_size - 1) // 2), nms_size // 2
    m = max(-lo, hi, 1)
    e = m + gr
    h = max(sr, e + 1)
    hx = (h + 3) & ~3
    big = max(h, hx)
    padded = torch.nn.functional.pad(frames, (big, big + tw, big, big + th))
    ninf = torch.tensor(-float("inf"))
    outs = [torch.empty_like(frames) for _ in range(4 if s else 3)]
    for ty0 in range(0, H, th):
        for tx0 in range(0, W, tw):
            def stage(r0, r1, c0, c1):  # frame pixels of tile rows/cols [r0, r1) x [c0, c1)
                return padded[:, big + ty0 + r0:big + ty0 + r1, big + tx0 + c0:big + tx0 + c1]

            ys = torch.arange(-e, th + e)[:, None] + ty0
            xs = torch.arange(-e, tw + e)[None, :] + tx0
            real = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)  # on G
            gx = _chain(_chain(stage(-e - 1, th + e + 1, -e - 1, tw + e + 1), _SM, 1, th + 2 * e),
                        _DF, 2, tw + 2 * e)
            gy = _chain(_chain(stage(-e - 1, th + e + 1, -e - 1, tw + e + 1), _SM, 2, tw + 2 * e),
                        _DF, 1, th + 2 * e)
            gx = torch.where(real, gx, torch.zeros(()))
            gy = torch.where(real, gy, torch.zeros(()))
            win = [_chain(_chain(p, g, 1, th + 2 * m), g, 2, tw + 2 * m)
                   for p in (gx * gx, gx * gy, gy * gy)]  # on T +- m
            ixx, ixy, iyy = win
            tr = ixx + iyy
            resp = (ixx * iyy - ixy * ixy) - harris_k * tr * tr
            rreal = real[e - m:e + th + m, e - m:e + tw + m]
            neg = torch.where(rreal, resp, ninf)
            rmax = neg[:, m:m + th]
            for d in range(lo, hi + 1):
                if d:
                    rmax = torch.fmax(rmax, neg[:, m + d:m + d + th])
            cmax = rmax[:, :, m:m + tw]
            for d in range(lo, hi + 1):
                if d:
                    cmax = torch.fmax(cmax, rmax[:, :, m + d:m + d + tw])
            v = resp[:, m:m + th, m:m + tw]
            rc = torch.where(rreal, resp, torch.zeros(()))

            def fit(p, q, c=rc[:, m:m + th, m:m + tw]):
                d1 = 0.5 * (p - q)
                d2 = p - 2.0 * c + q
                return torch.clamp(torch.where(d2.abs() > 1e-8, -d1 / d2, torch.zeros(())),
                                   -0.5, 0.5)

            tile_out = [torch.where(v >= cmax, v, ninf),
                        fit(rc[:, m:m + th, m + 1:m + 1 + tw], rc[:, m:m + th, m - 1:m - 1 + tw]),
                        fit(rc[:, m + 1:m + 1 + th, m:m + tw], rc[:, m - 1:m - 1 + th, m:m + tw])]
            if s:
                tile_out.append(_chain(_chain(stage(-sr, th + sr, -sr, tw + sr), s, 1, th),
                                       s, 2, tw))
            nh, nw = min(th, H - ty0), min(tw, W - tx0)
            for o, t in zip(outs, tile_out):
                o[:, ty0:ty0 + nh, tx0:tx0 + nw] = t[:, :nh, :nw]
    return tuple(outs)


def _k1_frames(shape, seed):
    rng = np.random.default_rng(seed)
    fr = rng.normal(0.0, 1.0, (2,) + shape).astype(np.float32)
    fr[1, : shape[0] // 2, : shape[1] // 2] = 0.0  # flat: NMS ties and zero fits
    return torch.as_tensor(fr)


@pytest.mark.parametrize("shape", [(7, 9), (33, 65), (232, 232)])
@pytest.mark.parametrize("smooth_sigma", [None, 2.0])
@pytest.mark.parametrize("window_sigma", [1.2, 1.5, 2.5])
@pytest.mark.parametrize("nms_size", [3, 5, 7])
def test_k1_tiles_match_plain(nms_size, window_sigma, smooth_sigma, shape):
    fr = _k1_frames(shape, seed=shape[1] + nms_size)
    want = detect_response_plain(fr, nms_size=nms_size, window_sigma=window_sigma,
                                 smooth_sigma=smooth_sigma)
    got = k1_tiles(fr, nms_size, window_sigma, smooth_sigma)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# K8 (csrc/warp_field.cu): a thread owns one column and K8_RPT output rows.
# Where every row coordinate its strip can reach lies in two cell rows it
# picks the cell row by one comparison (and, where those coordinates need
# no clamp and every cell row has a successor, tests neither); otherwise it
# caches the column-interpolated residual of K8_NCR cell rows from the
# first the strip can reach (other rows from the cells directly). It
# streams canvas rows, at most one new one and one output row per step,
# keeping the two newest (an output row whose floor fell by two or more
# recomputes its pair). The emulation runs every column of a strip at once
# that way and must equal warp_batch_field_plain bit for bit, ok flags
# included.

K8_RPT, K8_NCR = 32, 8  # as in csrc/warp_field.cu


def lerp_in(f, v0, v1):
    """The two-tap lerp without the tap-window tests: an exact frame's
    floors keep every tap inside the window."""
    return (1.0 - f) * v0 + f * v1


def k8_strips(frames, fields, mp, rpt=K8_RPT, ncr=K8_NCR):
    """(corrected, ok, counts): counts of interior two-cell strips, other
    two-cell strips, general strips, cell-row lookups served from the
    cells directly and output rows whose canvas rows were recomputed."""
    B, H, W = frames.shape
    _, gh, gw, _ = fields.shape
    rh, rw = float(np.float32(gh / H)), float(np.float32(gw / W))
    out = torch.zeros_like(frames)
    ok = torch.zeros(B, dtype=torch.bool)
    counts = {"interior": 0, "two_cell": 0, "general": 0, "direct": 0, "refetch": 0}
    xi = torch.arange(W)
    xf = xi.to(torch.float32)
    ucol = torch.clamp((xf + 0.5) * rw - 0.5, 0.0, gw - 1.0)
    d0 = torch.floor(ucol).to(torch.int64)
    has1 = d0 + 1 < gw
    h0 = torch.clamp(1.0 - (ucol - d0.to(torch.float32)).abs(), min=0.0)
    h1 = torch.clamp(1.0 - (ucol - (d0 + 1).to(torch.float32)).abs(), min=0.0)

    def urow_raw(y):
        return (y + 0.5) * rh - 0.5

    def urow(y):
        return torch.clamp(urow_raw(y), 0.0, gh - 1.0)

    for b in range(B):
        f = fields[b]
        s = torch.zeros(2)
        for c in range(gh):  # the per-block prologue: sequential row-major sums
            for d in range(gw):
                s = s + f[c, d]
        t = torch.round(s / float(gh * gw))
        bad = bool((~((f - t).abs() <= mp - 0.5)).any())
        exact = not bad and bool((t.abs() <= 128).all())
        ok[b] = exact
        if not exact:
            continue
        res = f - t

        def direct(c, ch):  # c: (W,) cell rows
            a = res[c, d0, ch] * h0
            return torch.where(has1, a + res[c, torch.clamp(d0 + 1, max=gw - 1), ch] * h1, a)

        itx, ity = int(t[0]), int(t[1])
        src = frames[b]
        for y0 in range(0, H, rpt):
            yend = min(y0 + rpt, H)
            ulo = urow_raw(torch.tensor(float(y0 - 2 * mp - 2)))
            uhi = urow_raw(torch.tensor(float(yend + 2 * mp + 1)))
            clo = int(torch.floor(torch.clamp(ulo, 0.0, gh - 1.0)))
            chi = int(torch.floor(torch.clamp(uhi, 0.0, gh - 1.0)))
            two = chi <= clo + 1
            # interior two-cell strips skip the clamp and the last-row test
            interior = two and bool(ulo >= 0.0) and bool(uhi <= gh - 1.0) and clo + 2 < gh
            urow_s = urow_raw if interior else urow
            counts["interior" if interior else "two_cell" if two else "general"] += 1
            ncache = min(min(chi + 1, gh - 1) - clo + 1, ncr)
            cache = [[direct(torch.full((W,), clo + i), ch) for ch in (0, 1)]
                     for i in range(ncache)]

            def inner(c, ch):
                k = c - clo
                hit = (k >= 0) & (k < ncache)
                counts["direct"] += int((~hit).sum())
                got = direct(c, ch)
                for i in range(ncache):
                    got = torch.where(k == i, cache[i][ch], got)
                return got

            def interp(u, ch):  # u (W,) row coordinates
                if two:  # the cell row by one comparison
                    hi = u >= clo + 1
                    c0 = clo + hi.to(torch.int64)
                    c0f = clo + torch.where(hi, 1.0, 0.0)  # cA or cA + 1, exactly
                    get = lambda c: direct(torch.clamp(c, max=gh - 1), ch)  # noqa: E731
                else:
                    c0f = torch.floor(u)
                    c0 = c0f.to(torch.int64)
                    get = lambda c: inner(torch.clamp(c, max=gh - 1), ch)  # noqa: E731
                w0 = torch.clamp(1.0 - (u - c0f).abs(), min=0.0)
                w1 = torch.clamp(1.0 - (u - (c0f + 1.0)).abs(), min=0.0)
                a = w0 * get(c0)
                if interior:
                    return a + w1 * get(c0 + 1)
                return torch.where(c0 + 1 >= gh, a, a + w1 * get(c0 + 1))

            def canvas(yb):  # yb (W,) int64
                ybf = yb.to(torch.float32)
                yc = ybf
                for _ in range(2):
                    yc = ybf - interp(urow_s(yc), 1)
                mxi, fx = floor_int(interp(urow_s(yc), 0), mp)
                row = torch.clamp(yb + ity, 0, H - 1)
                c0 = torch.clamp(xi + mxi + itx, 0, W - 1)
                c1 = torch.clamp(xi + mxi + 1 + itx, 0, W - 1)
                return lerp_in(fx, src[row, c0], src[row, c1])

            def enter(y):
                u = urow_s(y.to(torch.float32))
                ry, rx = interp(u, 1), interp(u, 0)
                myi, fy = floor_int(ry, mp)
                return ry, rx, fy, y + myi

            cols = torch.arange(W)
            y = torch.full((W,), y0)
            ry, rx, fy, a = enter(y)
            nc, nlo = a.clone(), a.clone()
            v1 = v0 = torch.zeros(W)  # canvas rows nc - 2 and nc - 1
            while bool((y < yend).any()):
                live = y < yend
                need = live & (a + 1 >= nc)
                jump = need & (a > nc)
                nc, nlo = torch.where(jump, a, nc), torch.where(jump, a, nlo)
                new = canvas(nc)
                v1, v0 = torch.where(need, v0, v1), torch.where(need, new, v0)
                nc = nc + need.to(torch.int64)
                emit = live & (a + 1 < nc)
                fast = (a == nc - 2) & (a >= nlo)
                counts["refetch"] += int((emit & ~fast).sum())
                c0 = torch.where(fast, v1, canvas(a))
                c1 = torch.where(fast, v0, canvas(a + 1))
                acc = lerp_in(fy, c0, c1)
                sy = (y.to(torch.float32) + t[1]) + ry
                sx = (xf + t[0]) + rx
                inb = (sy >= 0.0) & (sy <= H - 1.0) & (sx >= 0.0) & (sx <= W - 1.0)
                val = torch.where(inb, acc, torch.zeros(()))
                out[b, y[emit], cols[emit]] = val[emit]
                y = y + emit.to(torch.int64)
                nry, nrx, nfy, na = enter(torch.clamp(y, max=H - 1))
                ry, rx = torch.where(emit, nry, ry), torch.where(emit, nrx, rx)
                fy, a = torch.where(emit, nfy, fy), torch.where(emit, na, a)
    return out, ok, counts


def _k8_case(name):
    """(frames, fields, max_px, expected ok) of one emulation case."""
    rng = np.random.default_rng(len(name))

    def fields(n, grid, amp, mean=(0.0, 0.0)):
        return (rng.uniform(-amp, amp, (n,) + grid + (2,)) + np.float32(mean)).astype(np.float32)

    if name == "8x8":
        H, W, f, mp = 256, 40, fields(3, (8, 8), 4.5, (3.3, -2.2)), 6
    elif name == "6x5":
        H, W, f, mp = 45, 40, fields(2, (6, 5), 4.6, (-7.4, 1.6)), 6
    elif name == "78x78":  # more cells than rows: lookups beyond the cache
        H, W, f, mp = 40, 36, fields(2, (78, 78), 2.8, (0.4, 12.3)), 4
    elif name == "crossing":  # the fixed point runs across several strips
        H, W, f, mp = 56, 24, fields(2, (4, 3), 16.5, (0.0, 0.3)), 18
    else:  # an inf cell, a residual beyond the bound, a mean beyond +-PAD
        H, W, mp = 24, 20, 6
        f = fields(4, (5, 4), 3.0)
        f[0, 2, 1, 0] = np.inf
        f[1, 0, :] += 9.0
        f[2] += 300.0
    fr = rng.normal(0.0, 1.0, (f.shape[0], H, W)).astype(np.float32)
    return torch.as_tensor(fr), torch.as_tensor(f), mp


@pytest.mark.parametrize("name", ["8x8", "6x5", "78x78", "crossing", "out_of_envelope"])
def test_k8_strips_match_plain(name):
    fr, f, mp = _k8_case(name)
    want, want_ok = warp_batch_field_plain(fr, f, mp)
    got, ok, counts = k8_strips(fr, f, mp)
    assert torch.equal(ok, want_ok)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if name == "out_of_envelope":
        assert ok.tolist() == [False, False, False, True]
    else:
        assert bool(ok.all())
    # cells as tall as config 3's keep every strip on the two-cell path
    # (interior strips untested) and reuse the two newest canvas rows;
    # shorter cells take the general path, whose cache holds every cell row
    # the strip reaches unless there are more cells than rows, and steep
    # residuals recompute some pairs
    if name == "8x8":
        assert counts["interior"] and counts["two_cell"] and not counts["general"]
        assert not counts["refetch"]
    if name in ("6x5", "crossing"):
        assert counts["general"] and not counts["direct"] and counts["refetch"]
    if name == "78x78":
        assert counts["direct"] > 0


# ---------------------------------------------------------------------------
# K9 (csrc/detect3d.cu): a block owns TZ x TY (z, y) output points of one
# volume and marches x. Its input streams through a ring of 2 XB x-slices
# of the (z, y) region plus a halo of max(GR + 1, SR), in bricks of XB
# slices (brick k + 1 issued at step k XB + 2 over the slots of brick
# k - 1). At step s the products of slice s - 1 are formed once on the
# tile +- GR (zero outside the volume) and windowed along z (into the
# buffer of the slice's parity); slice s - 2 is windowed along y for the
# tile's rows and shifted into the x window's 2 GR + 1 registers (the
# output that has taken t taps in register t; register 0 starts one,
# register 2 GR completes one and forms its response); after the last
# slice, zero slices add the trailing padding taps. The blur takes
# slice s along z and y into a ring of 24 slices; once slice 8 m + 7 + SR
# is in, it windows slices 8 m - SR .. 8 m + 7 + SR along x into the
# outputs 8 m .. 8 m + 7. The emulation runs that march for every tile
# at once and must equal response_fields_3d_plain bit for bit.

K9_TILE = (16, 32)  # (TZ, TY) of csrc/detect3d.cu
K9_XB = 8  # x-slices of a brick; the input ring holds two
K9_XQ, K9_NXR = 8, 24  # x-blur outputs of an item; y-blurred slices kept bricks


def k9_march(vols, window_sigma, smooth_sigma, harris_k=0.005, tile=K9_TILE):
    """(resp, smooth or None) of (B, D, H, W) volumes by K9's x-march."""
    B, D, H, W = vols.shape
    g = gauss_taps(window_sigma)
    gr, n = len(g) // 2, len(g)
    sw = gauss_taps(smooth_sigma) if smooth_sigma is not None else ()
    sr, nb = len(sw) // 2, len(sw)
    tz, ty = tile
    hz = max(gr + 1, sr)
    nz, ny = -(-D // tz), -(-H // ty)
    xb_end = -(-W // K9_XQ) * K9_XQ - 1 + sr
    s_end = max(W + gr + 1, xb_end) if sr else W + gr + 1
    ns = 2 * K9_XB
    # every tile's region with its halo, x from brick -1 on, zero outside
    nx = (s_end // K9_XB + 3) * K9_XB
    big = torch.zeros(B, nz * tz + 2 * hz, ny * ty + 2 * hz, nx)
    big[:, hz:hz + D, hz:hz + H, K9_XB:K9_XB + W] = vols
    reg = torch.stack([big[:, iz * tz:iz * tz + tz + 2 * hz, iy * ty:iy * ty + ty + 2 * hz]
                       for iz in range(nz) for iy in range(ny)], 1)
    reg = reg.reshape(-1, tz + 2 * hz, ty + 2 * hz, nx)
    T = reg.shape[0]
    z0 = torch.tensor([iz * tz for iz in range(nz) for _ in range(ny)]).repeat(B)
    y0 = torch.tensor([iy * ty for _ in range(nz) for iy in range(ny)]).repeat(B)
    zs = z0[:, None, None] - gr + torch.arange(tz + 2 * gr)[None, :, None]
    ys = y0[:, None, None] - gr + torch.arange(ty + 2 * gr)[None, None, :]
    inside = (zs >= 0) & (zs < D) & (ys >= 0) & (ys < H)  # the product region

    ring = torch.zeros(T, ns, tz + 2 * hz, ty + 2 * hz)

    def load_brick(k):
        for xi in range(K9_XB):
            x = k * K9_XB + xi
            ring[:, x % ns] = reg[..., K9_XB + x] if 0 <= x < W else 0.0

    load_brick(-1)
    load_brick(0)
    acc = torch.zeros(T, 6, n, tz, ty)
    bring = torch.zeros(T, K9_NXR, tz, ty)
    resp = torch.zeros(T, tz, ty, W)
    smooth = torch.zeros(T, tz, ty, -(-W // K9_XQ) * K9_XQ)
    zwin = [None, None]  # z-windowed slices by parity
    zero = torch.zeros(())
    for s in range(s_end + 1):
        sp, sx = s - 1, s - 2
        live = 0 <= sp < W
        if s % K9_XB == 2:
            load_brick(s // K9_XB + 1)
        if sr and s < W:
            o = hz - sr
            bz = _chain(ring[:, s % ns, o:o + tz + 2 * sr, o:o + ty + 2 * sr], sw, 1, tz)
        if live:
            o = hz - gr
            rz, ry = slice(o, o + tz + 2 * gr), slice(o, o + ty + 2 * gr)
            c, m, p = ring[:, sp % ns], ring[:, (sp - 1) % ns], ring[:, s % ns]
            gx = 0.5 * (p[:, rz, ry] - m[:, rz, ry])
            gy = 0.5 * (c[:, rz, o + 1:o + 1 + ty + 2 * gr] - c[:, rz, o - 1:o - 1 + ty + 2 * gr])
            gz = 0.5 * (c[:, o + 1:o + 1 + tz + 2 * gr, ry] - c[:, o - 1:o - 1 + tz + 2 * gr, ry])
            gx, gy, gz = (torch.where(inside, v, zero) for v in (gx, gy, gz))
            prods = torch.stack([gx * gx, gy * gy, gz * gz, gx * gy, gx * gz, gy * gz], 1)
            zwin[sp % 2] = _chain(prods, g, 2, tz)
        if sr:
            bring[:, s % K9_NXR] = _chain(bz, sw, 2, ty) if s < W else 0.0
        if sx >= 0:
            yv = _chain(zwin[sx % 2], g, 3, ty) if sx < W else torch.zeros(T, 6, tz, ty)
            for t in range(n - 1, 0, -1):
                acc[:, :, t] = acc[:, :, t - 1] + g[t] * yv
            acc[:, :, 0] = g[0] * yv
            x = sx - gr
            if 0 <= x < W:
                resp[..., x] = _harris3(*acc[:, :, n - 1].unbind(1), harris_k)
        if sr and s >= K9_XQ - 1 + sr and (s - sr) % K9_XQ == K9_XQ - 1:
            x0 = s - sr - (K9_XQ - 1)
            slices = torch.stack([bring[:, (x0 - sr + i) % K9_NXR]
                                  for i in range(K9_XQ + 2 * sr)], -1)
            smooth[..., x0:x0 + K9_XQ] = _chain(slices, sw, 3, K9_XQ)

    def assemble(f):
        f = f.reshape(B, nz, ny, tz, ty, W).permute(0, 1, 3, 2, 4, 5)
        return f.reshape(B, nz * tz, ny * ty, W)[:, :D, :H].contiguous()

    return assemble(resp), (assemble(smooth[..., :W]) if sr else None)


def _k9_volumes(shape, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 1.0, (3,) + shape).astype(np.float32)
    v[1, : shape[0] // 2, : shape[1] // 2] = 0.0  # flat: zero gradients, zero sums
    # products that underflow to +0.0 and -0.0, and a corner of negative
    # subnormals whose blur terms round to -0.0: sums whose sign of zero
    # depends on every padding tap
    v[2] *= np.float32(1e-24)
    v[2, : shape[0] // 2, :, : shape[2] // 2] = -np.float32(1e-45)
    return torch.as_tensor(v)


@pytest.mark.parametrize("shape", [(5, 9, 11), (12, 33, 47), (20, 72, 88)])
@pytest.mark.parametrize("sr", [None, 1, 3, 5, 6])
@pytest.mark.parametrize("gr", [1, 3, 5, 6])
def test_k9_march_matches_plain(gr, sr, shape):
    ws, ss = gr / 3.0, (None if sr is None else sr / 3.0)
    assert len(gauss_taps(ws)) == 2 * gr + 1
    assert sr is None or len(gauss_taps(ss)) == 2 * sr + 1
    vols = _k9_volumes(shape, seed=shape[2] + gr)
    want = response_fields_3d_plain(vols, window_sigma=ws, smooth_sigma=ss)
    got = k9_march(vols, ws, ss)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if sr is None:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


# ---------------------------------------------------------------------------
# K6 (csrc/patch.cu): the lane of a window column (two columns for P > 32)
# sums the disc terms of its column in float64 as the rows pass; the 15
# column sums go to slot dx + 7 of 16 (slot 15 holds +0.0) and lane i
# adds lane i ^ h for h = 8, 4, 2, 1 (__shfl_xor_sync); lane 0 rounds once.
# The emulation must equal _moments_plain bit for bit. On realistic
# windows every order gives the same float64 sums (all exact); where two
# column sums near 2^59 cancel beside small ones the order shows, and a
# tree in another order must differ.


def k6_lane_moments(patch, fx, fy, tree=(8, 4, 2, 1)):
    """(m10, m01) of raw (B, K, P, P) windows as K6's lanes form them."""
    P = patch.shape[-1]
    mr = 7
    cc = (P - 2) // 2
    cy = cc + (fy >= 0.5).long()
    cx = cc + (fx >= 0.5).long()
    dx = (torch.arange(P) - cx[..., None]).double()  # (B, K, P) per window column
    cols = torch.zeros(patch.shape[:-2] + (P, 2), dtype=torch.float64)
    for r in range(P):
        dy = (r - cy).double()[..., None]
        v = patch[..., r, :].double()
        disc = (dx.abs() <= mr) & (dx * dx + dy * dy <= mr * mr)
        cols[..., 0] = torch.where(disc, cols[..., 0] + v * dx, cols[..., 0])
        cols[..., 1] = torch.where(disc, cols[..., 1] + v * dy, cols[..., 1])
    lanes = torch.zeros(patch.shape[:-2] + (MOMENT_SLOTS, 2), dtype=torch.float64)
    idx = (cx[..., None] - mr + torch.arange(2 * mr + 1))[..., None].expand(
        patch.shape[:-2] + (2 * mr + 1, 2))
    lanes[..., :2 * mr + 1, :] = torch.gather(cols, -2, idx)
    lane = torch.arange(MOMENT_SLOTS)
    for h in tree:
        lanes = lanes + lanes[..., lane ^ h, :]
    m = lanes[..., 0, :].float()
    return m[..., 0], m[..., 1]


def _k6_rowmajor(patch, fx, fy):
    """The moments' earlier order: one float64 sum over the disc, row-major."""
    P = patch.shape[-1]
    cc = (P - 2) // 2
    cy = cc + (fy >= 0.5).long()
    cx = cc + (fx >= 0.5).long()
    flat = patch.reshape(patch.shape[:-2] + (P * P,))
    sx = torch.zeros(fx.shape, dtype=torch.float64)
    sy = torch.zeros_like(sx)
    for dy in range(-7, 8):
        for dx in range(-7, 8):
            if dx * dx + dy * dy <= 49:
                v = torch.gather(flat, -1, ((cy + dy) * P + cx + dx)[..., None])[..., 0].double()
                sx, sy = sx + v * float(dx), sy + v * float(dy)
    return sx.float(), sy.float()


def _k6_windows(case, P, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 24, P, P)
    if case == "normal":
        w = rng.normal(0.0, 1.0, shape)
    elif case == "all_zero":
        w = np.zeros(shape)
    elif case == "sign_mixed":
        w = rng.choice([-1.0, 1.0], shape) * 2.0 ** rng.integers(-12, 6, shape)
    elif case == "signed_zero":
        w = rng.choice([-0.0, 0.0, -1.0, 1.0], shape, p=[0.4, 0.4, 0.1, 0.1])
    else:  # "wide": on the centre row, columns dx = -7 and +1 cancel to 0 in
        # m10 (slots 0 and 8) beside small terms float64 rounds away next to them
        w = rng.normal(0.0, 1.0, shape)
    fx = rng.uniform(0.0, 1.0, shape[:2]).astype(np.float32)
    fy = rng.uniform(0.0, 1.0, shape[:2]).astype(np.float32)
    if case == "wide":
        cc = (P - 2) // 2
        for b, k in np.ndindex(*shape[:2]):
            cy, cx = cc + int(fy[b, k] >= 0.5), cc + int(fx[b, k] >= 0.5)
            w[b, k, cy, cx - 7] = 2.0 ** 56
            w[b, k, cy, cx + 1] = 7.0 * 2.0 ** 56
    patch = torch.as_tensor(w.astype(np.float32)).to(torch.bfloat16).float()
    return patch, torch.as_tensor(fx), torch.as_tensor(fy)


@pytest.mark.parametrize("P", [32, 64])
@pytest.mark.parametrize("case", ["normal", "all_zero", "sign_mixed", "signed_zero", "wide"])
def test_k6_lane_moments_match_plain(case, P):
    patch, fx, fy = _k6_windows(case, P, seed=P + len(case))
    want = _moments_plain(patch, fx, fy)
    got = k6_lane_moments(patch, fx, fy)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if case == "wide":
        # the data tells the orders apart: another tree gives other bits
        other = k6_lane_moments(patch, fx, fy, tree=(1, 2, 4, 8))
        assert any(not torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(other, want))
        return
    old = _k6_rowmajor(patch, fx, fy)
    scale = max(float(old[0].abs().max()), float(old[1].abs().max()))
    for a, b in zip(got, old):
        assert float((a - b).abs().max()) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# K4 (csrc/moments.cu): a block stages the TH + 14 input rows of a TH x TW
# output tile (+0.0 past the frame), forms each row's sums once per (row,
# column, width) -- sx_0, (sx_w, hx_w) for w = 3..6 and hx_7, a negative dx
# subtracting |dx| * v -- and then accumulates each output's 27 band steps
# from +0.0 in BANDS order, skipping width 0's two +0.0 adds to m10. The
# emulation runs every tile at once and must equal moment_maps_plain bit
# for bit.

K4_TILE = (50, 16)  # (TH, TW) of csrc/moments.cu


def k4_tiles(padded, tile=K4_TILE):
    """(m10, m01) of a (B, Hp, Wp) bf16 batch as K4's blocks form them."""
    TH, TW = tile
    mr = 7
    B, Hp, Wp = padded.shape
    Hm, Wm = Hp - 2 * mr, Wp - 2 * mr
    nti, ntj = -(-Hm // TH), -(-Wm // TW)
    canvas = torch.zeros(B, nti * TH + 2 * mr, ntj * TW + 16)
    canvas[:, :Hp, :Wp] = padded.float()
    tiles = canvas.unfold(1, TH + 2 * mr, TH).unfold(2, TW + 16, TW)  # (B, ti, tj, RH, TW+16)

    def v(dx):
        return tiles[..., mr + dx: mr + dx + TW]

    def box(w):
        s = torch.zeros_like(v(0))
        for dx in range(-w, w + 1):
            s = s + v(dx)
        return s

    def moment(w):
        h = torch.zeros_like(v(0))
        for k in range(w, 0, -1):
            h = h - (v(-k) if k == 1 else float(k) * v(-k))
        for k in range(1, w + 1):
            h = h + (v(k) if k == 1 else float(k) * v(k))
        return h

    sx = {0: torch.zeros_like(v(0)) + v(0), **{w: box(w) for w in (3, 4, 5, 6)}}
    hx = {w: moment(w) for w in (3, 4, 5, 6, 7)}

    def row(s, dy):  # staged rows li + dy + 7 of the tile's TH output rows
        return s[..., mr + dy: mr + dy + TH, :]

    a10 = torch.zeros(B, nti, ntj, TH, TW)
    a01 = torch.zeros_like(a10)
    for w, dy in band_structure():
        if w:
            a10 = a10 + row(hx[w], dy)
        if dy:
            a01 = (a01.double() + float(dy) * row(sx[w], dy).double()).float()

    def assemble(m):
        return m.permute(0, 1, 3, 2, 4).reshape(B, nti * TH, ntj * TW)[:, :Hm, :Wm]

    return assemble(a10), assemble(a01)


def _k4_frames(case, shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 1.0, (3,) + shape).astype(np.float32)
    if case == "signed_zero":
        f = rng.choice([-0.0, 0.0, -1.5, 0.75], f.shape, p=[0.45, 0.45, 0.05, 0.05])
        f[1] = -0.0  # every tap -0.0
        f[2, : shape[0] // 2] = 0.0
    else:
        f[1, : shape[0] // 2, : shape[1] // 2] = 3.25  # a constant region
        f[2] *= 2.0 ** rng.integers(-20, 20, shape)
    return torch.as_tensor(f.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(15, 15), (37, 53), (151, 59)])
@pytest.mark.parametrize("case", ["normal", "signed_zero"])
def test_k4_tiles_match_plain(case, shape):
    """At 15x15 (a 1x1 map), 37x53, and 151x59: a map of 137x45, past
    two tiles on both axes with partial tiles."""
    padded = _k4_frames(case, shape, seed=shape[1] + len(case))
    want = moment_maps_plain(padded)
    got = k4_tiles(padded)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# ---------------------------------------------------------------------------
# K10 (csrc/patch3d.cu): a warp per keypoint marches its slab plane by plane
# and row by row; each yb (rows y, y + 1) and xb (columns x, x + 1) is
# formed once, the previous plane's xb waits for the z-lerp, and a keypoint
# whose slab lies inside the padded volume reads without clamps. Outputs
# go, in the run's order, to a ring of 2048 floats at slot (mis + p) & 2047
# (mis: the run's offset in floats from 16-byte alignment), and 16-byte
# pieces leave after every second plane ((8, 20)) or once 32 pieces wait
# (the general instantiation), whole pieces by bulk copy and the head and
# tail piece float by float. The emulation runs that march for every keypoint at once,
# with each run's alignment as a 16-byte-aligned output tensor gives it,
# must store every output exactly once and equal extract_blended_3d_plain
# bit for bit.

K10_RING = 2048  # floats of a warp's output ring in csrc/patch3d.cu
K10_SIZES = (8, 20)  # the (Pz, Pxy) of the template instantiation


def k10_march(padded, xyz, Pz, Pxy):
    """(B, K, Pz-1, Pxy-1, Pxy-1) float32 patches as K10's warps form them."""
    B, Dp, Hp, Wp = padded.shape
    K = xyz.shape[1]
    N = B * K
    Pb = Pxy - 1
    n_out = (Pz - 1) * Pb * Pb
    fl = torch.floor(xyz)
    frac = xyz - fl
    fx, fy, fz = (frac[..., i].reshape(N, 1) for i in range(3))
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    org = (fl.to(torch.int64) + 1).reshape(N, 3)
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    inside = ((ox >= 0) & (oy >= 0) & (oz >= 0) & (ox <= Wp - Pxy) & (oy <= Hp - Pxy)
              & (oz <= Dp - Pz))
    vol = padded.reshape(B, -1)
    bidx = torch.arange(B).repeat_interleave(K)

    def index(o, i, size):  # clamped only for keypoints outside
        r = o[:, None] + i
        c = r.clamp(0, size - 1)
        assert torch.equal(r[inside], c[inside])
        return torch.where(inside[:, None], r, c)

    cols = index(ox, torch.arange(Pxy), Wp)  # (N, Pxy)

    def plane(z):
        zz = index(oz, torch.tensor([z]), Dp)  # (N, 1)
        yy = index(oy, torch.arange(Pxy), Hp)  # (N, Pxy)
        flat = ((zz * Hp + yy)[:, :, None] * Wp + cols[:, None, :])
        return vol[bidx[:, None, None], flat]  # (N, Pxy rows, Pxy columns)

    mis = (torch.arange(N) * n_out) % 4  # the run's offset from 16-byte alignment
    ring = torch.full((N, K10_RING), float("nan"))
    out = torch.full((N, n_out), float("nan"))
    stores = torch.zeros((N, n_out), dtype=torch.int64)
    done, flushed = 0, torch.zeros(N, dtype=torch.int64)
    # the oldest ring position still needed: unflushed outputs, or the whole
    # pieces of the last flush, which the copy engine may still be reading
    # until the next flush waits for it
    held = torch.zeros(N, dtype=torch.int64)
    rows = torch.arange(N)[:, None]

    def flush(last, due=None):
        nonlocal flushed, held
        end = (mis + n_out + 3) // 4 if last else (mis + done) // 4
        if due is not None:  # the warps whose own test is due
            end = torch.where(due, end, flushed)
        v0 = torch.maximum(flushed, (mis + 3) // 4)
        v1 = torch.minimum(end, (mis + n_out) // 4)
        held = torch.where(end > flushed, 4 * torch.where(v1 > v0, v0, end), held)
        span = int((end - flushed).max()) * 4
        if span <= 0:
            return
        a = 4 * flushed[:, None] + torch.arange(span)
        ok = (a < 4 * end[:, None]) & (a >= mis[:, None]) & (a < (mis + n_out)[:, None])
        p = torch.where(ok, a - mis[:, None], 0)
        r = rows.expand_as(a)[ok]
        out[r, p[ok]] = ring[r, (a % K10_RING)[ok]]
        stores[r, p[ok]] += 1
        flushed = end

    cur = plane(0)
    xbp = [None] * Pb
    for z in range(Pz):
        nxt = plane(z + 1) if z + 1 < Pz else None
        for y in range(Pb):
            yb = _fma(fy, cur[:, y + 1], gy * cur[:, y])  # (N, Pxy)
            xb = _fma(gx, yb[:, :-1], fx * yb[:, 1:])  # (N, Pb)
            if z > 0:
                # the row's slots hold nothing still needed
                assert int((mis + done + Pb - held).max()) <= K10_RING
                slot = (mis[:, None] + done + torch.arange(Pb)) % K10_RING
                ring[rows, slot] = _fma(gz, xbp[y], fz * xb)
                done += Pb
                if (Pz, Pxy) == K10_SIZES:
                    if y == Pb - 1 and z % 2 == 0:
                        flush(False)
                else:
                    flush(False, due=(mis + done) // 4 - flushed >= 32)
            xbp[y] = xb
        cur = nxt
    flush(True)
    assert bool((stores == 1).all())  # every output stored exactly once
    return out.reshape(B, K, Pz - 1, Pb, Pb)


def _k10_case(Pz, Pxy, K, thin, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 5 if thin else 3 * Pz, 2 * Pxy + 3, 2 * Pxy + 7)
    vol = rng.normal(0.0, 10.0, shape).astype(np.float32)
    vol[1, :, : shape[2] // 2] = -0.0
    lo = -np.array([Pxy + 2.0, Pxy + 2.0, Pz + 2.0])
    hi = np.array([shape[3], shape[2], shape[1]]) + 2.0
    xyz = rng.uniform(lo, hi, (2, K, 3)).astype(np.float32)
    # a slab well inside, negative coordinates, and beyond each far edge
    xyz[0, 0] = [shape[3] / 2 - Pxy / 2, shape[2] / 2 - Pxy / 2, 0.25]
    xyz[0, -1] = [-3.5, -0.75, -1.5]
    xyz[1, -1] = [shape[3] - 1.25, shape[2] + 0.5, shape[1] - 0.5]
    return torch.as_tensor(vol), torch.as_tensor(xyz)


@pytest.mark.parametrize("thin", [False, True])
@pytest.mark.parametrize("K", [1, 13])
@pytest.mark.parametrize("Pz,Pxy", [(8, 20), (2, 2), (5, 13), (16, 33)])
def test_k10_march_matches_plain(Pz, Pxy, K, thin):
    """At the template size and three general ones, with clamped
    keypoints, an odd K and a volume thinner than a slab (Dp = 5)."""
    padded, xyz = _k10_case(Pz, Pxy, K, thin, seed=Pz * 100 + Pxy + K)
    want = extract_blended_3d_plain(padded, xyz, Pz, Pxy)
    got = k10_march(padded, xyz, Pz, Pxy)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
