"""On-card kernel parity selftest: `python -m kcmc_tpu_torch selftest`
(or `python -m kcmc_tpu_torch.selftest`), `--size` and `--depth` as the
reference's.

The CPU test suite runs every wrapper's plain PyTorch version (a CUDA
kernel has no interpret mode), which validates the arithmetic but not
the kernels. This module runs each hand-written kernel (K1-K11) on the
card against its plain version on the same card tensors, at production
sizes (by default 512x512 and 2304x2304 frames, K=4096 for the
bins-first route, 32x256x256 volumes; `--size S --depth D` runs S x S
frames and D x S/2 x S/2 volumes), with the comparison `chip_smoke.py`
uses for it: `torch.equal`, or equality through `view(torch.int32)` /
`view(torch.int16)` where the plain version is bit-identical, and for
K3 the relative 1e-5 with equal ok flags. The warps are also held against
the exact gather on the frames they keep, the Hamming match against
XOR + popcount (a matmul that silently ran in TF32 would flip distance
bits), and one rigid end-to-end run with `warp="auto"` against the
gather warp.

Each check returns a record {name, ok, detail}; the entry point prints
one line per check on stderr and only the JSON summary on stdout, and
exits non-zero on any failure. It needs a CUDA card and raises without
one: there is no CPU fallback. The reference's `shard_map` check waits for the port's
multi-device runs (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

import numpy as np
import torch

CARD = "cuda"
TOL = 1e-5  # K3's relative tolerance against its plain version


def _scene(shape, seed=3, n=2, n_blobs=None, sigma_range=(1.0, 2.5)) -> torch.Tensor:
    from kcmc_tpu_torch.utils.synthetic import render_scene

    rng = np.random.default_rng(seed)
    if n_blobs is None:
        n_blobs = max(80, int(np.prod(shape)) // 650)
    stack = np.stack([render_scene(rng, shape, n_blobs=n_blobs, sigma_range=sigma_range)
                      for _ in range(n)]).astype(np.float32)
    return torch.as_tensor(stack, device=CARD).contiguous()


def _record(name, ok, detail) -> dict:
    return {"name": name, "ok": bool(ok), "detail": detail}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _padded(frames, K, radius, **detect_kw):
    """Keypoints of `frames` and the centred bf16 blur padded for the
    describe route's patches (the path's own inputs to K2, K4 and K6)."""
    from kcmc_tpu_torch.ops.describe import edge_pad
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch

    kps, smooth = detect_keypoints_batch(frames, max_keypoints=K, threshold=1e-4,
                                         smooth_sigma=2.0, **detect_kw)
    mu = smooth.mean(dim=(1, 2), keepdim=True)
    return kps, edge_pad((smooth - mu).to(torch.bfloat16), radius + 1).contiguous()


def _check_k1(shape, n):
    from kcmc_tpu_torch.ops.cuda_detect import detect_response, detect_response_plain

    frames = _scene(shape, n=n)
    got = detect_response(frames, smooth_sigma=2.0)
    want = detect_response_plain(frames, smooth_sigma=2.0)
    eq = {f: torch.equal(g, w) for f, g, w in zip(("nms", "ox", "oy", "smooth"), got, want)}
    return _record(f"K1 detect_response {shape[0]}x{shape[1]}", all(eq.values()),
                   f"B={n} field_equal={eq}")


def _check_k2(size=512, K=512):
    from kcmc_tpu_torch.ops.cuda_patch import extract_blended, extract_blended_plain
    from kcmc_tpu_torch.ops.patterns import PATCH_RADIUS

    P = 2 * PATCH_RADIUS + 2
    kps, padded = _padded(_scene((size, size), seed=7), K, PATCH_RADIUS)
    xy = kps.xy.contiguous()
    ok = _bits_equal(extract_blended(padded, xy, P), extract_blended_plain(padded, xy, P))
    return _record("K2 extract_blended upright", ok,
                   f"{size}x{size} K={K} P={P} bit_equal={ok}")


def _check_k6(size=512, K=512):
    from kcmc_tpu_torch.ops.cuda_patch import extract_blended, extract_blended_plain
    from kcmc_tpu_torch.ops.patterns import ROT_RADIUS

    P = 2 * ROT_RADIUS + 2
    kps, padded = _padded(_scene((size, size), seed=7), K, ROT_RADIUS)
    xy = kps.xy.contiguous()
    got = extract_blended(padded, xy, P, with_moments=True)
    want = extract_blended_plain(padded, xy, P, with_moments=True)
    eq = [_bits_equal(g, w) for g, w in zip(got, want)]
    same_as_k2 = _bits_equal(got[0], extract_blended(padded, xy, P))
    return _record("K6 extract_blended_moments small-K oriented", all(eq) and same_as_k2,
                   f"{size}x{size} K={K} patches/m10/m01 bit_equal={eq} "
                   f"patches_equal_k2={same_as_k2}")


def _bins_first_inputs(K=4096):
    """The bins-first route's K4 input and K5 operands on a dense 512²
    scene (config 2's detection parameters)."""
    from kcmc_tpu_torch.ops import cuda_patch
    from kcmc_tpu_torch.ops import describe as D
    from kcmc_tpu_torch.ops.patterns import N_ORIENT_BINS, ROT_RADIUS

    r = ROT_RADIUS
    P = 2 * r + 2
    frames = _scene((512, 512), seed=0, n=4, n_blobs=12000, sigma_range=(0.7, 1.4))
    kps, padded = _padded(frames, K, r, nms_size=3, window_sigma=1.2, cand_tile=4)
    m10, m01 = D._moments_at_keypoints(padded, kps.xy, r)
    bins = D._quantize_bins(torch.atan2(m01, m10))
    keys = torch.where(kps.valid, bins, torch.full_like(bins, N_ORIENT_BINS))
    src, _, aends = D._aligned_runs(keys, N_ORIENT_BINS + 1, D.RUN_ALIGN)
    B, Kp = src.shape
    safe = torch.clamp(src, max=K - 1)
    xy_s = torch.gather(kps.xy, 1, safe[..., None].expand(B, Kp, 2))
    xy_s = torch.where((src < K)[..., None], xy_s, torch.zeros((), device=CARD)).contiguous()
    flat = cuda_patch.extract_blended(padded, xy_s, P).reshape(B, Kp, -1).contiguous()
    s_blk = (torch.arange(Kp // D.RUN_ALIGN, device=CARD) * D.RUN_ALIGN).expand(B, -1)
    ibin = torch.searchsorted(aends, s_blk.contiguous(), side="right").to(torch.int32)
    return padded, flat, ibin.contiguous(), D.sel_rot(CARD), int(kps.valid.sum())


def _check_k4_k5(K=4096):
    from kcmc_tpu_torch.ops import cuda_moments, cuda_select
    from kcmc_tpu_torch.ops.describe import RUN_ALIGN

    padded, flat, ibin, sel, n_valid = _bins_first_inputs(K)
    k4 = all(_bits_equal(g, w) for g, w in zip(cuda_moments.moment_maps(padded),
                                              cuda_moments.moment_maps_plain(padded)))
    k5 = _bits_equal(cuda_select.binned_select_rows(flat, ibin, sel, RUN_ALIGN),
                     cuda_select.binned_select_rows_plain(flat, ibin, sel, RUN_ALIGN))
    shape = f"B={padded.shape[0]} K={K} valid={n_valid} Kp={flat.shape[1]}"
    return [_record("K4 moment_maps bins-first", k4, f"{shape} bit_equal={k4}"),
            _record("K5 binned_select_rows bins-first", k5, f"{shape} bit_equal={k5}")]


def _check_k3(size=512):
    from kcmc_tpu_torch.ops.cuda_warp import warp_translation, warp_translation_plain
    from kcmc_tpu_torch.ops.warp import warp_batch

    img = _scene((size, size), seed=5, n=1)[0]
    shifts = [(0.0, 0.0), (3.0, -2.0), (2.5, 1.25), (-20.25, 30.5), (140.5, 0.0)]
    M = torch.eye(3, device=CARD).repeat(len(shifts), 1, 1)
    M[:, 0, 2] = torch.tensor([s[0] for s in shifts])
    M[:, 1, 2] = torch.tensor([s[1] for s in shifts])
    frames = img.expand(len(shifts), -1, -1).contiguous()
    out, ok = warp_translation(frames, M.contiguous())
    ref, ref_ok = warp_translation_plain(frames, M.contiguous())
    e_plain = float((out - ref).abs().max())
    gather = warp_batch(frames, M)
    e_gather = float((out - gather)[ok].abs().max())
    good = (e_plain <= TOL * float(ref.abs().max()) and torch.equal(ok, ref_ok)
            and bool(ok[:4].all()) and not bool(ok[4]) and e_gather < 1e-5)
    return _record("K3 warp_translation", good,
                   f"max|d| plain={e_plain:.2e} gather(kept)={e_gather:.2e} "
                   f"ok={ok.tolist()}")


def _check_k7(size=512):
    from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix, warp_batch_matrix_plain
    from kcmc_tpu_torch.ops.warp import warp_batch

    img = _scene((size, size), seed=23, n=1)[0]
    c = (size - 1) / 2.0
    th = 0.03
    co, si = np.cos(th), np.sin(th)
    A = np.eye(3, dtype=np.float32)
    A[:2, :2] = [[co * 1.015, -si], [si, co * 0.99]]
    A[:2, 2] = [3.3 + c - A[0, 0] * c + si * c, -2.7 + c - si * c - A[1, 1] * c]
    Pm = A.copy()
    Pm[2, 0], Pm[2, 1] = 1.5e-5, -1e-5
    recs = []
    for kind, Mn in (("affine", A), ("projective", Pm)):
        M = torch.as_tensor(np.stack([Mn, Mn]), device=CARD).contiguous()
        frames = img.expand(2, -1, -1).contiguous()
        out, ok = warp_batch_matrix(frames, M, max_px=16)
        ref, ref_ok = warp_batch_matrix_plain(frames, M, 16)
        bits = torch.equal(out, ref) and torch.equal(ok, ref_ok)
        d = (out - warp_batch(frames, M))[ok][:, 16:-16, 16:-16].abs()
        dmax, rms = float(d.max()), float(d.pow(2).mean().sqrt())
        good = bits and bool(ok.all()) and dmax < 5e-3 and rms < 3e-4
        recs.append(_record(f"K7 warp_batch_matrix {kind}", good,
                            f"bit_equal={bits} gather(kept) max={dmax:.2e} rms={rms:.2e}"))
    return recs


def _check_k8(size=512):
    from kcmc_tpu_torch.ops.cuda_warp_field import warp_batch_field, warp_batch_field_plain
    from kcmc_tpu_torch.ops.piecewise import upsample_field
    from kcmc_tpu_torch.ops.warp import warp_frame_flow

    img = _scene((size, size), seed=13, n=1)[0]
    rng = np.random.default_rng(1)
    fields = np.stack([rng.uniform(-2.5, 2.5, (8, 8, 2)).astype(np.float32)
                       + np.asarray(t, np.float32)
                       for t in ((0, 0), (4.7, -3.1), (-9.4, 6.2))])
    fields = torch.as_tensor(fields, device=CARD).contiguous()
    frames = img.expand(3, -1, -1).contiguous()
    out, ok = warp_batch_field(frames, fields, max_px=6)
    ref, ref_ok = warp_batch_field_plain(frames, fields, 6)
    bits = torch.equal(out, ref) and torch.equal(ok, ref_ok)
    d = (out - warp_frame_flow(frames, upsample_field(fields, (size, size))))[ok].abs()
    good = bits and bool(ok.all()) and float(d.mean()) < 2e-4 and float(d.max()) < 0.02
    return _record("K8 warp_batch_field", good,
                   f"bit_equal={bits} gather(kept) mean={float(d.mean()):.2e} "
                   f"max={float(d.max()):.2e}")


def _check_k9_k10(shape3d=(32, 256, 256), K=512):
    from kcmc_tpu_torch.ops.cuda_detect3d import response_fields_3d, response_fields_3d_plain
    from kcmc_tpu_torch.ops.cuda_patch3d import extract_blended_3d, extract_blended_3d_plain
    from kcmc_tpu_torch.ops.describe3d import PXY, PZ, edge_pad_3d
    from kcmc_tpu_torch.ops.detect3d import detect_keypoints_3d_batch

    vols = _scene(shape3d, seed=15, n=2)
    k9 = [_bits_equal(g, w) for g, w in zip(response_fields_3d(vols, smooth_sigma=2.0),
                                           response_fields_3d_plain(vols, smooth_sigma=2.0))]
    kps, smooth = detect_keypoints_3d_batch(vols, max_keypoints=K, border=8, smooth_sigma=2.0)
    padded = edge_pad_3d(smooth).contiguous()
    xyz = kps.xy.contiguous()
    k10 = _bits_equal(extract_blended_3d(padded, xyz, PZ, PXY),
                      extract_blended_3d_plain(padded, xyz, PZ, PXY))
    dims = "x".join(map(str, shape3d))
    return [_record(f"K9 response_fields_3d {dims}", all(k9),
                    f"B=2 response/blur bit_equal={k9}"),
            _record(f"K10 extract_blended_3d {dims}", k10,
                    f"K={K} valid={int(kps.valid.sum())} Pz={PZ} Pxy={PXY} bit_equal={k10}")]


def _check_k11(size=512, K=512):
    from kcmc_tpu_torch.ops.cuda_patch import extract_patches, extract_patches_plain
    from kcmc_tpu_torch.ops.describe import edge_pad
    from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
    from kcmc_tpu_torch.ops.patterns import PATCH_RADIUS

    P = 2 * PATCH_RADIUS + 2
    frames = _scene((size, size), seed=7)
    kps, smooth = detect_keypoints_batch(frames, max_keypoints=K, threshold=1e-4,
                                         smooth_sigma=2.0)
    padded = edge_pad(smooth, PATCH_RADIUS + 1).contiguous()
    org = torch.floor(kps.xy).to(torch.int32) + 1
    oy, ox = org[..., 1].contiguous(), org[..., 0].contiguous()
    ok = torch.equal(extract_patches(padded, oy, ox, P), extract_patches_plain(padded, oy, ox, P))
    return _record("K11 extract_patches", ok, f"{size}x{size} K={K} P={P} equal={ok}")


def _check_match(K=4096):
    """The port's match (float32 ±1 matmul Hamming, then the 2-NN
    selection) against the same selection on XOR + popcount distances,
    with half the queries planted a few bits from a reference
    descriptor so the ratio and mutual tests select for real."""
    from kcmc_tpu_torch.ops.match import BIG, N_BITS, hamming_matrix, knn_match_impl

    rng = np.random.default_rng(17)
    q_h = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    r_h = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    perm = rng.permutation(K)[: K // 2]
    noise = np.zeros((K // 2, 8), np.uint32)
    flips = rng.integers(0, 256, size=(K // 2, 6))
    np.bitwise_or.at(noise, (np.arange(K // 2)[:, None].repeat(6, 1), flips // 32),
                     np.uint32(1) << (flips % 32).astype(np.uint32))
    q_h[: K // 2] = r_h[perm] ^ noise
    q = torch.as_tensor(q_h.astype(np.int64), device=CARD)
    r = torch.as_tensor(r_h.astype(np.int64), device=CARD)
    qv = torch.as_tensor(rng.uniform(size=K) < 0.95, device=CARD)
    rv = torch.as_tensor(rng.uniform(size=K) < 0.95, device=CARD)
    got = knn_match_impl(q, r, qv, rv, ratio=0.85, max_dist=80, mutual=True)

    qv2 = qv & torch.any(q != 0, dim=-1)
    rv2 = rv & torch.any(r != 0, dim=-1)
    Di = hamming_matrix(q, r, qv2, rv2)
    best, idx = Di.amin(dim=-1), torch.argmin(Di, dim=-1)
    second = Di.scatter(-1, idx[:, None], BIG).amin(dim=-1)
    ok = (best < 80) & (best.float() < torch.tensor(0.85, device=CARD) * second.float())
    ok = ok & (torch.argmin(Di, dim=0)[idx] == torch.arange(K, device=CARD))
    ok = ok & qv2 & (best < N_BITS + 1)
    eq = {"idx": torch.equal(got.idx, idx), "dist": torch.equal(got.dist, best),
          "second": torch.equal(got.second, second), "valid": torch.equal(got.valid, ok)}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    return _record("match hamming_mm vs xor_popcount", all(eq.values()) and not tf32,
                   f"K={K} field_eq={eq} n_valid={int(got.valid.sum())} allow_tf32={tf32}")


def _check_pipeline(size=512):
    """One rigid run with warp="auto" (K1, K6, K7) against warp="jnp"
    (the gather): the polish reads warped pixels, so the two agree to
    the kernels' ~1e-4-px pixel agreement, not by bits."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    data = make_drift_stack(n_frames=8, shape=(size, size), model="rigid", max_drift=6.0,
                            seed=21)
    fast = MotionCorrector(model="rigid", batch_size=8, warp="auto").correct(data.stack)
    exact = MotionCorrector(model="rigid", batch_size=8, warp="jnp").correct(data.stack)
    dt = float(np.abs(fast.transforms - exact.transforms).max())
    d = np.abs(fast.corrected - exact.corrected)[:, 16:-16, 16:-16]
    return _record("pipeline rigid auto vs gather warp", dt < 1e-3 and float(d.mean()) < 5e-3,
                   f"max|dT|={dt:.2e} mean|dframe|={d.mean():.2e}")


# (name, check): names are stable across runs, so a check that raises
# keeps its identity in the summary; a check may return several records.
# `size` sets the 2D frames of the size-parameterized checks and
# `size3d` the volumes; the 2304x2304 K1 check and the bins-first K4/K5
# and match checks keep their production shapes.
def checks(size: int = 512, size3d=(32, 256, 256)) -> list:
    vol = "x".join(str(s) for s in size3d)
    return [
        (f"K1 detect_response {size}x{size}", lambda: _check_k1((size, size), 2)),
        ("K1 detect_response 2304x2304", lambda: _check_k1((2304, 2304), 1)),
        ("K2 extract_blended upright", lambda: _check_k2(size)),
        ("K6 extract_blended_moments small-K oriented", lambda: _check_k6(size)),
        ("K4 moment_maps + K5 binned_select_rows bins-first", _check_k4_k5),
        ("K3 warp_translation", lambda: _check_k3(size)),
        ("K7 warp_batch_matrix", lambda: _check_k7(size)),
        ("K8 warp_batch_field", lambda: _check_k8(size)),
        (f"K9 response_fields_3d + K10 extract_blended_3d {vol}",
         lambda: _check_k9_k10(tuple(size3d))),
        ("K11 extract_patches", lambda: _check_k11(size)),
        ("match hamming_mm vs xor_popcount", _check_match),
        ("pipeline rigid auto vs gather warp", lambda: _check_pipeline(size)),
    ]


def run_selftest(size: int = 512, size3d=(32, 256, 256)) -> list[dict]:
    """Every check on the card at `size`² frames and `size3d` volumes: a
    list of records {name, ok, detail}. Raises without a CUDA card (no
    CPU fallback)."""
    from kcmc_tpu_torch.utils.device import set_full_precision

    if not torch.cuda.is_available():
        raise RuntimeError("kcmc_tpu_torch.selftest needs a CUDA card: it holds each "
                           "hand-written kernel against its plain version on the card")
    set_full_precision()  # as TorchBackend sets it for every run on the card
    results = []
    for name, check in checks(size, size3d):
        try:
            got = check()
        except Exception as e:  # a kernel that fails to build or launch fails its check
            got = _record(name, False, f"EXCEPTION: {e!r}")
        results.extend(got if isinstance(got, list) else [got])
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    """`--size` / `--depth` as the reference's selftest takes them; one
    line per check on stderr, only the JSON summary on stdout."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(prog="python -m kcmc_tpu_torch selftest",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--depth", type=int, default=32, help="3D stack depth")
    args = ap.parse_args(argv)
    results = run_selftest(size=args.size,
                           size3d=(args.depth, args.size // 2, args.size // 2))
    name = torch.cuda.get_device_name(0)
    print(f"[selftest] platform=gpu device={name}", file=sys.stderr)
    for r in results:
        print(f"[selftest] {'PASS' if r['ok'] else 'FAIL'} {r['name']}: {r['detail']}",
              file=sys.stderr)
    n_fail = sum(not r["ok"] for r in results)
    print(json.dumps({"device": name, "platform": "gpu",
                      "passed": len(results) - n_fail, "failed": n_fail,
                      "results": results}))
    return 1 if n_fail else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
