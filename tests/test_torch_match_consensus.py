"""Matching and consensus in the PyTorch port against kcmc_tpu: the
threefry PRNG bit for bit, the Hamming 2-NN match exactly, and the
batched RANSAC with identical inlier counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.models.transforms import get_model as j_get_model
from kcmc_tpu.ops import match as jmatch
from kcmc_tpu.ops.fused import fused_match_consensus as j_fused
from kcmc_tpu.ops.ransac import consensus_batch as j_consensus
from kcmc_tpu_torch.models.transforms import get_model as t_get_model
from kcmc_tpu_torch.ops import match as tmatch
from kcmc_tpu_torch.ops.fused import fused_match_consensus as t_fused
from kcmc_tpu_torch.ops.ransac import consensus_batch as t_consensus
from kcmc_tpu_torch.utils import prng


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 123456789])
def test_prng_key_fold_in_uniform_bit_exact(seed):
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jk)).astype(np.int64), tk.numpy()
    )
    idx = np.array([0, 1, 31, 999, 65536, 2**31 - 1], np.int32)
    jf = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(idx))
    tf = prng.fold_in(tk, torch.as_tensor(idx))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jf)).astype(np.int64), tf.numpy()
    )
    for i, h, n in ((0, 0, 1), (5, 3, 37), (999, 127, 512)):
        ju = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(jk, i), h), (n,))
        tu = prng.uniform(prng.fold_in(prng.fold_in(tk, i), h), n)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def _descriptor_case(seed=0, Kr=64, Kq=48):
    """Reference descriptors with a duplicated row (argmin ties), query
    descriptors as noisy copies, random strangers and all-zero rows."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 2**32, (Kr, 8), dtype=np.uint64).astype(np.uint32)
    ref[5] = ref[4]
    ref_valid = np.ones(Kr, bool)
    ref_valid[-3:] = False
    ref[-1] = 0
    src = rng.integers(0, Kr, Kq)
    q = ref[src].copy()
    flips = rng.integers(0, 2, (Kq, 8, 32)).astype(bool) & (
        rng.uniform(size=(Kq, 8, 32)) < rng.uniform(0.0, 0.25, (Kq, 1, 1))
    )
    q ^= np.packbits(flips[..., ::-1], axis=-1, bitorder="big").view(">u4")[..., 0].astype(np.uint32)
    q[-6:-3] = rng.integers(0, 2**32, (3, 8), dtype=np.uint64).astype(np.uint32)
    q[-3:-1] = 0
    q_valid = np.ones(Kq, bool)
    q_valid[-1] = False
    return q, ref, q_valid, ref_valid


def _t64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_hamming_mm_matches_xor_popcount_oracles():
    q, ref, qv, rv = _descriptor_case()
    want = np.asarray(jmatch.hamming_matrix(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(qv), jnp.asarray(rv)
    )).astype(np.int64)
    want = np.where(want > 256, tmatch.BIG, want)
    oracle = tmatch.hamming_matrix(_t64(q), _t64(ref), torch.as_tensor(qv), torch.as_tensor(rv))
    mm = tmatch.hamming_matrix_mm(_t64(q), _t64(ref), torch.as_tensor(qv), torch.as_tensor(rv))
    np.testing.assert_array_equal(want, oracle.numpy())
    np.testing.assert_array_equal(want, mm.numpy())


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_knn_match_identical(seed, mutual):
    q, ref, qv, rv = _descriptor_case(seed)
    want = jmatch.knn_match(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(qv), jnp.asarray(rv),
        ratio=0.85, max_dist=80, mutual=mutual,
    )
    got = tmatch.knn_match_impl(
        _t64(q), _t64(ref), torch.as_tensor(qv), torch.as_tensor(rv),
        ratio=0.85, max_dist=80, mutual=mutual,
    )
    for name in ("idx", "dist", "second", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name)), getattr(got, name).numpy(), err_msg=name
        )
    assert got.valid.any() and not got.valid.all()


def _match_case(B=4, N=64, seed=0):
    """Correspondences: inliers displaced by a per-frame shift plus
    noise, outliers uniform; frame 2 has too few matches to arm early
    exit, frame 3 none at all."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 128, (B, N, 2)).astype(np.float32)
    t = rng.uniform(-12, 12, (B, 1, 2)).astype(np.float32)
    dst = src + t + rng.normal(0, 0.4, (B, N, 2)).astype(np.float32)
    out = rng.uniform(size=(B, N)) < 0.3
    dst[out] = rng.uniform(0, 128, (int(out.sum()), 2)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.85
    valid[2, 20:] = False
    valid[3] = False
    return src, dst.astype(np.float32), valid


@pytest.mark.parametrize(
    "rungs,cap,N",
    [(4, 512, 64), (0, 0, 64), (4, 32, 96), (0, 32, 96), (3, 0, 50)],
)
def test_consensus_batch_identical(rungs, cap, N):
    src, dst, valid = _match_case(N=N)
    B = src.shape[0]
    idx = np.arange(100, 100 + B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx))
    tkeys = prng.fold_in(prng.key(0), torch.as_tensor(idx))
    kw = dict(n_hypotheses=40, threshold=2.0, refine_iters=2, score_cap=cap,
              budget_rungs=rungs, early_exit_frac=0.7)
    want = j_consensus(
        j_get_model("translation"), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(valid), jkeys, **kw,
    )
    got = t_consensus(
        t_get_model("translation"), torch.as_tensor(src), torch.as_tensor(dst),
        torch.as_tensor(valid), tkeys, **kw,
    )
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_array_equal(np.asarray(want.inlier_mask), got.inlier_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.transform), got.transform.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(want.rms_residual), got.rms_residual.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.transform.numpy()[3], np.eye(3, dtype=np.float32))


def test_fused_match_consensus_identical():
    """Match + consensus together: frame descriptors are permuted noisy
    copies of the reference's at shifted positions."""
    rng = np.random.default_rng(5)
    q, ref, qv, rv = _descriptor_case(seed=3, Kr=64, Kq=64)
    ref_xy = rng.uniform(16, 112, (64, 2)).astype(np.float32)
    B = 3
    perm = np.stack([rng.permutation(64) for _ in range(B)])
    desc = np.stack([ref[p] for p in perm])
    desc[:, ::7] ^= np.uint32(0x00FF00FF)
    shift = rng.uniform(-8, 8, (B, 1, 2)).astype(np.float32)
    kp_xy = (ref_xy[perm] + shift + rng.normal(0, 0.3, (B, 64, 2))).astype(np.float32)
    kp_valid = np.ones((B, 64), bool)
    idx = np.arange(B, dtype=np.int32)
    kw = dict(ratio=0.85, max_dist=80, mutual=True, n_hypotheses=32,
              threshold=2.0, refine_iters=2, score_cap=512, budget_rungs=4,
              early_exit_frac=0.7)
    want, wn = j_fused(
        j_get_model("translation"), jnp.asarray(desc), jnp.asarray(kp_xy),
        jnp.asarray(kp_valid), jnp.asarray(ref), jnp.asarray(ref_xy),
        jnp.asarray(rv),
        jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx)),
        **kw,
    )
    got, gn = t_fused(
        t_get_model("translation"), _t64(desc), torch.as_tensor(kp_xy),
        torch.as_tensor(kp_valid), _t64(ref), torch.as_tensor(ref_xy),
        torch.as_tensor(rv), prng.fold_in(prng.key(0), torch.as_tensor(idx)), **kw,
    )
    np.testing.assert_array_equal(np.asarray(wn), gn.numpy())
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_allclose(np.asarray(want.transform), got.transform.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.transform.numpy()[:, :2, 2], shift[:, 0], atol=0.2)


def test_translation_solver_guard_matches():
    """Zero weight mass and duplicated minimal samples: the guarded
    solve returns what the reference returns."""
    src = np.array([[[1.0, 2.0], [1.0, 2.0]], [[3.0, 4.0], [5.0, 6.0]]], np.float32)
    dst = src + np.float32(1.5)
    w = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    jm = j_get_model("translation")
    want = np.stack([np.asarray(jm.solve(jnp.asarray(s), jnp.asarray(d), jnp.asarray(ww)))
                     for s, d, ww in zip(src, dst, w)])
    got = t_get_model("translation").solve(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w)
    ).numpy()
    np.testing.assert_array_equal(want, got)


def test_other_models_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_get_model("affine")
