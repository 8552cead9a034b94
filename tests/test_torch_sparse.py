"""pydnmfk_tpu_torch.ops.sparse (the triplet format, its products, the
sparse error identities and the format policy) against pydnmfk_tpu.ops.sparse
and linalg on BCOO, on the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6 at f32 for the products (summation order
of the scatter-adds); rtol 1e-4 for the error identities at f32, whose
||A||^2 - 2<A, WH> + ||WH||^2 cancels about one digit; exact for the index
arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from _parity import np_, x64
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.ops import sparse as js
from pydnmfk_tpu.utils.io import DataReader as JaxReader
from pydnmfk_tpu_torch.ops import linalg as tl
from pydnmfk_tpu_torch.ops import sparse as ts
from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
from pydnmfk_tpu_torch.utils.io import DataReader

TOL = dict(rtol=1e-5, atol=1e-6)
EPS = 1.19e-7


def lowrank(m, n, k, density, seed, dtype=np.float32):
    """(dense A, JAX BCOO, port triplet) of a masked rank-k matrix."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, k)) @ rng.random((k, n))).astype(dtype)
    A = A * (rng.random((m, n)) < density)
    B = jsparse.BCOO.fromdense(jnp.asarray(A))
    rows, cols = np.nonzero(A)
    return A, B, sparse_from_numpy(rows, cols, A[rows, cols], A.shape)


def _factors(seed, m, n, k, b=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    return (rng.random(lead + (m, k)).astype(dtype),
            rng.random(lead + (k, n)).astype(dtype))


def test_triplet_is_the_canonical_bcoo():
    _, B, T = lowrank(40, 30, 3, 0.3, 0)
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(B.indices[:, 0]))
    np.testing.assert_array_equal(T.cols.numpy(), np.asarray(B.indices[:, 1]))
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(B.data))
    assert T.rows.dtype == torch.int32 and T.nse == B.nse


def test_from_coo_sorts_and_sums_duplicates():
    rows = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    cols = torch.tensor([1, 3, 1, 0, 0], dtype=torch.int32)
    T = ts.from_coo(rows, cols, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), (3, 4))
    assert T.rows.tolist() == [0, 0, 1, 2] and T.cols.tolist() == [0, 3, 0, 1]
    assert T.data.tolist() == [5.0, 2.0, 4.0, 4.0]


@pytest.mark.parametrize("chunk", [0, 100])
def test_triplet_products_match_jax(chunk):
    _, B, T = lowrank(50, 36, 3, 0.25, 1)
    W, H = _factors(2, 50, 36, 4)
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    rows, cols = B.indices[:, 0], B.indices[:, 1]
    pairs = [
        (ts.a_ht_triplet(T, Ht, chunk), js.a_ht_bcoo(B, Hj, chunk)),
        (ts.wt_a_triplet(T, Wt, chunk), js.wt_a_bcoo(B, Wj, chunk)),
        (ts.kl_uht_sparse(T, Wt, Ht, EPS, chunk),
         js.kl_uht_sparse(B, Wj, Hj, EPS, chunk)),
        (ts.kl_wtu_sparse(T, Wt, Ht, EPS, chunk),
         js.kl_wtu_sparse(B, Wj, Hj, EPS, chunk)),
        (ts.sddmm(Wt, Ht, T.rows, T.cols, chunk),
         js.sddmm(Wj, Hj, rows, cols, chunk)),
        (ts.col_sqsum(T.data, T.cols, 36), js.col_sqsum(B.data, cols, 36)),
    ]
    for out, ref in pairs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(np_(out), np_(ref), **TOL)


def test_member_stack_matches_each_member():
    """A (3, nnz) data stack over shared indices, with per-member factors,
    against JAX on each member's BCOO."""
    _, B, T = lowrank(30, 24, 2, 0.3, 3)
    rng = np.random.default_rng(4)
    data = (np.asarray(B.data)[None] * (1 + rng.random((3, B.nse)))).astype(
        np.float32)
    W, H = _factors(5, 30, 24, 3, b=3)
    S = T.with_data(torch.from_numpy(data))
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    outs = (ts.a_ht_triplet(S, Ht), ts.wt_a_triplet(S, Wt),
            ts.kl_uht_sparse(S, Wt, Ht, EPS), ts.kl_wtu_sparse(S, Wt, Ht, EPS),
            tl.relative_error(S, Wt, Ht))
    for i in range(3):
        Bi = jsparse.BCOO((jnp.asarray(data[i]), B.indices), shape=B.shape)
        Wj, Hj = jnp.asarray(W[i]), jnp.asarray(H[i])
        refs = (js.a_ht_bcoo(Bi, Hj), js.wt_a_bcoo(Bi, Wj),
                js.kl_uht_sparse(Bi, Wj, Hj, EPS),
                js.kl_wtu_sparse(Bi, Wj, Hj, EPS),
                jl.relative_error(Bi, Wj, Hj))
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(np_(out[i]), np_(ref), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_error_identities_match_jax(dtype):
    A, _, T = lowrank(60, 40, 3, 0.2, 6, dtype)
    W, H = _factors(7, 60, 40, 5, dtype=dtype)
    rtol = 1e-4 if dtype == np.float32 else 1e-10
    with x64():
        B = jsparse.BCOO.fromdense(jnp.asarray(A))
        Wj, Hj = jnp.asarray(W), jnp.asarray(H)
        ref_err = np_(jl.relative_error(B, Wj, Hj))
        ref_col = np_(jl.column_error(B, Wj, Hj))
        ref_sq = np_(jl.sqnorm(B))
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    np.testing.assert_allclose(np_(tl.relative_error(T, Wt, Ht)), ref_err,
                               rtol=rtol)
    np.testing.assert_allclose(np_(tl.column_error(T, Wt, Ht)), ref_col,
                               rtol=rtol, atol=rtol * 1e-2)
    np.testing.assert_allclose(np_(tl.sqnorm(T)), ref_sq, rtol=rtol)
    # and both against the dense residual
    dense = np.linalg.norm(A - W @ H) / np.linalg.norm(A)
    np.testing.assert_allclose(float(tl.relative_error(T, Wt, Ht)), dense,
                               rtol=rtol)


def test_format_ladder_cuda_branch():
    """The format policy's CUDA branch, without a card (a pure function of
    the shapes): 80 GB card, budget 0.45 of it."""
    budget = ts.BUDGET_FRAC * 80e9
    assert budget == 0.45 * 80e9
    # NYTimes bag of words, k = 32: dense f32 123 GB and bf16 61.6 GB exceed
    # the budget; the time model prefers ELL, and ELL is also the fallback
    assert ts.format_ladder(300_000, 102_660, 69_679_427, 32, 4, budget,
                            "cuda") == ("ell", "ell_beyond")
    # the planted topic matrix of chip_smoke.py: dense f32 40 GB does not
    # fit, bf16 would, but the time model picks ELL first
    assert ts.format_ladder(200_000, 50_000, 10_000_000, 7, 4, budget,
                            "cuda")[0] == "ell"
    # density 0.75, past the crossover near 0.41: the dense kernels win, and
    # f32 fits
    assert ts.format_ladder(2000, 2000, 3_000_000, 32, 4, budget,
                            "cuda") == ("dense",)
    # density 0.25: the gather path wins even where the dense A fits
    assert ts.format_ladder(2000, 2000, 1_000_000, 32, 4, budget,
                            "cuda") == ("ell", "dense")
    # dense kernels preferred, only bf16 fits: the ladder narrows to bf16
    assert ts.format_ladder(2000, 2000, 3_000_000, 32, 4, 2000 * 2000 * 3,
                            "cuda") == ("dense_bf16",)
    # dense kernels preferred, nothing dense fits: ELL is the last step
    # (densify raises if ell_pack refuses it too)
    assert ts.format_ladder(2000, 2000, 3_000_000, 32, 4, 100,
                            "cuda") == ("ell_beyond",)
    # a bf16 A that does not fit has no narrower dense step
    assert ts.format_ladder(2000, 2000, 3_000_000, 32, 2, 100,
                            "cuda") == ("ell_beyond",)
    assert ts.format_ladder(2000, 2000, 10, 32, 4, budget, "cpu") == (
        "triplet",)


def test_densify_keeps_cpu_triplets_and_committed_formats():
    A, _, T = lowrank(20, 12, 2, 0.4, 8)
    assert ts.densify_for_backend(T) is T
    dense = torch.from_numpy(A)
    assert ts.densify_for_backend(dense) is dense
    assert np.array_equal(ts._densify(T, torch.float32).numpy(), A)


def test_npz_reader_matches_jax(tmp_path):
    from scipy import sparse as sp
    A, _, _ = lowrank(40, 30, 3, 0.4, 9)
    # a COO file with a duplicate entry and rows out of order
    M = sp.coo_matrix(A)
    M = sp.coo_matrix((np.r_[M.data, 1.0][::-1], (np.r_[M.row, 3][::-1],
                                                  np.r_[M.col, M.col[0]][::-1])),
                      shape=A.shape)
    sp.save_npz(tmp_path / "x.npz", M)
    ref = JaxReader(str(tmp_path) + "/", "x", "npz")._read_sparse()
    T = DataReader(str(tmp_path) + "/", "x", "npz").read()
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(ref.indices[:, 0]))
    np.testing.assert_array_equal(T.cols.numpy(), np.asarray(ref.indices[:, 1]))
    np.testing.assert_allclose(T.data.numpy(), np.asarray(ref.data), rtol=1e-7)
    assert T.shape == (40, 30)
