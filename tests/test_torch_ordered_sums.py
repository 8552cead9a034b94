"""The port's sums in a fixed order, on the CPU: the ordered scatter-adds of
the sparse products (``ops/sparse.py::line_plan``, ``ordered_sum``) against
``index_add_`` (the scatter they replace) and against the JAX package's
triplet and dual-ELL products, on the same numpy inputs with a hot line of
a few thousand entries in each orientation (several levels of the ordered
sum; the ELL's tails); and the row split of K1's and K3's second pass
(``ops/strip.py::split_plan``), which must not depend on the number of
members.

Tolerance: max |difference| / max |reference| <= 1e-6 at f32 and 1e-12 at
f64, the references (``index_add_``'s and the JAX package's) taken at f64 on
the same inputs: the same sums in another order. (``index_add_`` at f32 sums
the hot column 1.4e-6 away from f64, the ordered sum 1.2e-7.) A member of a
stack is held to its bits alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from _parity import np_, x64
from pydnmfk_tpu.ops import ell as jell
from pydnmfk_tpu.ops import sparse as js
from pydnmfk_tpu_torch.ops import ell as tell
from pydnmfk_tpu_torch.ops import sparse as ts
from pydnmfk_tpu_torch.ops import strip
from pydnmfk_tpu_torch.utils.convert import ell_from_numpy, sparse_from_numpy

M, N, K = 4000, 3000, 5
TOL = {np.float32: 1e-6, np.float64: 1e-12}
EPS = 1.19e-7
DTYPES = [np.float32, np.float64]


def hot(dtype, seed=23):
    """(rows, cols, vals), row-major and unique, of 12000 random entries, a
    full row 5 and a full column 9 (3000 and 4000 entries)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, M, 12000), np.full(N, 5),
                           np.arange(M)])
    cols = np.concatenate([rng.integers(0, N, 12000), np.arange(N),
                           np.full(M, 9)])
    key = np.unique(rows.astype(np.int64) * N + cols)
    return ((key // N).astype(np.int32), (key % N).astype(np.int32),
            (rng.random(key.size) + 0.5).astype(dtype))


def factors(dtype, b=None, seed=5):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    return (rng.random(lead + (M, K)).astype(dtype),
            rng.random(lead + (K, N)).astype(dtype))


def rel(out, ref):
    out = np.asarray(np_(out), np.float64)
    ref = np.asarray(np_(ref), np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def index_add(vals, idx, nlines):
    """The scatter that the ordered sums replace: (..., e, d) ->
    (..., nlines, d)."""
    out = torch.zeros((*vals.shape[:-2], nlines, vals.shape[-1]),
                      dtype=vals.dtype)
    return out.index_add_(out.dim() - 2, idx, vals)


@pytest.mark.parametrize("chunk", [0, 5000])
@pytest.mark.parametrize("b", [None, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ordered_sums_match_index_add(dtype, b, chunk):
    rows, cols, vals = hot(dtype)
    T = sparse_from_numpy(rows, cols, vals, (M, N))
    W, H = map(torch.from_numpy, factors(dtype, b))
    r, c, d = T.rows.long(), T.cols.long(), T.data.double()
    ref_aht = index_add(d[:, None] * H.double()[..., :, c].mT, r, M)
    ref_wta = index_add(d[:, None] * W.double()[..., r, :], c, N).mT
    ref_sq = index_add((d * d)[:, None], c, N)[:, 0]
    assert rel(ts.a_ht(T.data, T.rows, T.cols, H, M, chunk),
               ref_aht) <= TOL[dtype]
    assert rel(ts.wt_a(T.data, T.rows, T.cols, W, N, chunk),
               ref_wta) <= TOL[dtype]
    assert rel(ts.col_sqsum(T.data, T.cols, N), ref_sq) <= TOL[dtype]


@pytest.mark.parametrize("nnz", [1, 2, 300])
def test_ordered_sums_of_few_entries_and_broadcast_values(nnz):
    """A grid block with one or two entries gives a product of a size-1
    (or tiny) entry axis whose stride is not the shape's own, and a 1-D
    data broadcast against a member stack gives a stride-0 axis: the
    ordered sums still put each entry in its line (index_add_'s bits)."""
    rng = np.random.default_rng(nnz)
    rows = torch.from_numpy(np.sort(rng.integers(0, 25, nnz)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 9, nnz).astype(np.int32))
    data = torch.from_numpy(rng.random((6, nnz)))
    W = torch.from_numpy(rng.random((6, 25, 2)))
    H = torch.from_numpy(rng.random((6, 2, 9)))
    for d in (data, data[0]):
        vals = d[..., :, None] * W[..., rows.long(), :]
        ref = index_add(vals.expand(6, -1, -1), cols.long(), 9).mT
        assert torch.equal(ts.wt_a(d, rows, cols, W, 9), ref)
        vals = d[..., :, None] * H[..., :, cols.long()].mT
        ref = index_add(vals.expand(6, -1, -1), rows.long(), 25)
        assert torch.equal(ts.a_ht(d, rows, cols, H, 25), ref)


def test_line_plan_sums_each_line_in_runs_in_order():
    """The plan of the column index (unsorted in a row-major triplet): a
    stable sort, runs of at most RUN entries a level, each level's runs
    covering the level below once, and the last level one length a line;
    kept on the index tensor, so that a second call makes nothing new."""
    rows, cols, vals = hot(np.float32)
    T = sparse_from_numpy(rows, cols, vals, (M, N))
    plan = ts.line_plan(T.cols, N)
    assert ts.line_plan(T.cols, N) is plan
    (sel, levels), = plan
    order = np.argsort(cols, kind="stable")
    np.testing.assert_array_equal(sel.numpy(), order)
    assert len(levels) == 2 and levels[-1].shape == (N,)
    size = len(cols)
    for lengths in levels:
        assert int(lengths.sum()) == size and int(lengths.max()) <= ts.RUN
        size = lengths.numel()
    np.testing.assert_array_equal(
        levels[-1].numpy(), -(-np.bincount(cols, minlength=N) // ts.RUN))
    # the rows of a row-major triplet are sorted: no sort, one slice a chunk
    chunks = ts.line_plan(T.rows, M, 5000)
    assert [s for s, _ in chunks] == [slice(0, 5000), slice(5000, 10000),
                                      slice(10000, 15000),
                                      slice(15000, len(rows))]


@pytest.mark.parametrize("dtype", DTYPES)
def test_triplet_products_match_jax(dtype):
    rows, cols, vals = hot(dtype)
    W, H = factors(dtype)
    T = sparse_from_numpy(rows, cols, vals, (M, N))
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    with x64():
        B = jsparse.BCOO((jnp.asarray(vals, jnp.float64), jnp.asarray(
            np.stack([rows, cols], 1))), shape=(M, N))
        Wj, Hj = jnp.asarray(W, jnp.float64), jnp.asarray(H, jnp.float64)
        pairs = [
            (ts.a_ht_triplet(T, Ht), js.a_ht_bcoo(B, Hj)),
            (ts.wt_a_triplet(T, Wt), js.wt_a_bcoo(B, Wj)),
            (ts.kl_uht_sparse(T, Wt, Ht, EPS),
             js.kl_uht_sparse(B, Wj, Hj, EPS)),
            (ts.kl_wtu_sparse(T, Wt, Ht, EPS),
             js.kl_wtu_sparse(B, Wj, Hj, EPS)),
            (ts.col_sqsum(T.data, T.cols, N),
             js.col_sqsum(B.data, jnp.asarray(cols), N))]
        for out, ref in pairs:
            assert rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_products_with_tails_match_jax(dtype):
    """The dual ELL of the hot matrix, whose tails hold the full row and
    column: the port's products (gathers plus ordered tail sums) against
    the JAX package's, on the JAX package's own packing."""
    rows, cols, vals = hot(dtype)
    W, H = factors(dtype)
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    with x64():
        B = jsparse.BCOO((jnp.asarray(vals, jnp.float64), jnp.asarray(
            np.stack([rows, cols], 1))), shape=(M, N))
        Ej = jell.ell_pack(B)
        assert Ej.rtail_d.shape[0] > 2000 and Ej.ctail_d.shape[0] > 2000
        # the same packing at the port's dtype
        at = lambda f: np.asarray(getattr(Ej, f))
        Et = ell_from_numpy(*(at(f).astype(dtype) if f.endswith(("vals", "_d"))
                              else at(f) for f in tell.FIELDS),
                            Ej.shape, Ej.nse)
        Wj, Hj = jnp.asarray(W, jnp.float64), jnp.asarray(H, jnp.float64)
        pairs = [
            (tell.ell_a_ht(Et, Ht), jell.ell_a_ht(Ej, Hj)),
            (tell.ell_wt_a(Et, Wt), jell.ell_wt_a(Ej, Wj)),
            (tell.ell_kl_uht(Et, Wt, Ht, EPS),
             jell.ell_kl_uht(Ej, Wj, Hj, EPS)),
            (tell.ell_kl_wtu(Et, Wt, Ht, EPS),
             jell.ell_kl_wtu(Ej, Wj, Hj, EPS)),
            (tell.ell_col_sqsum(Et), jell.ell_col_sqsum(Ej))]
        for out, ref in pairs:
            assert rel(out, ref) <= TOL[dtype]


def test_member_in_a_stack_is_bitwise_alone():
    rows, cols, vals = hot(np.float32)
    T = sparse_from_numpy(rows, cols, vals, (M, N))
    W, H = map(torch.from_numpy, factors(np.float32, 3))
    for f in (lambda W, H: ts.a_ht_triplet(T, H),
              lambda W, H: ts.wt_a_triplet(T, W),
              lambda W, H: ts.kl_wtu_sparse(T, W, H, EPS)):
        stack = f(W, H)
        assert torch.equal(stack[2], f(W[2], H[2]))


# (strip, chunk) of the second pass's kernels, as csrc/kl_ratio.cu exports
# them (wtu_pass_geometry; the gpu test checks the export): K2b's register
# kernel at KP = 8, 16, 32 and (without the ratio) 64, its 3xTF32 kernel,
# the strip kernel on a 16-bit A, on a uint8 A at KP <= 32 and at 64
GEOMETRIES = [(128, 256), (64, 256), (32, 128), (128, 32), (64, 64),
              (128, 64), (64, 128)]
SHAPES = [(57600, 38400, 32), (14400, 9600, 8), (57600, 38400, 64),
          (14400, 9600, 64), (96, 21, 4)]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_second_pass_split_is_the_same_for_any_batch(m, n, k):
    """The split of K1's and K3's second pass at the smoke's shapes (and
    the wtsi stack's) on an H100's 132 SMs: the same for 1 and 10 members,
    whole chunks a split, every row in one split, and a split wherever a
    member's strips are fewer than 8 blocks an SM and it has rows for
    one."""
    for s, c in GEOMETRIES:
        plan = strip.split_plan((1, m, n), k, s, c, 132)
        assert plan == strip.split_plan((10, m, n), k, s, c, 132)
        splits, rows = plan
        assert splits == -(-m // rows) and (rows % c == 0 or splits == 1)
        assert (splits > 1) == (-(-n // s) < 8 * 132 and m > c)
