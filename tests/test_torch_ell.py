"""pydnmfk_tpu_torch.ops.ell and ops.ell_gather (the dual ELL format and the
plain version of kernel K4) against pydnmfk_tpu.ops.ell and the Pallas ELL
kernel in interpret mode, on the same numpy inputs.

Tolerance: the packed arrays are equal; the products agree at rtol 1e-5 /
atol 1e-6 at f32 (summation order of the gathers and the tail scatters)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from _parity import interpret_pallas, np_  # noqa: F401  (fixture)
from test_torch_sparse import lowrank
from pydnmfk_tpu.ops import ell as jell
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.ops.pallas_ell import ell_gather_product as pallas_gather
from pydnmfk_tpu_torch.ops import ell as tell
from pydnmfk_tpu_torch.ops import ell_gather as teg
from pydnmfk_tpu_torch.ops import linalg as tl
from pydnmfk_tpu_torch.utils.convert import ell_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
EPS = 1.19e-7
PACKS = [dict(), dict(w_cap=3, max_tail_frac=1.0), dict(cap_q=0.5)]


@pytest.mark.parametrize("kw", PACKS, ids=["default", "w_cap3", "median"])
def test_ell_pack_matches_jax(kw):
    """Array for array, perms included, with forced tails (w_cap=3) and a
    median width cap."""
    _, B, T = lowrank(50, 30, 3, 0.3, 0)
    Ej, *pj = jell.ell_pack(B, return_perms=True, **kw)
    Et, *pt = tell.ell_pack(T, return_perms=True, **kw)
    if kw:
        assert Et.rtail_d.shape[0] > 0 and Et.ctail_d.shape[0] > 0
    for name in tell.FIELDS:
        a, b = getattr(Et, name), np.asarray(getattr(Ej, name))
        assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert Et.shape == Ej.shape and Et.nse == Ej.nse
    np.testing.assert_array_equal(Et.data.numpy(), np.asarray(Ej.data))


def test_ell_pack_rejects_skew():
    """One dense row in an otherwise near-empty matrix: the capped width
    would blow up, so both packages refuse it (test_ell_pack_rejects_skew
    of tests/test_sparse.py)."""
    m, n = 200, 300
    dense = np.zeros((m, n), np.float32)
    dense[0, :] = 1.0
    dense[np.arange(1, m), np.arange(1, m) % n] = 1.0
    B = jsparse.BCOO.fromdense(jnp.asarray(dense))
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    T = sparse_from_numpy(np.asarray(B.indices[:, 0]),
                          np.asarray(B.indices[:, 1]), np.asarray(B.data),
                          (m, n))
    assert jell.ell_pack(B) is None and tell.ell_pack(T) is None
    # too heavy a tail is refused too
    assert tell.ell_pack(T, w_cap=1, max_tail_frac=0.1, max_blowup=1e9) is None


@pytest.mark.parametrize("kw", PACKS[:2], ids=["default", "w_cap3"])
def test_ell_products_match_jax(kw):
    _, B, T = lowrank(50, 36, 3, 0.2, 1)
    Ej = jell.ell_pack(B, **kw)
    Et = ell_from_numpy(*(np.asarray(getattr(Ej, f)) for f in tell.FIELDS),
                        Ej.shape, Ej.nse)
    rng = np.random.default_rng(2)
    W, H = (rng.random((50, 4)).astype(np.float32),
            rng.random((4, 36)).astype(np.float32))
    Wj, Hj, Wt, Ht = jnp.asarray(W), jnp.asarray(H), *map(torch.from_numpy,
                                                          (W, H))
    pairs = [
        (tell.ell_a_ht(Et, Ht), jell.ell_a_ht(Ej, Hj)),
        (tell.ell_wt_a(Et, Wt), jell.ell_wt_a(Ej, Wj)),
        (tell.ell_kl_uht(Et, Wt, Ht, EPS), jell.ell_kl_uht(Ej, Wj, Hj, EPS)),
        (tell.ell_kl_wtu(Et, Wt, Ht, EPS), jell.ell_kl_wtu(Ej, Wj, Hj, EPS)),
        (tell.ell_col_sqsum(Et), jell.ell_col_sqsum(Ej)),
        (tl.relative_error(Et, Wt, Ht), jl.relative_error(Ej, Wj, Hj)),
        (tl.column_error(Et, Wt, Ht), jl.column_error(Ej, Wj, Hj)),
        (tl.matmul_AHT(Et, Ht), jl.matmul_AHT(Ej, Hj)),
        (tl.matmul_WTA(Wt, Et), jl.matmul_WTA(Wj, Ej)),
    ]
    for out, ref in pairs:
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("m,n,k,w,seed", [
    (700, 300, 32, 9, 0),        # ragged over the Pallas kernel's 512 rows
    (130, 97, 7, 3, 1),          # k not a multiple of 4
])
@pytest.mark.parametrize("ratio", [False, True])
def test_gather_plain_matches_pallas(m, n, k, w, seed, ratio,
                                     interpret_pallas):
    """ell_gather_product_plain against the Pallas ELL kernel
    (pallas_ell.py::_kernel) in interpret mode, plain and ratio."""
    rng = np.random.default_rng(seed)
    vals = (rng.random((m, w)) * (rng.random((m, w)) < 0.7)).astype(np.float32)
    idx = rng.integers(0, n, (m, w)).astype(np.int32)
    T = (rng.random((n, k)) + 0.1).astype(np.float32)
    X = (rng.random((m, k)) + 0.1).astype(np.float32) if ratio else None
    ref = pallas_gather(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(T),
                        None if X is None else jnp.asarray(X), eps=EPS,
                        interpret=True)
    out = teg.ell_gather_product(
        torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(T),
        None if X is None else torch.from_numpy(X), EPS)
    np.testing.assert_allclose(np_(out), np_(ref), **TOL)


@pytest.mark.parametrize("ratio", [False, True])
def test_gather_member_stack_matches_each_member(ratio, interpret_pallas):
    """A (3, dim, w) stack over shared indices, each member with its own
    table, in one plain call, against the Pallas kernel per member; the line
    chunks of block_rows (a small budget forces several) change nothing."""
    rng = np.random.default_rng(3)
    b, m, n, k, w = 3, 90, 40, 8, 5
    vals = rng.random((b, m, w)).astype(np.float32)
    idx = rng.integers(0, n, (m, w)).astype(np.int32)
    T = rng.random((b, n, k)).astype(np.float32)
    X = rng.random((b, m, k)).astype(np.float32) if ratio else None
    tX = None if X is None else torch.from_numpy(X)
    out = teg.ell_gather_product(torch.from_numpy(vals), torch.from_numpy(idx),
                                 torch.from_numpy(T), tX, EPS)
    assert teg.block_rows(m, w, k * b, budget_elems=400) == 8
    for i in range(b):
        ref = pallas_gather(jnp.asarray(vals[i]), jnp.asarray(idx),
                            jnp.asarray(T[i]),
                            None if X is None else jnp.asarray(X[i]), eps=EPS,
                            interpret=True)
        np.testing.assert_allclose(np_(out[i]), np_(ref), **TOL)


def test_block_rows_matches_jax():
    for dim, w, k in [(100, 5, 8), (300_000, 272, 32), (50_000, 250, 256)]:
        assert teg.block_rows(dim, w, k) == jell._block_rows(dim, w, k)


def test_ell_with_data_matches_the_jax_orientation():
    """Member values gathered into both orientations through the perms, as
    the JAX ELL ensemble program's ``orient`` does (nmfk.py:301-309)."""
    _, B, T = lowrank(40, 30, 3, 0.3, 4)
    E, *perms = tell.ell_pack(T, return_perms=True, w_cap=2,
                              max_tail_frac=1.0)
    data = torch.rand((2, T.nse), generator=torch.Generator().manual_seed(0))
    M = tell.ell_with_data(E, *perms, data)
    nnz = T.nse
    for i in range(2):
        d = data[i].numpy()
        for got, perm in ((M.rvals[i], perms[0]), (M.cvals[i], perms[1])):
            p = perm.numpy()
            want = np.where(p < nnz, d[np.minimum(p, nnz - 1)], 0.0)
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(M.rtail_d[i].numpy(),
                                      d[perms[2].numpy()])
        np.testing.assert_array_equal(M.ctail_d[i].numpy(),
                                      d[perms[3].numpy()])
    # each member's values, gathered back, equal its flat data
    np.testing.assert_allclose(np_(tl.sqnorm(M)), np_((data ** 2).sum(-1)),
                               rtol=1e-6)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Off the CPU the dispatch launches K4 or raises; here (meta tensors, no
    nvcc or card) it must raise rather than compute the plain version."""
    vals, T = torch.empty((64, 5), device="meta"), torch.empty((40, 8),
                                                                device="meta")
    idx = torch.empty((64, 5), dtype=torch.int32, device="meta")
    for X in (None, torch.empty((64, 8), device="meta")):
        with pytest.raises(Exception):
            teg.ell_gather_product(vals, idx, T, X, EPS)
    assert teg.launches == {"ell_gather": 0, "ell_gather_ratio": 0,
                            "ell_gather_f16": 0, "ell_gather_ratio_f16": 0}


# (members, dim_t, KP, the kernel's largest group): the sweep's topic stack
# in both orientations at k = 7 and 3, the NYTimes tables at k = 32 (W alone
# above the L2 share), a single member, stacks that leave a ragged last
# group, and the legacy widths (no groups)
GROUP_CASES = [(10, 50_000, 8, 8), (10, 200_000, 8, 8), (10, 200_000, 4, 8),
               (1, 300_000, 32, 4), (1, 102_660, 32, 4), (1, 50, 8, 8),
               (3, 1000, 16, 8), (5, 70_000, 32, 4), (100, 10_000, 4, 8),
               (7, 1, 4, 8), (3, 1000, 4, 8), (2, 10 ** 7, 4, 8),
               (6, 1000, 4, 8), (5, 1000, 8, 8), (16, 50_000, 4, 8),
               (10, 50_000, 64, 0), (1, 300, 256, 0)]
H100_L2 = 50 * 2 ** 20


@pytest.mark.parametrize("B,dim_t,kp,gmax", GROUP_CASES)
def test_member_groups_cover_every_member_once(B, dim_t, kp, gmax):
    """K4's member groups: a power of two up to the kernel's largest, below
    2 B, with a run of at most one 128-byte line; every member in exactly
    one group (the kernel's groups [gG, gG + G) clipped to B); a group's
    table within the L2 share and a ragged last group's idle lanes within
    their share, unless G is 1; the largest group that keeps all that; and
    G = 1 at B = 1."""
    G = teg.member_groups(B, dim_t, kp, gmax, H100_L2)
    if gmax == 0:
        assert G == 0
        return
    assert G & (G - 1) == 0 and 1 <= G <= gmax and G < 2 * B
    assert G == 1 or G * kp * 4 <= teg.LINE_BYTES
    groups = [range(g * G, min(B, (g + 1) * G)) for g in range(-(-B // G))]
    assert [e for r in groups for e in r] == list(range(B))
    assert all(len(r) > 0 for r in groups)
    share = teg.L2_SHARE * H100_L2
    idle = 1 - B / (len(groups) * G)
    assert idle == teg.idle_lanes(B, G)
    assert G == 1 or (G * dim_t * kp * 4 <= share and idle <= teg.MAX_IDLE)
    H = 2 * G
    assert (H > gmax or G >= B or G * kp * 4 >= teg.LINE_BYTES
            or H * dim_t * kp * 4 > share or teg.idle_lanes(B, H) > teg.MAX_IDLE)
    if B == 1:
        assert G == 1
    if B == 10 and kp in (4, 8):
        assert G == 4       # the sweep's stack at k = 3 and 7: 4 + 4 + 2


@pytest.mark.parametrize("B,dim_t,k,kp,G", [
    (10, 13, 7, 8, 8), (10, 13, 7, 8, 4), (3, 5, 3, 4, 2), (1, 9, 32, 32, 1),
    (1, 9, 5, 8, 1), (3, 6, 16, 16, 8), (4, 3, 1, 4, 2), (2, 7, 31, 32, 4)])
@pytest.mark.parametrize("strided", [False, True])
def test_interleave_matches_numpy(B, dim_t, k, kp, G, strided):
    """The interleaved table of K4 against a numpy reference: group after
    group, (dim_t, gg, kp) with each member's row padded with zeros; T
    itself at one member and k == kp."""
    rng = np.random.default_rng(B * dim_t + k)
    T = rng.random((B, dim_t, k)).astype(np.float32)
    ref = []
    for e0 in range(0, B, G):
        grp = np.zeros((dim_t, min(G, B - e0), kp), np.float32)
        grp[..., :k] = T[e0:e0 + G].transpose(1, 0, 2)
        ref.append(grp.reshape(-1))
    tT = torch.from_numpy(T)
    if strided:           # the wrapper's T is contiguous; the copy takes any
        tT = torch.from_numpy(np.ascontiguousarray(T.transpose(0, 2, 1))).mT
    out = teg.interleave(tT, G, kp)
    np.testing.assert_array_equal(out.reshape(-1).numpy(), np.concatenate(ref))
    if G == 1 and k == kp and not strided:
        assert out.data_ptr() == tT.data_ptr()


# (dim_t, k, L2 bytes, the kernel's widest slab): the NYTimes tables (H^T
# 102660 rows, W 300000) at k = 64, 128, 256 and 300, the sweep's topic stack
# (50000 and 200000 rows) at k = 64, small tables at k = 33 and past the
# widest slab, a narrower widest slab, a table that fits at the widest slab,
# and one past the L2 at the 16-float minimum
SLAB_CASES = [(102_660, 64, H100_L2, 256), (300_000, 64, H100_L2, 256),
              (102_660, 128, H100_L2, 256), (300_000, 128, H100_L2, 256),
              (102_660, 256, H100_L2, 256), (300_000, 256, H100_L2, 256),
              (102_660, 300, H100_L2, 256), (300_000, 300, H100_L2, 256),
              (50_000, 64, H100_L2, 256), (200_000, 64, H100_L2, 256),
              (1000, 33, H100_L2, 256), (330, 300, H100_L2, 256),
              (400, 1000, H100_L2, 256), (5000, 200, H100_L2, 64),
              (20_000, 256, H100_L2, 256), (10 ** 7, 40, H100_L2, 256)]
SEVERAL = {(300_000, 64), (102_660, 300), (300_000, 300)}


@pytest.mark.parametrize("ratio", [False, True])
@pytest.mark.parametrize("dim_t,k,l2,smax", SLAB_CASES)
def test_slab_plan_covers_every_column_once(dim_t, k, l2, smax, ratio):
    """K4's column slabs past k = 32: together they cover every column once;
    a width of at most the kernel's widest slab; one slab exactly where the
    whole table fits (a ratio product: wherever k is at most the widest
    slab); where there are several, a power of two of at least 16 floats
    (the plan's minimum, 32), one member's slab within the L2 share unless
    at the minimum, and no width that fits the share pads k less; several
    at the NYTimes shape for k = 64 (columns) and k = 300 (plain), k = 300
    (ratio)."""
    ks, count = teg.slab_plan(dim_t, k, l2, smax, ratio)
    slabs = [range(j * ks, min(k, (j + 1) * ks)) for j in range(count)]
    assert [c for r in slabs for c in r] == list(range(k))
    assert all(len(r) > 0 for r in slabs)
    assert ks <= smax
    share = teg.SLAB_SHARE * l2
    fits = (ratio or dim_t * k * 4 <= share) and k <= smax
    assert (count == 1) == fits
    if count == 1:
        assert ks == k
    else:
        assert ks >= teg.MIN_SLAB >= 16 and ks & (ks - 1) == 0
        assert ks == teg.MIN_SLAB or dim_t * ks * 4 <= share
        for w in (32, 64, 128, 256):
            if w <= smax and dim_t * w * 4 <= share:
                assert -(-k // w) * w >= count * ks
    if (dim_t, k) in SEVERAL and (k > smax or not ratio):
        assert count > 1


@pytest.mark.parametrize("B,dim_t,k,slab", [
    (1, 9, 33, 16), (3, 7, 300, 56), (2, 5, 40, 40), (2, 5, 41, 41),
    (1, 4, 64, 13), (4, 3, 257, 256), (1, 1, 35, 8)])
def test_slab_table_matches_numpy(B, dim_t, k, slab):
    """K4's slab table against a numpy reference: member after member, its
    slabs of ``slab`` columns one after the other, each row padded with
    zeros to the slab's width rounded up to 4 floats."""
    rng = np.random.default_rng(B * dim_t + k)
    T = rng.random((B, dim_t, k)).astype(np.float32)
    nslab, ldt = -(-k // slab), -(-slab // 4) * 4
    ref = np.zeros((B, nslab, dim_t, ldt), np.float32)
    for j in range(nslab):
        c1 = min(k, (j + 1) * slab)
        ref[:, j, :, :c1 - j * slab] = T[..., j * slab:c1]
    out = teg.slab_table_plain(torch.from_numpy(T), slab)
    np.testing.assert_array_equal(out.numpy(), ref.reshape(-1))


@pytest.mark.parametrize("dim_t,k", [(102_660, 32), (102_660, 64),
                                     (300_000, 300), (330, 300), (50, 40)])
def test_slab_plan_off_the_card_is_the_h100s(dim_t, k):
    """The slabs the memory model plans on a device that runs no K4: one
    at k <= 32 (the grouped kernel), else the plan on the H100's L2 and the
    kernel's widest slab."""
    for ratio in (False, True):
        want = (k, 1) if k <= 32 else teg.slab_plan(
            dim_t, k, teg.H100_L2_BYTES, teg.MAX_SLAB, ratio)
        assert teg.slab_for(dim_t, k, "cpu", ratio=ratio) == want
    assert teg.H100_L2_BYTES == H100_L2


@pytest.mark.parametrize("ratio", [False, True])
@pytest.mark.parametrize("table", ["float32", "float16", "bfloat16"])
def test_gather_plain_f16_values_matches_pallas(ratio, table,
                                                interpret_pallas):
    """K4's plain version with f16 values (a_precision="float16") against
    the Pallas ELL kernel in interpret mode: the values widened exactly,
    the sums f32; a half table (the NMF at bf16 or f16) is widened exactly
    too, so the tolerance stays f32's."""
    rng = np.random.default_rng(5)
    m, n, k, w = 130, 97, 7, 3
    vals = (rng.random((m, w)) * 4).astype(np.float16)
    idx = rng.integers(0, n, (m, w)).astype(np.int32)
    T = np.array(jnp.asarray(rng.random((n, k)) + 0.1, table), np.float32)
    X = (np.array(jnp.asarray(rng.random((m, k)) + 0.1, table), np.float32)
         if ratio else None)
    ref = pallas_gather(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(T),
                        None if X is None else jnp.asarray(X), eps=EPS,
                        interpret=True)
    tt = getattr(torch, table)
    out = teg.ell_gather_product(
        torch.from_numpy(vals), torch.from_numpy(idx),
        torch.from_numpy(T).to(tt),
        None if X is None else torch.from_numpy(X).to(tt), EPS)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), np_(ref), **TOL)


def test_format_ladder_at_nytimes_k300_ends_beyond_dense():
    """A k = 300 topic model of the NYTimes corpus (300000 x 102660, 69.7 M
    nnz) fits no dense format on an 80 GB card (61.6 GB even at bf16, past
    the 45 % budget), so the ladder ends in "ell_beyond": the dual ELL, and
    with it K4, is the only path on the card at that width."""
    from pydnmfk_tpu_torch.ops import sparse as tsp
    m, n, nnz = 300_000, 102_660, 69_679_427
    budget = tsp.BUDGET_FRAC * 80e9
    ladder = tsp.format_ladder(m, n, nnz, 300, 4, budget, "cuda")
    assert ladder[-1] == "ell_beyond" and "dense" not in ladder
    assert m * n * 2 > budget


@pytest.mark.parametrize("ratio", [False, True])
def test_ell_products_at_k300_match_jax(ratio):
    """The plain ELL products at k = 300, past the card kernel's 256-column
    slab, against the JAX package's XLA ELL path (no width limit): A H^T and
    W^T A, or UHT and WTU, with forced tails."""
    _, B, T = lowrank(60, 45, 3, 0.3, 4)
    Ej = jell.ell_pack(B, w_cap=3, max_tail_frac=1.0)
    Et = ell_from_numpy(*(np.asarray(getattr(Ej, f)) for f in tell.FIELDS),
                        Ej.shape, Ej.nse)
    rng = np.random.default_rng(5)
    W, H = (rng.random((60, 300)).astype(np.float32),
            rng.random((300, 45)).astype(np.float32))
    Wj, Hj, Wt, Ht = jnp.asarray(W), jnp.asarray(H), *map(torch.from_numpy,
                                                          (W, H))
    if ratio:
        pairs = [(tell.ell_kl_uht(Et, Wt, Ht, EPS),
                  jell.ell_kl_uht(Ej, Wj, Hj, EPS)),
                 (tell.ell_kl_wtu(Et, Wt, Ht, EPS),
                  jell.ell_kl_wtu(Ej, Wj, Hj, EPS))]
    else:
        pairs = [(tell.ell_a_ht(Et, Ht), jell.ell_a_ht(Ej, Hj)),
                 (tell.ell_wt_a(Et, Wt), jell.ell_wt_a(Ej, Wj))]
    for out, ref in pairs:
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-4, atol=1e-6)
