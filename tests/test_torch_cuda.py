"""Kernels K1, K2a, K2b, K3 and K4 on the card against their plain versions,
at ragged shapes (odd n, so uint8 rows are not 4-byte aligned), every padded
width of k, every A dtype (f32, bf16, uint8) and member stacks. These need a
CUDA device and nvcc and skip without them; on a machine with a card run
``python -m pytest -m gpu tests/test_torch_cuda.py``.

Tolerance: max |kernel - plain| / max |plain| <= 1e-4 with an f32 A (sums in
another order; K1's W'^T A and K3's W'^T U' also in atomic order), 1e-3 with
a bf16 or uint8 A in K1 and K3 (operands rounded to bf16 where kernel and
plain values may differ in the last f32 bit). K2 computes in f32 for every
A dtype: 1e-4. K4 sums in another order only: 1e-4 for f32 and bf16 values
alike (bf16 values are widened exactly)."""
import pytest
import torch

from _k2_plan import PLAN_CASES, check_plan
from pydnmfk_tpu_torch.ops import (ell, ell_gather, fused_kl, fused_mu, kl,
                                   linalg, sparse)

pytestmark = pytest.mark.gpu
EPS = 1.19e-7
SHAPES = [(1, 64, 48), (1, 300, 200), (3, 130, 97), (2, 1000, 777)]
# K1's f32 kernel takes panels of 128 rows (64 at k > 32), 64-column tiles,
# 16-byte loads and vector atomics when n % 4 == 0: ragged panels (m = 129,
# 257), n % 4 = 2 and 3 (scalar path), n % 4 == 0 across member bases, and
# n below one tile. Its tensor-core kernel (bf16, uint8 A) takes panels of
# 256 rows (128 at k > 32), tiles of 64 bf16 or 128 uint8 columns (64 at
# k > 32) and 16-byte copies when n % 8 (bf16) or n % 16 (uint8) is 0:
# n % 16 == 0 off the tile widths (208, 400,
# 1040), m ragged at the panel height (129, 257, 513), n of one 16-byte chunk
# (8 bf16, 16 uint8 values) and a 3-member stack
K1_SHAPES = SHAPES + [(1, 129, 66), (2, 257, 131), (3, 257, 200),
                      (2, 129, 20), (1, 5, 7), (1, 129, 208), (2, 513, 400),
                      (1, 257, 1040), (1, 33, 8), (2, 70, 16), (3, 300, 416)]
K1_KEY = {torch.float32: "fused_mu_fro", torch.bfloat16: "fused_mu_fro_bf16",
          torch.uint8: "fused_mu_fro_u8"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, m, n, k, dtype):
    """A (b, m, n) in dtype (a uint8 A holds 0..255), W and H in f32."""
    g = torch.Generator(dev)
    g.manual_seed(b * m * n + k)
    A = torch.rand((b, m, n), generator=g, device=dev)
    A = (A * 255).round().to(dtype) if dtype == torch.uint8 else A.to(dtype)
    return (A, torch.rand((b, m, k), generator=g, device=dev),
            torch.rand((b, k, n), generator=g, device=dev))


def _rel(out, ref):
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(out, ref))


DTYPES = [torch.float32, torch.bfloat16, torch.uint8]


@pytest.mark.parametrize("b,m,n", K1_SHAPES)
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    HHT = linalg.gram_t(H)
    key = K1_KEY[dtype]
    before = dict(fused_mu.launches)
    out = fused_mu.fused_w_pass(A, W, H, HHT, EPS)
    assert fused_mu.launches == {**before, key: before[key] + 1}
    ref = fused_mu.fused_w_pass_plain(A, W, H, HHT, EPS)
    assert _rel(out, ref) <= (1e-4 if dtype == torch.float32 else 1e-3)


# K3's f32 kernel (k <= 32) takes panels of 128 rows, sweep-1 tiles of 32
# columns, sweep-2 strips of 1024, 512, 256 columns (k <= 8, 16, 32) in
# chunks of 4, 8, 16 rows, 16-byte loads and vector atomics when n % 4 ==
# 0. Its tensor-core kernel (bf16, uint8 A, k <= 32) takes panels of 256
# rows, tiles of 64 bf16 or 128 uint8 columns and 16-byte copies when n % 8
# (bf16) or n % 16 (uint8) is 0. The first port's kernel (k > 32) takes
# panels of 64 rows and 64-column tiles. Shapes: m ragged at the panel
# heights (129, 257, 513: one row past whole panels), n % 4 = 1, 2, 3
# (scalar paths), n % 4 == 0 over several tiles and strips with a ragged
# last one (1040: 32 tiles and 16 columns, strips of 1024 + 16, 2 x 512 +
# 16, 4 x 256 + 16; 1540: 48 tiles and 4, strips of 1024 + 516, 3 x 512 +
# 4, 6 x 256 + 4), n below one tile (8, 20), a 10-member stack; n % 8 = 4
# (100: bf16 and uint8 on the scalar path, f32 on the 16-byte one), n % 16
# = 8 (264: uint8 scalar, bf16 16-byte) with m ragged at 256, and whole
# panels and tiles (512 x 1024).
K3_SHAPES = SHAPES + [(1, 129, 66), (2, 257, 131), (1, 257, 129),
                      (2, 65, 130), (1, 129, 1040), (2, 129, 1540),
                      (1, 33, 8), (3, 300, 20), (10, 70, 200), (1, 513, 600),
                      (2, 257, 100), (1, 513, 264), (2, 512, 1024)]
K3_KEY = {torch.float32: "fused_mu_kl", torch.bfloat16: "fused_mu_kl_bf16",
          torch.uint8: "fused_mu_kl_u8"}
K3_K = [1, 3, 7, 8, 9, 16, 17, 31, 32, 33, 64]


def _k3_check(A, W, H):
    """One K3 launch, under A's dtype key only, against the plain version."""
    hrs = linalg.sum_axis(H, axis=-1)
    key = K3_KEY[A.dtype]
    before = dict(fused_kl.launches)
    out = fused_kl.fused_kl_pass(A, W, H, hrs, EPS)
    assert fused_kl.launches == {**before, key: before[key] + 1}
    ref = fused_kl.fused_kl_pass_plain(A, W, H, hrs, EPS, 50)
    assert _rel(out, ref) <= (1e-4 if A.dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("b,m,n", K3_SHAPES)
@pytest.mark.parametrize("k", K3_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_matches_plain(cuda, b, m, n, k, dtype):
    _k3_check(*_inputs(cuda, b, m, n, k, dtype))


@pytest.mark.parametrize("k", K3_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_misaligned_a_matches_plain(cuda, k, dtype):
    """A contiguous A that starts one element past a 16-byte boundary (a
    view into a larger buffer) takes the element-by-element path."""
    b, m, n = 2, 257, 528
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    buf = torch.empty(A.numel() + 1, dtype=dtype, device=cuda)
    Av = buf[1:].view(b, m, n)
    Av.copy_(A)
    assert Av.is_contiguous() and Av.data_ptr() % 16 != 0
    _k3_check(Av, W, H)


# K2's register kernels (k <= 32), as UhtGeom and WtuGeom in
# csrc/kl_ratio.cu have them: K2b strips of 128 columns (64 at k > 16) over
# W chunks of 256 rows; K2a row tiles of 16, 32, 64 rows (k <= 8, 16, 32)
# over double-buffered H tiles of 512 columns (256 at k > 16); 16-byte
# loads when n % 4 == 0. Shapes: n ragged at the strip widths with n % 4 =
# 1, 2, 3 (scalar path) and 0, m ragged at the row tiles, n % 4 == 0 over
# several H tiles with a ragged last one (n = 1040: 2 or 4 whole tiles at
# k <= 16 or k > 16, then 16 columns; n = 1540: 3 or 6, then 4), a
# 10-member stack, and single members tall enough for K2b's row split
# (ops/kl.py::wtu_split_plan). k = 130: a padded k in the first port's
# KP = 256 kernel.
K2_SHAPES = SHAPES + [(1, 257, 129), (1, 129, 130), (2, 65, 131),
                      (1, 33, 260), (10, 70, 200), (1, 3000, 260),
                      (1, 2100, 67), (1, 300, 1040), (2, 129, 1540)]
K2_K = [1, 3, 7, 8, 9, 16, 17, 31, 32, 33, 65, 130, 256]


@pytest.mark.parametrize("b,m,n", K2_SHAPES)
@pytest.mark.parametrize("k", K2_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    before = dict(kl.launches)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
    assert kl.launches == {key: v + 1 for key, v in before.items()}
    ref = (kl.kl_uht_plain(A, W, H, EPS, 50), kl.kl_wtu_plain(A, W, H, EPS))
    assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("b,m,n", [(10, 70, 200), (1, 3000, 260),
                                   (1, 2100, 67)])
@pytest.mark.parametrize("k", [3, 8, 32, 65, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_launches_are_bitwise_equal(cuda, b, m, n, k, dtype):
    """Partial sums meet in a fixed order (no atomics; K2b's row split adds
    its slabs in split order): two launches give the same bits."""
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    for fn in (kl.kl_uht, kl.kl_wtu):
        assert torch.equal(fn(A, W, H, EPS), fn(A, W, H, EPS))


@pytest.mark.parametrize("splits", [1, 2, 3, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2b_given_splits_matches_plain(cuda, splits, dtype):
    """K2b with its rows cut into as many splits as asked (at most one per
    W chunk) on a 2-member stack, and one launch per call."""
    A, W, H = _inputs(cuda, 2, 3000, 260, 8, dtype)
    before = kl.launches["kl_wtu"]
    out = kl.kl_wtu(A, W, H, EPS, splits=splits)
    assert kl.launches["kl_wtu"] == before + 1
    assert _rel([out], [kl.kl_wtu_plain(A, W, H, EPS)]) <= 1e-4


def test_wtu_split_plan_on_the_exported_geometry(cuda):
    """K2b's geometry as the source exports it: a strip of whole 4-column
    groups and a chunk for k <= 32, no split for k > 32, and a plan that
    keeps the split's invariants (``_k2_plan.check_plan``) on it."""
    for k in range(1, kl.MAX_K + 1):
        strip, chunk = kl.wtu_geometry(k)
        assert (strip > 0) == (k <= 32)
        assert strip % 4 == 0 and (chunk > 0) == (strip > 0)
    for B, m, n, k in PLAN_CASES:
        check_plan(B, m, n, k, *kl.wtu_geometry(k))
    for k in (0, kl.MAX_K + 1):
        with pytest.raises(RuntimeError, match="kl_wtu_geometry"):
            kl.wtu_geometry(k)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    A, W, H = _inputs(cuda, 1, 64, 48, 65, torch.float32)
    with pytest.raises(ValueError, match="k <= 64"):
        fused_mu.fused_w_pass(A, W, H, linalg.gram_t(H), EPS)
    with pytest.raises(ValueError, match="k <= 64"):
        fused_kl.fused_kl_pass(A, W, H, linalg.sum_axis(H, axis=-1), EPS)
    with pytest.raises(TypeError):
        fused_kl.fused_kl_pass(A.to(torch.int32), W[..., :8], H[:, :8],
                               linalg.sum_axis(H[:, :8], axis=-1), EPS)
    with pytest.raises(TypeError):
        kl.kl_uht(A.double(), W, H, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        kl.kl_wtu(A.mT.contiguous().mT, W, H, EPS)


def _ell_inputs(dev, b, m, n, k, nnz_per_row, w_cap):
    """A (b-member) ELL matrix with ragged lines and COO tails (width cap
    ``w_cap``), and factors W (b, m, k), H (b, k, n)."""
    g = torch.Generator(dev)
    g.manual_seed(m * n + k)
    rows = torch.randint(0, m, (m * nnz_per_row,), generator=g, device=dev)
    cols = torch.randint(0, n, (m * nnz_per_row,), generator=g, device=dev)
    A = sparse.from_coo(rows, cols, torch.rand(rows.shape, generator=g,
                                               device=dev) + 0.1, (m, n))
    E, *perms = ell.ell_pack(A, return_perms=True, w_cap=w_cap,
                             max_tail_frac=1.0)
    data = A.data * (1 + torch.rand((b, A.nse), generator=g, device=dev))
    return (ell.ell_with_data(E, *perms, data),
            torch.rand((b, m, k), generator=g, device=dev),
            torch.rand((b, k, n), generator=g, device=dev))


# (members, m, n, nnz per row, width cap): the first three capped at 6
# slots (one partial staging chunk), the last two at 150: several chunks and
# a ragged last one at every width (the kernel stages 16 KP / 4 slots a
# chunk), 10 members in ragged groups, m and n off the lines a block takes
K4_SHAPES = [(1, 300, 97, 9, 6), (3, 1000, 777, 9, 6), (2, 77, 4000, 9, 6),
             (10, 513, 301, 40, 150), (3, 2000, 50, 9, 150)]
# every padded width of the grouped kernel, at and off it; the legacy
# kernel's (k > 32)
K4_WIDTHS = [1, 2, 3, 4, 5, 7, 8, 16, 31, 32, 33, 256]


@pytest.mark.parametrize("b,m,n,nnz_per_row,w_cap", K4_SHAPES)
@pytest.mark.parametrize("k", K4_WIDTHS)
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, b, m, n, nnz_per_row, w_cap, k, vals_dtype):
    """K4's four modes (rows/columns, plain/ratio) on a member stack,
    directly and through the ELL products with their COO tails; member 0
    of the stack equals, bitwise, a launch on member 0 alone."""
    E, W, H = _ell_inputs(cuda, b, m, n, k, nnz_per_row=nnz_per_row,
                          w_cap=w_cap)
    E = E.astype(vals_dtype)
    Ht = H.mT.contiguous()
    before = dict(ell_gather.launches)
    for v, i, T, X in _k4_modes(E, W, Ht):
        out = ell_gather.ell_gather_product(v, i, T, X, EPS)
        ref = ell_gather.ell_gather_product_plain(v, i, T, X, EPS)
        assert _rel([out], [ref]) <= 1e-4
        assert _rel([out[0]], [ell_gather.ell_gather_product(
            v[0], i, T[0], None if X is None else X[0].contiguous(), EPS)]) == 0
    assert ell_gather.launches == {
        "ell_gather": before["ell_gather"] + 4,
        "ell_gather_ratio": before["ell_gather_ratio"] + 4}
    Ec = E.to("cpu")
    Wc, Hc = W.cpu(), H.cpu()
    for out, ref in ((ell.ell_a_ht(E, H), ell.ell_a_ht(Ec, Hc)),
                     (ell.ell_wt_a(E, W), ell.ell_wt_a(Ec, Wc)),
                     (ell.ell_kl_uht(E, W, H, EPS), ell.ell_kl_uht(Ec, Wc, Hc, EPS)),
                     (ell.ell_kl_wtu(E, W, H, EPS), ell.ell_kl_wtu(Ec, Wc, Hc, EPS))):
        assert _rel([out.cpu()], [ref]) <= 1e-4


def _k4_modes(E, W, Ht):
    """(vals, idx, table, X) of K4's four modes on E with W and H^T."""
    return ((E.rvals, E.rcols, Ht, None), (E.cvals, E.crows, W, None),
            (E.rvals, E.rcols, Ht, W), (E.cvals, E.crows, W, Ht))


@pytest.mark.parametrize("k", [1, 3, 7, 16, 31])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_k4_member_groups_are_bitwise_equal(cuda, k, vals_dtype):
    """The grouped kernel gives the same bits at every member group it
    takes (1, 2, the 4 members in one group, and 8 where a line's lanes fit
    a warp), in one launch per call."""
    E, W, H = _ell_inputs(cuda, 4, 700, 333, k, nnz_per_row=30, w_cap=70)
    E = E.astype(vals_dtype)
    kp, gmax = ell_gather.geometry(k)
    groups = [g for g in (1, 2, 4, 8) if g <= gmax]
    assert groups[:3] == [1, 2, 4]
    for v, i, T, X in _k4_modes(E, W, H.mT.contiguous()):
        key = "ell_gather" if X is None else "ell_gather_ratio"
        outs = []
        for g in groups:
            before = ell_gather.launches[key]
            outs.append(ell_gather._launch(v, i, T, X, EPS, group=g))
            assert ell_gather.launches[key] == before + 1
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        assert _rel([outs[0]], [ell_gather.ell_gather_product_plain(
            v, i, T, X, EPS)]) <= 1e-4


@pytest.mark.parametrize("B,dim_t,k,G", [(10, 1000, 7, 4), (10, 333, 3, 8),
                                         (3, 50, 16, 2), (1, 77, 5, 1),
                                         (5, 9, 31, 4), (2, 1, 1, 8)])
def test_k4_table_kernel_matches_interleave(cuda, B, dim_t, k, G):
    """The card's table for the grouped kernel (one interleave kernel)
    equals the plain torch interleave, padding zeros included."""
    g = torch.Generator(cuda)
    g.manual_seed(B * dim_t + k)
    T = torch.rand((B, dim_t, k), generator=g, device=cuda)
    kp = ell_gather.geometry(k)[0]
    assert torch.equal(ell_gather.grouped_table(T, G, kp),
                       ell_gather.interleave(T, G, kp).reshape(-1))


def test_k4_geometry_and_groups_as_exported(cuda):
    """K4's geometry as the source exports it: KP the power of two from 4
    that holds k, groups only at k <= 32 and no wider than a warp's lanes
    (G KP / 4 <= 32); the plan on it keeps its invariants at the card's L2,
    and a group the kernel does not take raises."""
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    for k in range(1, ell_gather.MAX_K + 1):
        kp, gmax = ell_gather.geometry(k)
        assert kp >= max(k, 4) and (kp == 4 or kp < 2 * k)
        assert (gmax > 0) == (k <= 32) and gmax * kp <= 128
        G = ell_gather.member_groups(10, 50_000, kp, gmax, l2)
        assert (G > 0) == (k <= 32) and G <= gmax
    for k in (0, ell_gather.MAX_K + 1):
        with pytest.raises(RuntimeError, match="ell_gather_geometry"):
            ell_gather.geometry(k)
    E, W, H = _ell_inputs(cuda, 2, 64, 48, 32, nnz_per_row=3, w_cap=4)
    for bad in (3, 8):
        with pytest.raises(ValueError, match="member groups"):
            ell_gather._launch(E.rvals, E.rcols, H.mT.contiguous(), None, EPS,
                               group=bad)


def test_k4_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    E, W, H = _ell_inputs(cuda, 1, 64, 48, 257, nnz_per_row=3, w_cap=4)
    with pytest.raises(ValueError, match="k <= 256"):
        ell_gather.ell_gather_product(E.rvals, E.rcols, H.mT.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather.ell_gather_product(E.rvals, E.rcols, H.mT[..., :8])
    with pytest.raises(TypeError, match="int32"):
        ell_gather.ell_gather_product(E.rvals, E.rcols.long(), W[..., :8])
    # f64 takes the plain path on the card: the kernel accumulates in f32
    before = dict(ell_gather.launches)
    out = ell_gather.ell_gather_product(E.rvals.double(), E.rcols,
                                        W[..., :8].double().contiguous())
    assert out.dtype == torch.float64 and ell_gather.launches == before
