"""Kernels K1, K2a, K2b, K3 and K4 on the card against their plain versions,
at ragged shapes (odd n, so uint8 rows are not 4-byte aligned), every padded
width of k, every A dtype (f32, bf16, f16, uint8), half factors and member
stacks. These need a CUDA device and nvcc and skip without them; on a
machine with a card run ``python -m pytest -m gpu tests/test_torch_cuda.py``.

Tolerance: max |kernel - plain| / max |plain| <= 1e-4 with an f32 A (sums in
another order, fixed: two launches give the same bits), 1e-3 with
a bf16, f16 or uint8 A in K1 and K3 (operands rounded to bf16 or f16 where
kernel and plain values may differ in the last f32 bit). K2 computes in f32
for every A dtype: 1e-4. K4 sums in another order only: 1e-4 for f32, bf16
and f16 values alike (they are widened exactly). Half factors add the
rounding of W' (K1, K3) or of the products (K2) to the factor dtype, once in
the kernel and, in K2's plain version, at every product as in the JAX
package: 1e-2 for bf16 and 2e-3 for f16 factors (a few ulps). Half factors
meet an A of their dtype, of the other half dtype, or uint8. Past f16's
range an output is inf in kernel and plain version alike, and the finite
entries are held to the same tolerances."""
import pytest
import torch

from _k2_plan import PLAN_CASES, check_plan
from pydnmfk_tpu_torch.ops import (ell, ell_gather, fused_kl, fused_mu, kl,
                                   linalg, sparse, strip)

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
          torch.float16: "fused_mu_fro_f16", torch.uint8: "fused_mu_fro_u8"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, m, n, k, dtype, w_dtype=torch.float32):
    """A (b, m, n) in dtype (a uint8 A holds 0..255), W and H in w_dtype;
    under f16 factors a uint8 A meets factors 16 times larger, which keeps
    the ratio products inside f16's range (65504)."""
    g = torch.Generator(dev)
    g.manual_seed(b * m * n + k)
    A = torch.rand((b, m, n), generator=g, device=dev)
    A = (A * 255).round().to(dtype) if dtype == torch.uint8 else A.to(dtype)
    scale = 16.0 if (dtype, w_dtype) == (torch.uint8, torch.float16) else 1.0
    return (A, (scale * torch.rand((b, m, k), generator=g, device=dev)).to(
                w_dtype),
            (scale * torch.rand((b, k, n), generator=g, device=dev)).to(
                w_dtype))


def _rel(out, ref):
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(out, ref))


DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.uint8]
# half factors and the A dtypes the kernels take with them: their own, the
# other half dtype and uint8
HALF_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.uint8, torch.bfloat16),
              (torch.float16, torch.float16), (torch.uint8, torch.float16),
              (torch.float16, torch.bfloat16), (torch.bfloat16, torch.float16)]
HALF_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}
HALF_SHAPES = [(1, 64, 48), (3, 130, 97), (2, 257, 131), (1, 129, 208),
               (2, 513, 400)]


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


@pytest.mark.parametrize("b,m,n", HALF_SHAPES)
@pytest.mark.parametrize("k", [3, 8, 17, 32, 64])
@pytest.mark.parametrize("dtype,w_dtype", HALF_PAIRS)
def test_k1_half_factors_match_plain(cuda, b, m, n, k, dtype, w_dtype):
    """Half factors: widened for the launch, W' returned at their dtype."""
    A, W, H = _inputs(cuda, b, m, n, k, dtype, w_dtype)
    HHT = linalg.gram_t(H).float()
    key = K1_KEY[dtype]
    before = dict(fused_mu.launches)
    out = fused_mu.fused_w_pass(A, W, H, HHT, EPS)
    assert fused_mu.launches == {**before, key: before[key] + 1}
    assert out[0].dtype == w_dtype and out[1].dtype == torch.float32
    ref = fused_mu.fused_w_pass_plain(A, W, H, HHT, EPS)
    assert _rel(out, ref) <= HALF_TOL[w_dtype]


# K3's f32 kernel (k <= 32) takes panels of 128 rows, sweep-1 tiles of 32
# columns, sweep-2 strips of 1024, 512, 256 columns (k <= 8, 16, 32) in
# chunks of 4, 8, 16 rows, 16-byte loads and vector atomics when n % 4 ==
# 0. Its tensor-core kernel (bf16, uint8 A, k <= 32) takes panels of 256
# rows, tiles of 64 bf16 or 128 uint8 columns and 16-byte copies when n % 8
# (bf16) or n % 16 (uint8) is 0; at k > 32 (KP = 64) tiles of 64 columns
# for every A dtype and panels of 256 rows. The f32 kernel at k > 32 (3xTF32)
# takes panels of 128 rows, sweep-1 tiles of 32 columns and sweep-2 strips
# of 128 columns in chunks of 32 rows. Shapes: m ragged at the panel
# heights (129, 257, 513: one row past whole panels), n % 4 = 1, 2, 3
# (scalar paths), n % 4 == 0 over several tiles and strips with a ragged
# last one (1040: 32 tiles and 16 columns, strips of 1024 + 16, 2 x 512 +
# 16, 4 x 256 + 16; 1540: 48 tiles and 4, strips of 1024 + 516, 3 x 512 +
# 4, 6 x 256 + 4), n below one tile (8, 20), a 10-member stack; n % 8 = 4
# (100: bf16 and uint8 on the scalar path, f32 on the 16-byte one), n % 16
# = 8 (264: uint8 scalar, bf16 16-byte) with m ragged at 256, and whole
# panels and tiles (512 x 1024); against the 128-row panels and 64-column
# tiles of k > 32: m one row past and one short of whole panels with n one
# column past a tile (129 x 65, 127 x 193), three panels and a row over whole
# 64-column tiles and a ragged 128-column strip (385 x 192), a 32-row chunk
# and a sweep-1 tile past whole ones (161 x 160), and a 256-row panel with a
# ragged second one (511 x 200).
K3_SHAPES = SHAPES + [(1, 129, 66), (2, 257, 131), (1, 257, 129),
                      (2, 65, 130), (1, 129, 1040), (2, 129, 1540),
                      (1, 33, 8), (3, 300, 20), (10, 70, 200), (1, 513, 600),
                      (2, 257, 100), (1, 513, 264), (2, 512, 1024),
                      (1, 129, 65), (2, 127, 193), (1, 385, 192),
                      (3, 161, 160), (1, 511, 200)]
K3_KEY = {torch.float32: "fused_mu_kl", torch.bfloat16: "fused_mu_kl_bf16",
          torch.float16: "fused_mu_kl_f16", torch.uint8: "fused_mu_kl_u8"}
K3_K = [1, 3, 7, 8, 9, 16, 17, 31, 32, 33, 40, 48, 56, 63, 64]


def _k3_check(A, W, H):
    """One K3 launch, under A's dtype key only (and, at k > 32, one wide
    launch under it), against the plain version."""
    hrs = linalg.sum_axis(H, axis=-1).float()
    key = K3_KEY[A.dtype]
    before = dict(fused_kl.launches)
    wide = dict(fused_kl.wide_launches)
    out = fused_kl.fused_kl_pass(A, W, H, hrs, EPS)
    assert fused_kl.launches == {**before, key: before[key] + 1}
    assert fused_kl.wide_launches == {
        **wide, key: wide[key] + (W.shape[-1] > 32)}
    assert out[0].dtype == W.dtype and out[1].dtype == torch.float32
    ref = fused_kl.fused_kl_pass_plain(A, W, H, hrs, EPS, 50)
    tol = HALF_TOL.get(W.dtype, 1e-4 if A.dtype == torch.float32 else 1e-3)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("b,m,n", K3_SHAPES)
@pytest.mark.parametrize("k", K3_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_matches_plain(cuda, b, m, n, k, dtype):
    _k3_check(*_inputs(cuda, b, m, n, k, dtype))


@pytest.mark.parametrize("b,m,n", HALF_SHAPES)
@pytest.mark.parametrize("k", [3, 8, 17, 32, 33, 48, 64])
@pytest.mark.parametrize("dtype,w_dtype", HALF_PAIRS)
def test_k3_half_factors_match_plain(cuda, b, m, n, k, dtype, w_dtype):
    _k3_check(*_inputs(cuda, b, m, n, k, dtype, w_dtype))


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_wide_launches_count_the_calls_past_k32(cuda, dtype):
    """fused_kl.wide_launches counts exactly the K3 calls with k > 32, under
    the A dtype's key; fused_kl.launches counts every call."""
    key = K3_KEY[dtype]
    ks = [8, 32, 33, 64, 17, 48]
    before = dict(fused_kl.launches)
    wide = dict(fused_kl.wide_launches)
    for k in ks:
        A, W, H = _inputs(cuda, 2, 129, 200, k, dtype)
        hrs = linalg.sum_axis(H, axis=-1).float()
        fused_kl.fused_kl_pass(A, W, H, hrs, EPS)
    assert fused_kl.launches == {**before, key: before[key] + len(ks)}
    assert fused_kl.wide_launches == {
        **wide, key: wide[key] + sum(k > 32 for k in ks)}


# K1 and K3 sum in a fixed order (two passes, no atomics): two launches give
# the same bits at every A dtype and padded width, and a member of a stack
# the bits it has alone (the second pass's row split comes from one
# member's shape, ops/strip.py::split_plan). Tall members, so that the
# second pass splits their rows; n = 777 takes the element-by-element path,
# 640 the 16-byte one.
ORDER_K = [1, 8, 32, 64]


def _fused(kernel, A, W, H):
    """K1 or K3 on (A, W, H), and the function that repeats it on the same
    (or a member's) inputs: (outputs, fn(A, W, H, member=None))."""
    if kernel == "K1":
        aux = linalg.gram_t(H)
        call = lambda a, w, h, x: fused_mu.fused_w_pass(a, w, h, x, EPS)
        plain = fused_mu.fused_w_pass_plain(A, W, H, aux, EPS)
    else:
        aux = linalg.sum_axis(H, axis=-1).float()
        call = lambda a, w, h, x: fused_kl.fused_kl_pass(a, w, h, x, EPS)
        plain = fused_kl.fused_kl_pass_plain(A, W, H, aux, EPS, 500)

    def fn(i=None):
        if i is None:
            return call(A, W, H, aux)
        return call(A[i], W[i], H[i], aux[i])
    return fn, plain


@pytest.mark.parametrize("n", [777, 640])
@pytest.mark.parametrize("k", ORDER_K)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_k1_k3_launches_are_bitwise_equal(cuda, kernel, dtype, k, n):
    fn, plain = _fused(kernel, *_inputs(cuda, 2, 3000, n, k, dtype))
    first, second = fn(), fn()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert _rel(first, plain) <= (1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("k", [8, 32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_k1_k3_member_in_a_stack_is_bitwise_alone(cuda, kernel, dtype, k):
    fn, _ = _fused(kernel, *_inputs(cuda, 10, 1500, 640, k, dtype))
    stack = fn()
    for i in (0, 7):
        alone = fn(i)
        assert all(torch.equal(s[i], a) for s, a in zip(stack, alone))


def test_second_pass_plan_on_the_exported_geometry(cuda):
    """The second pass's geometry as the source exports it (a strip of whole
    4-column groups and a chunk for every A width, ratio and k <= 64) and a
    split that does not depend on the number of members, at the smoke's
    shapes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for a_bytes in (4, 2, 1):
        for ratio in (False, True):
            for k in range(1, 65):
                s, c = strip.geometry(a_bytes, ratio, k)
                assert s > 0 and s % 4 == 0 and c > 0
            for m, n, k in ((57600, 38400, 32), (14400, 9600, 8),
                            (57600, 38400, 64), (14400, 9600, 64)):
                geo = strip.geometry(a_bytes, ratio, k)
                plan = strip.split_plan((1, m, n), k, *geo, sms)
                assert plan == strip.split_plan((10, m, n), k, *geo, sms)
                splits, rows = plan
                assert splits == -(-m // rows) and rows % geo[1] == 0
    with pytest.raises(RuntimeError, match="wtu_pass_geometry"):
        strip.geometry(4, False, 65)


def test_gram_of_a_member_is_bitwise_alone(cuda):
    """The Grams of the MU updates (W^T W, H H^T) of a member stack on the
    card: a member's is the one it has alone, as K1's and K3's sums are
    (a batched product's kernel, and its order, follow the member count)."""
    g = torch.Generator(cuda)
    g.manual_seed(3)
    W = torch.rand((10, 200000, 7), generator=g, device=cuda)
    H = torch.rand((10, 8, 9600), generator=g, device=cuda)
    assert torch.equal(linalg.gram(W)[3], linalg.gram(W[3:4])[0])
    assert torch.equal(linalg.gram_t(H)[3], linalg.gram_t(H[3:4])[0])
    assert torch.equal(linalg.gram_t(H)[3], linalg.gram_t(H[3]))


def _hot_triplet(dev):
    """A 4000 x 3000 triplet with a full row and a full column over 12000
    random entries (f32 values): each orientation's ELL tail holds a line
    of 3000-4000 entries, several levels of the ordered sum."""
    import numpy as np
    rng = np.random.default_rng(23)
    m, n = 4000, 3000
    rows = np.concatenate([rng.integers(0, m, 12000), np.full(n, 5),
                           np.arange(m)])
    cols = np.concatenate([rng.integers(0, n, 12000), np.arange(n),
                           np.full(m, 9)])
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)
    return sparse.from_coo(t(rows, torch.int32), t(cols, torch.int32),
                           t(rng.random(rows.size), torch.float32), (m, n))


@pytest.mark.parametrize("k", [3, 8, 33])
def test_sparse_sums_repeat_bitwise_and_match_the_cpu(cuda, k):
    """The ordered scatter-adds of the triplet's products and of the dual
    ELL's tails: two runs on the card give the same bits, a member of a
    stack the bits it has alone, and the sums themselves (one thread adds a
    run in order) the CPU's bits on the same values. The whole ELL products
    (K4 and the tails) repeat bitwise too."""
    A = _hot_triplet(cuda)
    (m, n), g = A.shape, torch.Generator(cuda)
    g.manual_seed(k)
    W = torch.rand((3, m, k), generator=g, device=cuda)
    H = torch.rand((3, k, n), generator=g, device=cuda)
    E = ell.ell_pack(A)
    assert E.rtail_d.numel() > 2000 and E.ctail_d.numel() > 2000
    sums = [
        lambda W, H: sparse.a_ht_triplet(A, H),
        lambda W, H: sparse.wt_a_triplet(A, W),
        lambda W, H: sparse.kl_uht_sparse(A, W, H, EPS),
        lambda W, H: sparse.kl_wtu_sparse(A, W, H, EPS),
        lambda W, H: sparse.a_ht(E.rtail_d, E.rtail_r, E.rtail_c, H, m),
        lambda W, H: sparse.wt_a(E.ctail_d, E.ctail_r, E.ctail_c, W, n)]
    for f in sums:
        first = f(W, H)
        assert torch.equal(first, f(W, H))
        assert torch.equal(first[1], f(W[1], H[1]))
    W0, H0 = W[0], H[0]        # K4 takes one member on one ELL
    for f in (lambda: sparse.col_sqsum(A.data, A.cols, n),
              lambda: ell.ell_col_sqsum(E), lambda: ell.ell_wt_a(E, W0),
              lambda: ell.ell_a_ht(E, H0),
              lambda: ell.ell_kl_uht(E, W0, H0, EPS),
              lambda: ell.ell_kl_wtu(E, W0, H0, EPS)):
        assert torch.equal(f(), f())
    for idx, other, nlines in ((A.rows, A.cols, m), (A.cols, A.rows, n),
                               (E.ctail_c, E.ctail_r, n)):
        (sel, levels), = sparse.line_plan(idx, nlines)
        assert len(levels) > 1
        vals = W[:, other[sel], :]
        got = sparse.ordered_sum(vals, levels)
        want = sparse.ordered_sum(vals.cpu(), [x.cpu() for x in levels])
        assert torch.equal(got.cpu(), want)


# K2's register kernels (k <= 32), as UhtGeom and WtuGeom in
# csrc/kl_ratio.cu have them: K2b strips of 128 columns (64 at k > 16) over
# W chunks of 256 rows; K2a row tiles of 16, 32, 64 rows (k <= 8, 16, 32)
# over double-buffered H tiles of 512 columns (256 at k > 16); 16-byte
# loads when n % 4 == 0. Its 3xTF32 kernels (k > 32, KP = 64, 128, 256):
# K2a row tiles of 128 rows over H tiles of 32 columns, K2b strips of 128
# columns over W chunks of 32 rows, and past k = 256 slabs of 256 output
# columns, each over every chunk of 256 factors. Shapes: n ragged at the
# strip widths with n % 4 = 1, 2, 3 (scalar path) and 0, m ragged at the row
# tiles, n % 4 == 0 over several H tiles with a ragged last one (n = 1040:
# 2 or 4 whole tiles at k <= 16 or k > 16, then 16 columns; n = 1540: 3 or
# 6, then 4), a 10-member stack, and single members tall enough for K2b's
# row split (ops/kl.py::wtu_split_plan). Widths: every KP at and off it, and
# the slab boundaries 256 / 257 and 300 (a second slab of 44 columns).
K2_SHAPES = SHAPES + [(1, 257, 129), (1, 129, 130), (2, 65, 131),
                      (1, 33, 260), (10, 70, 200), (1, 3000, 260),
                      (1, 2100, 67), (1, 300, 1040), (2, 129, 1540)]
K2_K = [1, 3, 7, 8, 9, 16, 17, 31, 32, 33, 64, 65, 128, 129, 130, 256, 257,
        300]


def _k2_keys(dtype):
    """K2's launch keys for an A of dtype: an f16 A counts apart."""
    tag = "_f16" if dtype == torch.float16 else ""
    return f"kl_uht{tag}", f"kl_wtu{tag}"


@pytest.mark.parametrize("b,m,n", K2_SHAPES)
@pytest.mark.parametrize("k", K2_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    before = dict(kl.launches)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
    assert kl.launches == {**before, **{key: before[key] + 1
                                        for key in _k2_keys(dtype)}}
    ref = (kl.kl_uht_plain(A, W, H, EPS, 50), kl.kl_wtu_plain(A, W, H, EPS))
    assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("b,m,n", HALF_SHAPES)
@pytest.mark.parametrize("k", [3, 8, 17, 32, 65])
@pytest.mark.parametrize("dtype,w_dtype", HALF_PAIRS)
def test_k2_half_factors_match_plain(cuda, b, m, n, k, dtype, w_dtype):
    """Half factors: widened for the launch, the f32 sums rounded once to
    their dtype; the plain version rounds W H, U and each product."""
    A, W, H = _inputs(cuda, b, m, n, k, dtype, w_dtype)
    before = dict(kl.launches)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
    assert kl.launches == {**before, **{key: before[key] + 1
                                        for key in _k2_keys(dtype)}}
    # A's and the factors' common dtype, as the plain version's: the factor
    # dtype, but f32 for one half dtype against the other
    assert out[0].dtype == out[1].dtype == torch.promote_types(dtype, w_dtype)
    ref = (kl.kl_uht_plain(A, W, H, EPS, 50), kl.kl_wtu_plain(A, W, H, EPS))
    assert ref[0].dtype == ref[1].dtype == out[0].dtype
    assert _rel(out, ref) <= 2 * HALF_TOL[w_dtype]


def _overflow_inputs(dev, b, m, n, k, kernel):
    """A uint8 A under f16 factors that passes f16's range on purpose: its
    first m // 4 rows ("hot") hold 128..255, the others 0 or 1, and the
    factors lie in [0.5, 1) times a scale. K1's and K3's W' is about
    2 A / (k H) row by row, so with W at 1000 and H at 3e-4 / k the hot rows
    of W' come to 5e5 or more and the others to 4e3 or less; K2's U H^T is
    about 2 n A / (k W), so with W at 3.8e-4 n / k and H at 4 its hot rows
    come to about 1e6 while U, W^T U and the other rows stay below 1.3e4
    (measured on the CPU with the plain versions)."""
    g = torch.Generator(dev)
    g.manual_seed(b * m * n + k)
    hot = m // 4
    A = torch.randint(0, 2, (b, m, n), generator=g, device=dev)
    A[:, :hot] = torch.randint(128, 256, (b, hot, n), generator=g, device=dev)
    u = lambda *s: 0.5 + 0.5 * torch.rand(s, generator=g, device=dev)
    w, h = (3.8e-4 * n / k, 4.0) if kernel == "K2" else (1000.0, 3e-4 / k)
    return (A.to(torch.uint8), (w * u(b, m, k)).half(),
            (h * u(b, k, n)).half(), hot)


@pytest.mark.parametrize("b,m,n", HALF_SHAPES)
@pytest.mark.parametrize("k", [3, 8, 17, 32, 64])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_f16_overflow_is_inf_where_plain_is(cuda, b, m, n, k, kernel):
    """At f16 factors an output past 65504 is inf, as in the JAX package:
    the kernel gives inf exactly where its plain version does (the hot rows
    of W', or of U H^T, and nowhere else), and the finite entries agree to
    the half-factor tolerances above."""
    A, W, H, hot = _overflow_inputs(cuda, b, m, n, k, kernel)
    if kernel == "K1":
        HHT = linalg.gram_t(H.float())
        out = fused_mu.fused_w_pass(A, W, H, HHT, EPS)
        ref = fused_mu.fused_w_pass_plain(A, W, H, HHT, EPS)
        tol = HALF_TOL[torch.float16]
    elif kernel == "K2":
        out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
        ref = (kl.kl_uht_plain(A, W, H, EPS, 50),
               kl.kl_wtu_plain(A, W, H, EPS))
        tol = 2 * HALF_TOL[torch.float16]
    else:
        hrs = linalg.sum_axis(H, axis=-1).float()
        out = fused_kl.fused_kl_pass(A, W, H, hrs, EPS)
        ref = fused_kl.fused_kl_pass_plain(A, W, H, hrs, EPS, 50)
        tol = HALF_TOL[torch.float16]
    assert out[0].dtype == torch.float16
    assert out[0][:, :hot].isinf().all() and out[0][:, hot:].isfinite().all()
    for o, r in zip(out, ref):
        assert torch.equal(o.isinf(), r.isinf())
        assert not o.isnan().any() and not r.isnan().any()
        fin = r.isfinite()
        o, r = o.double()[fin], r.double()[fin]
        assert float((o - r).abs().max() / r.abs().max()) <= tol


@pytest.mark.parametrize("b,m,n", [(10, 70, 200), (1, 3000, 260),
                                   (1, 2100, 67)])
@pytest.mark.parametrize("k", [3, 8, 32, 65, 130, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_launches_are_bitwise_equal(cuda, b, m, n, k, dtype):
    """Partial sums meet in a fixed order (no atomics; K2b's row split adds
    its slabs in split order): two launches give the same bits."""
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    for fn in (kl.kl_uht, kl.kl_wtu):
        assert torch.equal(fn(A, W, H, EPS), fn(A, W, H, EPS))


@pytest.mark.parametrize("splits", [1, 2, 3, 12])
@pytest.mark.parametrize("k", [8, 64, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2b_given_splits_matches_plain(cuda, splits, k, dtype):
    """K2b with its rows cut into as many splits as asked (at most one per
    W chunk) on a 2-member stack, and one launch per call: the register
    kernel (k = 8), the 3xTF32 one (64) and its two slabs (300)."""
    A, W, H = _inputs(cuda, 2, 3000, 260, k, dtype)
    key = _k2_keys(dtype)[1]
    before = kl.launches[key]
    out = kl.kl_wtu(A, W, H, EPS, splits=splits)
    assert kl.launches[key] == before + 1
    assert _rel([out], [kl.kl_wtu_plain(A, W, H, EPS)]) <= 1e-4


def test_wtu_split_plan_on_the_exported_geometry(cuda):
    """K2b's geometry as the source exports it: a strip of whole 4-column
    groups and a chunk at every k (the register kernels' up to 32, the
    3xTF32 kernels' of 128 columns and 32 rows above), and a plan that keeps
    the split's invariants (``_k2_plan.check_plan``) on it; k < 1 raises."""
    for k in range(1, 301):
        strip, chunk = kl.wtu_geometry(k)
        assert strip > 0 and strip % 4 == 0 and chunk > 0
        if k > 32:
            assert (strip, chunk) == (128, 32)
    for B, m, n, k in PLAN_CASES:
        check_plan(B, m, n, k, *kl.wtu_geometry(k))
    # the single-member refit at k > 32 splits its rows too
    assert check_plan(1, 14400, 9600, 64, *kl.wtu_geometry(64)) > 1
    with pytest.raises(RuntimeError, match="kl_wtu_geometry"):
        kl.wtu_geometry(0)


@pytest.mark.parametrize("k", [40, 130, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_misaligned_a_matches_plain(cuda, k, dtype):
    """A contiguous A that starts one element past a 16-byte boundary takes
    the element-by-element path of the 3xTF32 kernels."""
    b, m, n = 2, 257, 528
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    buf = torch.empty(A.numel() + 1, dtype=dtype, device=cuda)
    Av = buf[1:].view(b, m, n)
    Av.copy_(A)
    assert Av.is_contiguous() and Av.data_ptr() % 16 != 0
    out = (kl.kl_uht(Av, W, H, EPS), kl.kl_wtu(Av, W, H, EPS))
    ref = (kl.kl_uht_plain(A, W, H, EPS, 50), kl.kl_wtu_plain(A, W, H, EPS))
    assert _rel(out, ref) <= 1e-4


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
    with pytest.raises(ValueError, match="k >= 1"):
        kl.kl_uht(A, W[..., :0].contiguous(), H[:, :0].contiguous(), EPS)


@pytest.mark.parametrize("k", [257, 300, 600])
def test_k2_wrappers_take_every_k(cuda, k):
    """Past 256 the wrappers raise no more: one launch each, in slabs of
    256 output columns, against the plain version."""
    A, W, H = _inputs(cuda, 1, 300, 200, k, torch.float32)
    before = dict(kl.launches)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
    assert kl.launches == {**before, "kl_uht": before["kl_uht"] + 1,
                           "kl_wtu": before["kl_wtu"] + 1}
    ref = (kl.kl_uht_plain(A, W, H, EPS), kl.kl_wtu_plain(A, W, H, EPS))
    assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("k", [40, 300])
def test_kl_fit_on_the_card_runs_k2(cuda, k):
    """A KL-MU NMF.fit at k = 40 and 300 launches K2a and K2b once an
    iteration and nothing else, and ends within 1e-3 of the CPU path's
    relative error from the same init."""
    import numpy as np
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    _, _, X = generate_data(m=400, n=330, k=5)
    rng = np.random.default_rng(0)
    W0, H0 = rng.random((400, k)), rng.random((k, 330))
    cfg = NMFConfig(k=k, norm="kl", itr=20)
    counters = (fused_mu.launches, kl.launches, fused_kl.launches,
                ell_gather.launches)
    before = [dict(c) for c in counters]
    _, _, err = NMF(cfg, cuda).fit(X, factors=(W0, H0))
    ran = [{key: c[key] - b[key] for key in c} for c, b in zip(counters, before)]
    assert ran[1] == {"kl_uht": 20, "kl_wtu": 20, "kl_uht_f16": 0,
                      "kl_wtu_f16": 0}
    assert not any(v for i in (0, 2, 3) for v in ran[i].values())
    _, _, err_cpu = NMF(cfg, "cpu").fit(X, factors=(W0, H0))
    assert abs(err / err_cpu - 1) <= 1e-3


def test_sparse_kl_fit_at_k300_runs_k4_in_slabs(cuda):
    """A KL-MU NMF.fit at k = 300 on a sparse A in the dual ELL format on
    the card (K4 past its widest slab of 256, so in two slabs however small
    the tables: 20 ratio calls, each a dot pass and a plain pass, and one
    plain call for the final error, all counted as calls past k = 32 and
    as calls in slabs) ends
    within 1e-3 of the CPU path's relative error (the triplet's plain
    products) from the same init."""
    import numpy as np
    from pydnmfk_tpu_torch import NMF, NMFConfig
    rng = np.random.default_rng(3)
    m, n, k = 400, 330, 300
    rows = rng.integers(0, m, 8000)
    cols = rng.integers(0, n, 8000)
    A = sparse.from_coo(torch.from_numpy(rows).int(), torch.from_numpy(cols).int(),
                        torch.from_numpy(rng.random(8000) + 0.1).float(), (m, n))
    E = ell.ell_pack(A.to(cuda), max_tail_frac=1.0)
    assert E is not None
    W0, H0 = rng.random((m, k)), rng.random((k, n))
    cfg = NMFConfig(k=k, norm="kl", itr=10)
    counters = (ell_gather.launches, ell_gather.wide_launches,
                ell_gather.slab_launches)
    before = [dict(c) for c in counters]
    _, _, err = NMF(cfg, cuda).fit(E, factors=(W0, H0))
    for c, b in zip(counters, before):
        assert {key: c[key] - b[key] for key in c} == {
            "ell_gather": 1, "ell_gather_ratio": 20, "ell_gather_f16": 0,
            "ell_gather_ratio_f16": 0}
    _, _, err_cpu = NMF(cfg, "cpu").fit(A, factors=(W0, H0))
    assert abs(err / err_cpu - 1) <= 1e-3


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
# every padded width of the grouped kernel, at and off it; past 32 the
# slab kernels in one slab (the tables fit the L2) and, past the widest
# slab of 256, in two (the ratio modes in two passes)
K4_WIDTHS = [1, 2, 3, 4, 5, 7, 8, 16, 31, 32, 33, 64, 128, 256, 257, 300]
VALS_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _k4_keys(vals_dtype):
    """K4's plain and ratio launch keys: f16 values count apart."""
    tag = "_f16" if vals_dtype == torch.float16 else ""
    return f"ell_gather{tag}", f"ell_gather_ratio{tag}"


@pytest.mark.parametrize("b,m,n,nnz_per_row,w_cap", K4_SHAPES)
@pytest.mark.parametrize("k", K4_WIDTHS)
@pytest.mark.parametrize("vals_dtype", VALS_DTYPES)
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
    plain, ratio = _k4_keys(vals_dtype)
    assert ell_gather.launches == {**before, plain: before[plain] + 4,
                                   ratio: before[ratio] + 4}
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
@pytest.mark.parametrize("vals_dtype", VALS_DTYPES)
def test_k4_member_groups_are_bitwise_equal(cuda, k, vals_dtype):
    """The grouped kernel gives the same bits at every member group it
    takes (1, 2, the 4 members in one group, and 8 where a line's lanes fit
    a warp), in one launch per call."""
    E, W, H = _ell_inputs(cuda, 4, 700, 333, k, nnz_per_row=30, w_cap=70)
    E = E.astype(vals_dtype)
    kp, gmax, _ = ell_gather.geometry(k)
    groups = [g for g in (1, 2, 4, 8) if g <= gmax]
    assert groups[:3] == [1, 2, 4]
    for v, i, T, X in _k4_modes(E, W, H.mT.contiguous()):
        key = _k4_keys(vals_dtype)[X is not None]
        outs = []
        for g in groups:
            before = ell_gather.launches[key]
            outs.append(ell_gather._launch(v, i, T, X, EPS, group=g))
            assert ell_gather.launches[key] == before + 1
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        assert _rel([outs[0]], [ell_gather.ell_gather_product_plain(
            v, i, T, X, EPS)]) <= 1e-4


@pytest.mark.parametrize("b,m,n,nnz_per_row,w_cap", K4_SHAPES)
@pytest.mark.parametrize("k", [33, 100, 300])
@pytest.mark.parametrize("vals_dtype", VALS_DTYPES)
def test_k4_slab_widths_agree(cuda, b, m, n, nnz_per_row, w_cap, k,
                              vals_dtype):
    """The slab kernels at slab widths forced through ``_launch(slab=)``,
    from 4 and 16 columns (the KP = 32 kernels with idle lanes) through
    widths off the sectors and the powers of two to the widest, 256 (one
    slab up to k = 256): the plain modes give the same bits at every width
    (each column summed by one lane in slot order), the ratio modes (one
    pass in one slab, the dot pass and the plain pass in several) agree
    with the plain version within 1e-4. Each call counts one launch and
    one call past k = 32, and one call in slabs where it takes more than
    one."""
    E, W, H = _ell_inputs(cuda, b, m, n, k, nnz_per_row=nnz_per_row,
                          w_cap=w_cap)
    E = E.astype(vals_dtype)
    widths = (4, 16, 24, 56, 64, 100, 128, 256)
    for v, i, T, X in _k4_modes(E, W, H.mT.contiguous()):
        key = _k4_keys(vals_dtype)[X is not None]
        ref = ell_gather.ell_gather_product_plain(v, i, T, X, EPS)
        outs = []
        for slab in widths:
            counters = (ell_gather.launches, ell_gather.wide_launches,
                        ell_gather.slab_launches)
            before = [c[key] for c in counters]
            outs.append(ell_gather._launch(v, i, T, X, EPS, slab=slab))
            several = slab < k
            assert [c[key] for c in counters] == [before[0] + 1, before[1] + 1,
                                                  before[2] + several]
            assert _rel([outs[-1]], [ref]) <= 1e-4
        if X is None:
            assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("B,dim_t,k,slab", [(10, 1000, 300, 56), (3, 333, 33, 16),
                                            (1, 77, 64, 64), (2, 50, 41, 41),
                                            (5, 9, 257, 256), (2, 1, 35, 13)])
def test_k4_slab_table_kernel_matches_plain(cuda, B, dim_t, k, slab):
    """The card's slab table (one kernel) equals the plain torch one,
    padding zeros included; T itself at one slab of k where k % 4 == 0."""
    g = torch.Generator(cuda)
    g.manual_seed(B * dim_t + k)
    T = torch.rand((B, dim_t, k), generator=g, device=cuda)
    table = ell_gather.slab_table(T, slab)
    assert torch.equal(table.reshape(-1),
                       ell_gather.slab_table_plain(T, slab))
    assert (table.data_ptr() == T.data_ptr()) == (slab == k and k % 4 == 0)


@pytest.mark.parametrize("b,m,n,nnz_per_row,w_cap", K4_SHAPES[:3])
@pytest.mark.parametrize("k", [3, 8, 32, 33])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float16])
def test_k4_half_tables_match_plain(cuda, b, m, n, nnz_per_row, w_cap, k,
                                    w_dtype):
    """Half factors (the NMF at bf16 or f16): the table and X are widened
    to f32 for the launch, exactly, so kernel and plain version sum the same
    products; f16 values under f16 factors, bf16 under bf16."""
    E, W, H = _ell_inputs(cuda, b, m, n, k, nnz_per_row=nnz_per_row,
                          w_cap=w_cap)
    E, W, H = E.astype(w_dtype), W.to(w_dtype), H.to(w_dtype)
    before = dict(ell_gather.launches)
    for v, i, T, X in _k4_modes(E, W, H.mT.contiguous()):
        out = ell_gather.ell_gather_product(v, i, T, X, EPS)
        assert out.dtype == torch.float32
        ref = ell_gather.ell_gather_product_plain(v, i, T, X, EPS)
        assert _rel([out], [ref]) <= 1e-4
    plain, ratio = _k4_keys(w_dtype)
    assert ell_gather.launches == {**before, plain: before[plain] + 2,
                                   ratio: before[ratio] + 2}


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
    """K4's geometry as the source exports it: at k <= 32 KP the power of
    two from 4 that holds k and groups no wider than a warp's lanes (G KP /
    4 <= 32), past 32 no groups and the widest slab, the one that the
    memory model plans on off the card; the plans on it keep their
    invariants at the card's L2, and a group or slab the kernel does not
    take raises."""
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    for k in range(1, 301):
        kp, gmax, smax = ell_gather.geometry(k)
        if k > 32:
            assert (kp, gmax, smax) == (0, 0, ell_gather.MAX_SLAB)
            ks, count = ell_gather.slab_plan(102_660, k, l2, smax)
            assert count == -(-k // ks) and ks <= smax
            continue
        assert kp >= max(k, 4) and (kp == 4 or kp < 2 * k) and smax == 0
        assert gmax > 0 and gmax * kp <= 128
        G = ell_gather.member_groups(10, 50_000, kp, gmax, l2)
        assert 0 < G <= gmax
    with pytest.raises(RuntimeError, match="ell_gather_geometry"):
        ell_gather.geometry(0)
    E, W, H = _ell_inputs(cuda, 2, 64, 48, 32, nnz_per_row=3, w_cap=4)
    for bad in (3, 8):
        with pytest.raises(ValueError, match="member groups"):
            ell_gather._launch(E.rvals, E.rcols, H.mT.contiguous(), None, EPS,
                               group=bad)
    with pytest.raises(ValueError, match="slabs past k = 32"):
        ell_gather._launch(E.rvals, E.rcols, H.mT.contiguous(), None, EPS,
                           slab=16)
    E, W, H = _ell_inputs(cuda, 2, 64, 48, 40, nnz_per_row=3, w_cap=4)
    for bad in (0, 257):
        with pytest.raises(ValueError, match="slabs of 1 to 256"):
            ell_gather._launch(E.rvals, E.rcols, H.mT.contiguous(), None, EPS,
                               slab=bad)
    with pytest.raises(ValueError, match="member groups"):
        ell_gather._launch(E.rvals, E.rcols, H.mT.contiguous(), None, EPS,
                           group=1)


def test_k4_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    E, W, H = _ell_inputs(cuda, 1, 64, 48, 257, nnz_per_row=3, w_cap=4)
    # k = 257 raises no more: one launch, in slabs, against the plain version
    before = ell_gather.launches["ell_gather"]
    out = ell_gather.ell_gather_product(E.rvals, E.rcols, H.mT.contiguous())
    assert ell_gather.launches["ell_gather"] == before + 1
    assert _rel([out], [ell_gather.ell_gather_product_plain(
        E.rvals, E.rcols, H.mT.contiguous())]) <= 1e-4
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather.ell_gather_product(E.rvals, E.rcols, H.mT[..., :8])
    with pytest.raises(TypeError, match="int32"):
        ell_gather.ell_gather_product(E.rvals, E.rcols.long(), W[..., :8])
    # f64 takes the plain path on the card: the kernel accumulates in f32
    before = dict(ell_gather.launches)
    out = ell_gather.ell_gather_product(E.rvals.double(), E.rcols,
                                        W[..., :8].double().contiguous())
    assert out.dtype == torch.float64 and ell_gather.launches == before


# (k active, K): a K-padded NMFk stack (models/nmfk.py, k_sweep_batch) at
# K's register kernels, and past 32, where K2 takes its 3xTF32 kernels, K1
# and K3 their KP = 64 kernels and K4 its slab kernels even for k = 3
PADDED = [(3, 7), (3, 40)]


def _padded(W, H, K):
    """W (..., m, k) and H (..., k, n) zero-padded to K columns."""
    k = W.shape[-1]
    pad = lambda X, d: torch.cat([X, X.new_zeros(
        X.shape[:d] + (K - k,) + X.shape[d + 1:])], d)
    return pad(W, W.dim() - 1), pad(H, H.dim() - 2)


def _check_padded(outs, unpadded, plain, k, tol):
    """Each output's K axes (-1 for (..., K), -2 for (..., K, n), both for
    (..., K, K)): exactly 0 past the k active columns, the active block
    within ``tol`` of the unpadded call, the whole within ``tol`` of the
    plain version on the padded inputs."""
    active = []
    for x in outs:
        axes = [a for a in (-2, -1) if x.shape[a] != unpadded[len(active)]
                .shape[a]]
        sl = [slice(None)] * x.dim()
        for a in axes:
            rest = list(sl)
            rest[a] = slice(k, None)
            assert not x[tuple(rest)].any()
            sl[a] = slice(None, k)
        active.append(x[tuple(sl)])
    assert _rel(active, unpadded) <= tol
    assert _rel(outs, plain) <= tol


@pytest.mark.parametrize("k,K", PADDED)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K1", "K2a", "K2b", "K3"])
def test_padded_stack_keeps_inactive_columns_zero(cuda, kernel, dtype, k, K):
    """K1, K2a, K2b and K3 on a 3-member stack of k = 3 factors padded
    with zeros to K columns, as the K-padded sweep hands them on: the
    outputs' inactive columns (W', U H^T, W'^T A, W'^T W', W^T U) are
    exactly 0, the active ones within the kernel's limit (1e-4 with an f32
    A and in K2; 1e-3 with a narrow A in K1 and K3) of the kernel on the
    unpadded stack and of the plain version."""
    A, W, H = _inputs(cuda, 3, 130, 97, k, dtype)
    Wp, Hp = _padded(W, H, K)
    hrs = lambda H: linalg.sum_axis(H, axis=-1).float()
    run, plain = {
        "K1": (lambda W, H: fused_mu.fused_w_pass(A, W, H, linalg.gram_t(H),
                                                  EPS),
               lambda W, H: fused_mu.fused_w_pass_plain(
                   A, W, H, linalg.gram_t(H), EPS)),
        "K2a": (lambda W, H: (kl.kl_uht(A, W, H, EPS),),
                lambda W, H: (kl.kl_uht_plain(A, W, H, EPS),)),
        "K2b": (lambda W, H: (kl.kl_wtu(A, W, H, EPS),),
                lambda W, H: (kl.kl_wtu_plain(A, W, H, EPS),)),
        "K3": (lambda W, H: fused_kl.fused_kl_pass(A, W, H, hrs(H), EPS),
               lambda W, H: fused_kl.fused_kl_pass_plain(A, W, H, hrs(H),
                                                         EPS, 50))}[kernel]
    narrow = kernel in ("K1", "K3") and dtype != torch.float32
    _check_padded(run(Wp, Hp), run(W, H), plain(Wp, Hp), k,
                  1e-3 if narrow else 1e-4)


@pytest.mark.parametrize("k,K", PADDED)
@pytest.mark.parametrize("vals_dtype", VALS_DTYPES)
def test_k4_padded_stack_keeps_inactive_columns_zero(cuda, vals_dtype, k, K):
    """K4's four modes on a 10-member ELL stack with k = 3 factors padded
    to K columns: the inactive columns exactly 0, the active ones within
    1e-4 of K4 on the unpadded factors and of the plain version."""
    E, W, H = _ell_inputs(cuda, 10, 513, 301, k, nnz_per_row=40, w_cap=150)
    E = E.astype(vals_dtype)
    Wp, Hp = _padded(W, H, K)
    for padded, unpadded in zip(_k4_modes(E, Wp, Hp.mT.contiguous()),
                                _k4_modes(E, W, H.mT.contiguous())):
        _check_padded((ell_gather.ell_gather_product(*padded, EPS),),
                      (ell_gather.ell_gather_product(*unpadded, EPS),),
                      (ell_gather.ell_gather_product_plain(*padded, EPS),),
                      k, 1e-4)


@pytest.mark.parametrize("norm, kw, want, tol", [
    ("fro", {}, {"fused_mu_fro": 1}, 1e-5),
    ("fro", {"a_precision": "uint8"}, {"fused_mu_fro_u8": 1}, 1e-5),
    ("kl", {}, {"kl_uht": 1, "kl_wtu": 1}, 1e-5),
    ("kl", {"a_precision": "bfloat16", "use_fused": True},
     {"fused_mu_kl_bf16": 1}, 5e-4)])
def test_checkpointed_fit_on_the_card_resumes(cuda, tmp_path, monkeypatch,
                                              norm, kw, want, tol):
    """NMF.fit with solve_checkpoint_every=10 over 40 iterations launches its
    kernel once an iteration (40), ends within ``tol`` of the unchunked
    solve's error, and after a failure right after its second save resumes
    with exactly 20 launches, within ``tol`` again, and removes its
    checkpoint. The runs differ only where K1 and K3 add W'^T A in atomic
    order: 1e-5, but K3 on a bf16 A rounds W' and its ratios to bf16
    operands, so that such a difference can flip a rounding: on this
    400 x 330 matrix a resumed K3 solve ended 7.5e-5 from the unchunked
    one (H100)."""
    import numpy as np
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.utils import checkpoint
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    _, _, X = generate_data(m=400, n=330, k=5)
    X = X.astype(np.float32)
    counters = (fused_mu.launches, kl.launches, fused_kl.launches,
                ell_gather.launches)

    def fit(cfg):
        before = [dict(c) for c in counters]
        _, _, err = NMF(cfg, cuda).fit(X)
        ran = {key: c[key] - b[key] for c, b in zip(counters, before)
               for key in c}
        return err, {key: n for key, n in ran.items() if n}

    cfg = NMFConfig(k=8, norm=norm, itr=40, results_path=str(tmp_path), **kw)
    err0, ran = fit(cfg)
    assert ran == {key: 40 * n for key, n in want.items()}
    cfg = cfg.replace(solve_checkpoint_every=10)
    err1, ran = fit(cfg)
    assert ran == {key: 40 * n for key, n in want.items()}
    assert abs(err1 / err0 - 1) <= tol
    real = checkpoint.SolveCheckpoint.save
    saves = []

    def failing(self, W, H, i):
        real(self, W, H, i)
        saves.append(i)
        if len(saves) == 2:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(checkpoint.SolveCheckpoint, "save", failing)
    with pytest.raises(RuntimeError, match="preemption"):
        fit(cfg)
    monkeypatch.undo()
    assert (tmp_path / "solve_ckpt_k8").exists()
    err2, ran = fit(cfg)
    assert ran == {key: 20 * n for key, n in want.items()}
    assert abs(err2 / err0 - 1) <= tol
    assert not (tmp_path / "solve_ckpt_k8").exists()


def test_resumed_sweep_on_the_card_solves_only_the_missing_members(
        cuda, tmp_path, monkeypatch):
    """An FRO-MU NMFk sweep at k = 2..4, 6 members in batches of 3, failed
    right after k = 3's first part and run again: K1 launches for k = 3's
    second batch and k = 4's two (3 x 50 iterations), none in the refits,
    and each k's errors within 1e-4 of an unbroken sweep's."""
    import numpy as np
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.models import nmfk
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    from pydnmfk_tpu_torch.utils.io import read_cluster_results
    _, _, X = generate_data(m=400, n=330, k=3)
    X = X.astype(np.float32)

    def cfg(path):
        return NMFkConfig(nmf=NMFConfig(norm="fro", itr=50), start_k=2,
                          end_k=4, perturbations=6, ensemble_batch=3,
                          results_path=str(path) + "/", fname="X",
                          checkpoint=True)

    NMFk(cfg(tmp_path / "gold"), cuda).fit(X)
    real = nmfk._save_ensemble_part

    def failing(parts_dir, off, *a):
        real(parts_dir, off, *a)
        if off == 0 and parts_dir.endswith("/3/ensemble_parts"):
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(nmfk, "_save_ensemble_part", failing)
    with pytest.raises(RuntimeError, match="preemption"):
        NMFk(cfg(tmp_path / "run"), cuda).fit(X)
    monkeypatch.undo()
    before = dict(fused_mu.launches)
    NMFk(cfg(tmp_path / "run"), cuda).fit(X)
    assert fused_mu.launches["fused_mu_fro"] - before["fused_mu_fro"] == 150
    for k in (2, 3, 4):
        a, b = (read_cluster_results(str(tmp_path / d / "X" / str(k)))
                for d in ("run", "gold"))
        np.testing.assert_allclose(a["ErrTol"], b["ErrTol"], rtol=1e-4)
        assert not (tmp_path / "run" / "X" / str(k) / "ensemble_parts"
                    ).exists()


class _OneRank:
    """A grid of one rank, as far as ``sparse.grid_format`` needs it."""
    shape, rank, n_ranks = (1, 1), 0, 1

    def rows(self, m):
        return 0, m

    def cols(self, n):
        return 0, n

    def max(self, x, over="rc"):
        return x


def test_grid_format_on_the_card(cuda):
    """auto packs a block whose column lines are mostly empty (as a 4 x 1
    block of a topic matrix's are) in the dual ELL, whose products (K4)
    agree with the triplet's; a block that refuses the ELL runs the
    triplet under a warning, and a forced "ell" raises."""
    g = torch.Generator(cuda)
    g.manual_seed(19)
    m, n = 400, 800
    rows = torch.arange(m, device=cuda).repeat_interleave(60)
    cols = torch.randint(0, n // 8, (rows.numel(),), generator=g,
                         device=cuda)
    T = sparse.from_coo(rows, cols, torch.rand(rows.numel(), generator=g,
                                               device=cuda), (m, n))
    assert ell.ell_pack(T) is None
    G = sparse.grid_format(T, _OneRank())
    assert isinstance(G.local, ell.EllSparse) and G.agreed
    W = torch.rand((m, 5), generator=g, device=cuda)
    H = torch.rand((5, n), generator=g, device=cuda)
    before = ell_gather.launches["ell_gather"]
    got = (linalg.matmul_AHT(G.local, H), linalg.matmul_WTA(W, G.local))
    assert ell_gather.launches["ell_gather"] == before + 2
    assert _rel(got, [sparse.a_ht_triplet(T, H),
                      sparse.wt_a_triplet(T, W)]) <= 1e-4
    skewed = sparse.from_coo(torch.cat([torch.zeros(n, device=cuda).long(),
                                        torch.arange(1, m, device=cuda)]),
                             torch.cat([torch.arange(n, device=cuda),
                                        torch.arange(1, m, device=cuda)]),
                             torch.rand(n + m - 1, generator=g, device=cuda),
                             (m, n))
    with pytest.warns(UserWarning, match="triplet"):
        G = sparse.grid_format(skewed, _OneRank())
    assert isinstance(G.local, sparse.SparseTriplet)
    with pytest.raises(ValueError, match="does not ELL-pack"):
        sparse.grid_format(skewed, _OneRank(), "ell")
