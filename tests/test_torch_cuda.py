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


@pytest.mark.parametrize("b,m,n", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    hrs = linalg.sum_axis(H, axis=-1)
    before = fused_kl.launches["fused_mu_kl"]
    out = fused_kl.fused_kl_pass(A, W, H, hrs, EPS)
    assert fused_kl.launches["fused_mu_kl"] == before + 1
    ref = fused_kl.fused_kl_pass_plain(A, W, H, hrs, EPS, 50)
    assert _rel(out, ref) <= (1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("b,m,n", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 9, 33, 65, 130, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
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


@pytest.mark.parametrize("b,m,n", [(1, 300, 97), (3, 1000, 777), (2, 77, 4000)])
@pytest.mark.parametrize("k", [7, 8, 32, 256])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, b, m, n, k, vals_dtype):
    """K4's four modes (rows/columns, plain/ratio) on a member stack,
    directly and through the ELL products with their COO tails."""
    E, W, H = _ell_inputs(cuda, b, m, n, k, nnz_per_row=9, w_cap=6)
    E = E.astype(vals_dtype)
    Ht = H.mT.contiguous()
    before = dict(ell_gather.launches)
    for v, i, T, X in ((E.rvals, E.rcols, Ht, None), (E.cvals, E.crows, W, None),
                       (E.rvals, E.rcols, Ht, W), (E.cvals, E.crows, W, Ht)):
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
