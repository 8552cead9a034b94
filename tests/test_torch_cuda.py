"""Kernels K1, K2a and K2b on the card against their plain versions, at
ragged shapes, every padded width of k, both A dtypes and member stacks.
These need a CUDA device and nvcc and skip without them; on a machine with a
card run ``python -m pytest -m gpu tests/test_torch_cuda.py``.

Tolerance: max |kernel - plain| / max |plain| <= 1e-4 with an f32 A (sums in
another order; K1's W'^T A also in atomic order), 1e-3 with a bf16 A (W'
rounded to bf16 where the two W' may differ in the last f32 bit)."""
import pytest
import torch

from pydnmfk_tpu_torch.ops import fused_mu, kl, linalg

pytestmark = pytest.mark.gpu
EPS = 1.19e-7
SHAPES = [(1, 64, 48), (1, 300, 200), (3, 130, 97), (2, 1000, 777)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, m, n, k, dtype):
    g = torch.Generator(dev)
    g.manual_seed(b * m * n + k)
    A = torch.rand((b, m, n), generator=g, device=dev).to(dtype)
    return (A, torch.rand((b, m, k), generator=g, device=dev),
            torch.rand((b, k, n), generator=g, device=dev))


def _rel(out, ref):
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(out, ref))


@pytest.mark.parametrize("b,m,n", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    HHT = linalg.gram_t(H)
    before = fused_mu.launches["fused_mu_fro"]
    out = fused_mu.fused_w_pass(A, W, H, HHT, EPS)
    assert fused_mu.launches["fused_mu_fro"] == before + 1
    ref = fused_mu.fused_w_pass_plain(A, W, H, HHT, EPS)
    assert _rel(out, ref) <= (1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("b,m,n", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 9, 33, 65, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(cuda, b, m, n, k, dtype):
    A, W, H = _inputs(cuda, b, m, n, k, dtype)
    out = (kl.kl_uht(A, W, H, EPS), kl.kl_wtu(A, W, H, EPS))
    ref = (kl.kl_uht_plain(A, W, H, EPS, 50), kl.kl_wtu_plain(A, W, H, EPS))
    assert _rel(out, ref) <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    A, W, H = _inputs(cuda, 1, 64, 48, 65, torch.float32)
    with pytest.raises(ValueError, match="k <= 64"):
        fused_mu.fused_w_pass(A, W, H, linalg.gram_t(H), EPS)
    with pytest.raises(TypeError):
        kl.kl_uht(A.double(), W, H, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        kl.kl_wtu(A.mT.contiguous().mT, W, H, EPS)
