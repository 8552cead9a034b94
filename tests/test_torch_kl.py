"""Kernels K2a/K2b's plain versions (pydnmfk_tpu_torch.ops.kl) against the
JAX package's Pallas kernels (interpret mode) and its row-chunked products,
at ragged shapes. Tolerance: rtol 1e-5 / atol 1e-6 at f32 (summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import interpret_pallas, np_  # noqa: F401  (fixture)
from pydnmfk_tpu.ops import kl as jkl
from pydnmfk_tpu.ops.pallas_kernels import kl_uht_pallas, kl_wtu_pallas
from pydnmfk_tpu_torch.ops import kl as tkl

EPS = 1e-7
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, m, n, k, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    return (rng.random(lead + (m, n)).astype(np.float32),
            rng.random(lead + (m, k)).astype(np.float32),
            rng.random(lead + (k, n)).astype(np.float32))


@pytest.mark.parametrize("m,n,k", [(70, 45, 3), (130, 97, 9)])
@pytest.mark.parametrize("chunk", [0, 32])
def test_plain_products_match_pallas(m, n, k, chunk, interpret_pallas):
    A, W, H = _inputs(0, m, n, k)
    Aj, Wj, Hj = map(jnp.asarray, (A, W, H))
    At, Wt, Ht = map(torch.from_numpy, (A, W, H))
    np.testing.assert_allclose(np_(tkl.kl_uht(At, Wt, Ht, EPS, chunk)),
                               np_(kl_uht_pallas(Aj, Wj, Hj, EPS)), **TOL)
    np.testing.assert_allclose(np_(tkl.kl_wtu(At, Wt, Ht, EPS, chunk)),
                               np_(kl_wtu_pallas(Aj, Wj, Hj, EPS)), **TOL)


@pytest.mark.parametrize("chunk", [16, 50])
def test_plain_products_match_jax_chunked(chunk):
    """The row-chunked plain products against kl.py::_chunked (70 rows
    leave a ragged last slab)."""
    A, W, H = _inputs(1, 70, 45, 4)
    Aj, Wj, Hj = map(jnp.asarray, (A, W, H))
    At, Wt, Ht = map(torch.from_numpy, (A, W, H))
    for want, fn in (("uht", tkl.kl_uht_plain), ("wtu", tkl.kl_wtu_plain)):
        ref = jkl._chunked(Aj, Wj, Hj, EPS, chunk, want=want)
        np.testing.assert_allclose(np_(fn(At, Wt, Ht, EPS, chunk)), np_(ref),
                                   **TOL)


def test_bf16_a_products():
    """A bf16 A is widened to f32 before the ratio, as the JAX plain path
    promotes it; the products come back f32."""
    A, W, H = _inputs(2, 64, 40, 5)
    Aj = jnp.asarray(A, jnp.bfloat16)
    At = torch.from_numpy(A).to(torch.bfloat16)
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    uht = tkl.kl_uht(At, Wt, Ht, EPS)
    assert uht.dtype == torch.float32
    np.testing.assert_allclose(np_(uht), np_(jkl.kl_uht(
        Aj, jnp.asarray(W), jnp.asarray(H), EPS)), **TOL)
    np.testing.assert_allclose(np_(tkl.kl_wtu(At, Wt, Ht, EPS, 16)), np_(
        jkl.kl_wtu(Aj, jnp.asarray(W), jnp.asarray(H), EPS, 16)), **TOL)


def test_batched_members_match_per_member():
    A, W, H = _inputs(3, 40, 33, 3, b=3)
    At, Wt, Ht = map(torch.from_numpy, (A, W, H))
    uht, wtu = tkl.kl_uht(At, Wt, Ht, EPS, 16), tkl.kl_wtu(At, Wt, Ht, EPS, 16)
    for i in range(3):
        Aj, Wj, Hj = map(jnp.asarray, (A[i], W[i], H[i]))
        np.testing.assert_allclose(np_(uht[i]),
                                   np_(jkl.kl_uht(Aj, Wj, Hj, EPS)), **TOL)
        np.testing.assert_allclose(np_(wtu[i]),
                                   np_(jkl.kl_wtu(Aj, Wj, Hj, EPS)), **TOL)


@pytest.mark.parametrize("fn", [tkl.kl_uht, tkl.kl_wtu])
def test_non_cpu_tensor_never_takes_the_plain_path(fn):
    """Off the CPU the dispatch launches K2 or raises; here (meta tensors, no
    nvcc or card) it must raise rather than compute the plain version."""
    A, W, H = (torch.empty(s, device="meta") for s in
               [(64, 48), (64, 3), (3, 48)])
    with pytest.raises(Exception):
        fn(A, W, H, EPS)
    assert tkl.launches == {"kl_uht": 0, "kl_wtu": 0}
