"""Kernels K2a/K2b's plain versions (pydnmfk_tpu_torch.ops.kl) against the
JAX package's Pallas kernels (interpret mode) and its row-chunked products,
at ragged shapes. Tolerance: rtol 1e-5 / atol 1e-6 at f32 (summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _k2_plan import PLAN_CASES, check_plan
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


# k = 33, 130, 300: the widths of the 3xTF32 kernels (KP = 64, 256) and
# past one slab; the Pallas kernels pad k to 128 lanes (384 at k = 300)
@pytest.mark.parametrize("m,n,k", [(70, 45, 3), (130, 97, 9), (70, 45, 33),
                                   (70, 45, 130), (70, 45, 300)])
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
    assert tkl.launches == {"kl_uht": 0, "kl_wtu": 0, "kl_uht_f16": 0,
                            "kl_wtu_f16": 0}


# (strip, chunk) of K2b's kernel: those of csrc/kl_ratio.cu at KP = 8 and
# 16, at KP = 32 and at KP > 32 (the 3xTF32 kernel), no split, and an odd
# one
GEOMETRIES = [(128, 256), (64, 256), (128, 32), (0, 0), (32, 100)]


@pytest.mark.parametrize("B,m,n,k", PLAN_CASES)
@pytest.mark.parametrize("strip,chunk", GEOMETRIES)
def test_wtu_split_plan_covers_every_row_once(B, m, n, k, strip, chunk):
    """K2b's row split (see ``_k2_plan.check_plan``)."""
    splits = check_plan(B, m, n, k, strip, chunk)
    if (B, m, n, strip) == (1, 14400, 9600, 128):
        assert splits > 1          # the refit's 75 strips leave SMs idle
    if (B, m, n, strip) == (10, 14400, 9600, 128):
        assert splits == 1         # the ensemble's 750 fill them


@pytest.mark.parametrize("k", [33, 64, 130, 300])
@pytest.mark.parametrize("b", [None, 2])
def test_plain_products_at_wide_k_match_jax(k, b):
    """K2's plain versions at the widths of the 3xTF32 kernels (KP = 64,
    128, 256) and past one slab (300), row-chunked, against the JAX
    package's chunked path, member by member for a stack."""
    A, W, H = _inputs(4, 70, 45, k, b=b)
    At, Wt, Ht = map(torch.from_numpy, (A, W, H))
    uht, wtu = tkl.kl_uht(At, Wt, Ht, EPS, 32), tkl.kl_wtu(At, Wt, Ht, EPS, 32)
    for i in ([None] if b is None else range(b)):
        sel = (lambda x: x) if i is None else (lambda x: x[i])
        Aj, Wj, Hj = (jnp.asarray(sel(x)) for x in (A, W, H))
        for want, out in (("uht", uht), ("wtu", wtu)):
            np.testing.assert_allclose(
                np_(sel(out)), np_(jkl._chunked(Aj, Wj, Hj, EPS, 32, want)),
                **TOL)


@pytest.mark.parametrize("k", [40, 300])
def test_kl_fit_at_wide_k_matches_jax(k):
    """A KL-MU NMF.fit at k = 40 and 300 (K2's 3xTF32 widths and past one
    slab on the card; the plain products here) on a small planted A, from
    the same init in both packages: factors and error within rtol 1e-3 at
    f32 after 20 iterations (f32 rounding carried through the iterations,
    as tests/test_torch_nmf.py holds f32 fits)."""
    import dataclasses

    import pydnmfk_tpu
    import pydnmfk_tpu_torch as port
    from pydnmfk_tpu.utils.data_generator import generate_data
    from pydnmfk_tpu_torch.utils.convert import config_from_jax
    rng = np.random.default_rng(6)
    _, _, X = generate_data(400, 330, 5, seed=6)
    A = (X * (1.0 + 0.05 * rng.random((400, 330)))).astype(np.float32)
    W0, H0 = rng.random((400, k)), rng.random((k, 330))
    jcfg = pydnmfk_tpu.NMFConfig(k=k, norm="kl", itr=20, precision="float32")
    Wj, Hj, ej = pydnmfk_tpu.NMF(jcfg).fit(A, factors=(W0, H0))
    W, H, e = port.NMF(config_from_jax(dataclasses.asdict(jcfg)),
                       "cpu").fit(A, factors=(W0, H0))
    np.testing.assert_allclose(np_(W), np_(Wj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np_(H), np_(Hj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(e), float(ej), rtol=1e-3)
