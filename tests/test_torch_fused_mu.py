"""Kernel K1's plain version (pydnmfk_tpu_torch.ops.fused_mu) against the
JAX package's fused FRO-MU step, whose Pallas kernel runs in interpret mode.
Tolerance: rtol 1e-6 on W' and 1e-5 on H', WTA and WTW at f32 (summation
order); rtol 5e-3 / atol 1e-4 with a bf16 A, as tests/test_fused_mu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import interpret_pallas, np_  # noqa: F401  (fixture)
from pydnmfk_tpu.ops import fused_mu as jfm
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.ops.pallas_kernels import fit_tile
from pydnmfk_tpu_torch.ops import fused_mu as tfm
from pydnmfk_tpu_torch.ops import linalg as tl

EPS = 1e-7


def _inputs(seed, m, n, k, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    return (rng.random(lead + (m, n)).astype(np.float32),
            rng.random(lead + (m, k)).astype(np.float32),
            rng.random(lead + (k, n)).astype(np.float32))


@pytest.mark.parametrize("m,n,k", [(300, 200, 8), (64, 48, 3)])
def test_step_matches_jax(m, n, k, interpret_pallas):
    A, W, H = _inputs(0, m, n, k)
    Wj, Hj = jfm.fused_mu_fro_step(jnp.asarray(A), jnp.asarray(W),
                                   jnp.asarray(H), EPS)
    Wt, Ht = tfm.fused_mu_fro_step(*map(torch.from_numpy, (A, W, H)), EPS)
    np.testing.assert_allclose(np_(Wt), np_(Wj), rtol=1e-6)
    np.testing.assert_allclose(np_(Ht), np_(Hj), rtol=1e-5)


@pytest.mark.parametrize("m,n,k", [(300, 200, 8), (64, 48, 3)])
def test_w_pass_outputs_match_jax(m, n, k, interpret_pallas):
    """(W', W'^T A, W'^T W') of the plain version against the Pallas pass
    itself, with A padded to its row tile as fused_mu_fro_step pads it
    (the padding rows get W' = 0 and add nothing)."""
    A, W, H = _inputs(1, m, n, k)
    tm = fit_tile(m, jfm._pick_tm(m, n, k, 4))
    pad = (-m) % tm
    Aj = jnp.pad(jnp.asarray(A), ((0, pad), (0, 0)))
    Wj = jnp.pad(jnp.asarray(W), ((0, pad), (0, 0)))
    HHT = jl.gram_t(jnp.asarray(H))
    Wn, WTA, WTW = jfm._fused_w_pass(Aj, Wj, jnp.asarray(H), HHT, EPS, tm)
    At, Wt, Ht = map(torch.from_numpy, (A, W, H))
    out = tfm.fused_w_pass(At, Wt, Ht, tl.gram_t(Ht), EPS)
    np.testing.assert_allclose(np_(out[0]), np_(Wn)[:m], rtol=1e-6)
    np.testing.assert_allclose(np_(out[1]), np_(WTA), rtol=1e-5)
    np.testing.assert_allclose(np_(out[2]), np_(WTW), rtol=1e-5)


def test_bf16_a_matches_jax(interpret_pallas):
    A, W, H = _inputs(2, 128, 96, 8)
    Wj, Hj = jfm.fused_mu_fro_step(jnp.asarray(A, jnp.bfloat16),
                                   jnp.asarray(W), jnp.asarray(H), EPS)
    Wt, Ht = tfm.fused_mu_fro_step(torch.from_numpy(A).to(torch.bfloat16),
                                   torch.from_numpy(W), torch.from_numpy(H),
                                   EPS)
    assert Wt.dtype == torch.float32 and Ht.dtype == torch.float32
    np.testing.assert_allclose(np_(Wt), np_(Wj), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np_(Ht), np_(Hj), rtol=5e-3, atol=1e-4)


def test_batched_members_match_per_member_jax(interpret_pallas):
    """A 3-member stack in one call equals JAX's step on each member."""
    A, W, H = _inputs(3, 72, 40, 5, b=3)
    Wt, Ht = tfm.fused_mu_fro_step(*map(torch.from_numpy, (A, W, H)), EPS)
    for i in range(3):
        Wj, Hj = jfm.fused_mu_fro_step(jnp.asarray(A[i]), jnp.asarray(W[i]),
                                       jnp.asarray(H[i]), EPS)
        np.testing.assert_allclose(np_(Wt[i]), np_(Wj), rtol=1e-6)
        np.testing.assert_allclose(np_(Ht[i]), np_(Hj), rtol=1e-5)


@pytest.mark.parametrize("m,n", [(130, 97), (67, 208)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8])
def test_plain_w_pass_is_unchanged_by_a_bf16_rounded_h(dtype, m, n):
    """With a bf16 or uint8 A the plain version rounds H to bf16 inside its
    products, so H and H rounded to bf16 and widened back give bit-identical
    (W', W'^T A, W'^T W') with the same HHT: the kernel, which takes the
    bf16 H, computes the plain version's function."""
    A, W, H = map(torch.from_numpy, _inputs(4, m, n, 5))
    A = (A * 255).round().to(dtype) if dtype == torch.uint8 else A.to(dtype)
    HHT = tl.gram_t(H)
    out = tfm.fused_w_pass_plain(A, W, H, HHT, EPS)
    ref = tfm.fused_w_pass_plain(A, W, H.to(torch.bfloat16).float(), HHT, EPS)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Off the CPU the dispatch launches K1 or raises; here (meta tensors, no
    nvcc or card) it must raise rather than compute the plain version."""
    A, W, H = (torch.empty(s, device="meta") for s in
               [(64, 48), (64, 3), (3, 48)])
    with pytest.raises(Exception):
        tfm.fused_w_pass(A, W, H, torch.empty((3, 3), device="meta"), EPS)
    assert tfm.launches["fused_mu_fro"] == 0
