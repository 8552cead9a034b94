"""pydnmfk_tpu_torch NMF against pydnmfk_tpu NMF, FRO-MU and KL-MU, with the
JAX package's init factors fed to both (torch cannot reproduce jax.random).
Tolerance: rtol 1e-9 at f64 (summation order over 50 iterations); rtol 1e-3
at f32 after 50 iterations (f32 rounding carried through the iterations)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_, x64
import pydnmfk_tpu
from pydnmfk_tpu.models import nmf as jnmf
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.utils.convert import config_from_jax, factors_from_numpy

import dataclasses

RTOL = {"float64": 1e-9, "float32": 1e-3}


def _problem(seed, m=48, n=36, k=3, b=None):
    rng = np.random.default_rng(seed)
    _, _, X = generate_data(m, n, k, seed=seed)
    lead = () if b is None else (b,)
    A = X * (1.0 + 0.05 * rng.random(lead + (m, n)))
    return A, rng.random(lead + (m, k)), rng.random(lead + (k, n))


def _jax_fit(cfg, A, W0, H0):
    with x64():
        W, H, err = pydnmfk_tpu.NMF(cfg).fit(A.astype(cfg.dtype),
                                            factors=(W0, H0))
        return np_(W), np_(H), float(err)


@pytest.mark.parametrize("norm", ["fro", "kl"])
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("W_update", [True, False])
def test_fit_matches_jax(norm, precision, W_update):
    A, W0, H0 = _problem(0)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, itr=50, precision=precision,
                                 W_update=W_update)
    Wj, Hj, ej = _jax_fit(jcfg, A, W0, H0)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    W, H, e = port.NMF(cfg).fit(A, factors=(W0, H0))
    rtol = RTOL[precision]
    np.testing.assert_allclose(np_(W), Wj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(np_(H), Hj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(e, ej, rtol=rtol)


@pytest.mark.parametrize("norm", ["fro", "kl"])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_batched_solve_matches_jax(norm, precision):
    """A stack of 3 members in one port solve against JAX's vmapped solve."""
    A, W0, H0 = _problem(1, b=3)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, itr=50, precision=precision)
    dt = jcfg.dtype
    with x64():
        Wj, Hj, ej = jnmf.solve(jnp.asarray(A, dt), jnp.asarray(W0, dt),
                                jnp.asarray(H0, dt), jnp.asarray(jcfg.eps, dt),
                                jcfg, batched=True)
        Wj, Hj, ej = np_(Wj), np_(Hj), np_(ej)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    W, H = factors_from_numpy(W0, H0, "cpu", cfg.dtype)
    Wt, Ht, et = tnmf.solve(torch.as_tensor(A).to(cfg.dtype), W, H, cfg.eps, cfg)
    rtol = RTOL[precision]
    np.testing.assert_allclose(np_(Wt), Wj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(np_(Ht), Hj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(np_(et), ej, rtol=rtol)


@pytest.mark.parametrize("batched", [False, True])
def test_tol_early_stop_matches_jax(batched):
    """The two-level tol loop, per member in a stack as under JAX's vmap
    (members stop at different checks)."""
    A, W0, H0 = _problem(2, b=3 if batched else None)
    if batched:
        A[1] = A[1] * 7.0        # members converge at different speeds
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm="fro", itr=125, tol=2e-4,
                                 tol_check_every=20, precision="float64")
    with x64():
        Wj, Hj, ej = jnmf.solve(jnp.asarray(A), jnp.asarray(W0),
                                jnp.asarray(H0), jnp.asarray(jcfg.eps), jcfg,
                                batched=batched)
        Wj, Hj, ej = np_(Wj), np_(Hj), np_(ej)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    Wt, Ht, et = tnmf.solve(*map(torch.from_numpy, (A, W0, H0)), cfg.eps, cfg)
    np.testing.assert_allclose(np_(Wt), Wj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(Ht), Hj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(et), ej, rtol=1e-9)


def test_column_err_matches_jax():
    A, W0, H0 = _problem(3)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm="fro", itr=30, precision="float64")
    with x64():
        jm = pydnmfk_tpu.NMF(jcfg)
        jm.fit(A, factors=(W0, H0))
        ref = np.asarray(jm.column_err())
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)))
    tm.fit(A, factors=(W0, H0))
    np.testing.assert_allclose(tm.column_err(), ref, rtol=1e-9)


def test_rand_init_fit_converges():
    """Without given factors the port draws its own rand init (seeded) and
    the fit reduces the error well below that of the init."""
    _, _, X = generate_data(64, 48, 3)
    cfg = port.NMFConfig(k=3, norm="fro", itr=200)
    W, H, err = port.NMF(cfg).fit(X)
    W2, H2, err2 = port.NMF(cfg).fit(X)
    assert err == err2 and err < 0.05
    assert W.shape == (64, 3) and H.shape == (3, 48)


def test_config_from_jax_rejects_unported():
    with pytest.raises(port.NotPortedError, match="ROADMAP"):
        config_from_jax(dataclasses.asdict(
            pydnmfk_tpu.NMFConfig(use_fused=True)))
    with pytest.raises(port.NotPortedError, match="ROADMAP"):
        config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
            seed_grid=(2, 2))))
    with pytest.raises(port.NotPortedError, match="nnsvd"):
        port.NMFConfig(init="nnsvd")
    cfg = config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(k=5, norm="fro"), end_k=7)))
    assert cfg.nmf.k == 5 and cfg.nmf.norm == "fro" and cfg.end_k == 7
