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
    W, H, e = port.NMF(cfg, "cpu").fit(A, factors=(W0, H0))
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
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    tm.fit(A, factors=(W0, H0))
    np.testing.assert_allclose(tm.column_err(), ref, rtol=1e-9)


def test_rand_init_fit_converges():
    """Without given factors the port draws its own rand init (seeded) and
    the fit reduces the error well below that of the init."""
    _, _, X = generate_data(64, 48, 3)
    cfg = port.NMFConfig(k=3, norm="fro", itr=200)
    W, H, err = port.NMF(cfg, "cpu").fit(X)
    W2, H2, err2 = port.NMF(cfg, "cpu").fit(X)
    assert err == err2 and err < 0.05
    assert W.shape == (64, 3) and H.shape == (3, 48)


def test_config_from_jax_rejects_unported():
    with pytest.raises(port.NotPortedError, match="ROADMAP"):
        config_from_jax(dataclasses.asdict(
            pydnmfk_tpu.NMFConfig(use_pallas=True)))
    with pytest.raises(port.NotPortedError, match="ROADMAP"):
        config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
            seed_grid=(2, 2))))
    with pytest.raises(port.NotPortedError, match="nnsvd"):
        port.NMFConfig(init="nnsvd")
    cfg = config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(k=5, norm="fro"), end_k=7)))
    assert cfg.nmf.k == 5 and cfg.nmf.norm == "fro" and cfg.end_k == 7


# ---------------------------------------------------------------------------
# sparse A: the triplet (the CPU's format) and the dual ELL (the card's),
# against the JAX package on BCOO and on its EllSparse, same init factors.
# Tolerance: rtol 1e-9 at f64 (summation order); the bf16-A case at rtol
# 1e-3 after 50 iterations at f32.
# ---------------------------------------------------------------------------
def _sparse_problem(seed, m=48, n=36, k=3, density=0.3):
    rng = np.random.default_rng(seed)
    A = rng.random((m, k)) @ rng.random((k, n)) * (rng.random((m, n)) < density)
    return A, rng.random((m, k)), rng.random((k, n))


def _jax_format(A, fmt, dtype):
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu.ops.ell import ell_pack
    B = jsparse.BCOO.fromdense(jnp.asarray(A, dtype))
    return ell_pack(B, w_cap=3, max_tail_frac=1.0) if fmt == "ell" else B


def _port_format(A, fmt, dtype):
    from pydnmfk_tpu_torch.ops.ell import ell_pack
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    rows, cols = np.nonzero(A)
    T = sparse_from_numpy(rows, cols, A[rows, cols].astype(dtype), A.shape)
    return ell_pack(T, w_cap=3, max_tail_frac=1.0) if fmt == "ell" else T


@pytest.mark.parametrize("fmt", ["triplet", "ell"])
@pytest.mark.parametrize("norm", ["fro", "kl"])
@pytest.mark.parametrize("W_update", [True, False])
def test_sparse_fit_matches_jax(fmt, norm, W_update):
    """NMF.fit on a sparse A at f64, with the same init factors; the ELL
    case has COO tails (width cap 3). W_update=False is the W-frozen refit
    of NMFk. column_err goes through the sparse identity too."""
    A, W0, H0 = _sparse_problem(4)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, itr=50, precision="float64",
                                 W_update=W_update)
    with x64():
        Bj = _jax_format(A, fmt, np.float64)
        jm = pydnmfk_tpu.NMF(jcfg)
        Wj, Hj, ej = jm.fit(Bj, factors=(W0, H0))
        Wj, Hj, colj = np_(Wj), np_(Hj), np.asarray(jm.column_err())
    At = _port_format(A, fmt, np.float64)
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    W, H, e = tm.fit(At, factors=(W0, H0))
    np.testing.assert_allclose(np_(W), Wj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(H), Hj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(e, float(ej), rtol=1e-9)
    np.testing.assert_allclose(tm.column_err(), colj, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("fmt", ["triplet", "ell"])
def test_sparse_fit_bf16_values_match_jax(fmt):
    """a_precision="bfloat16" applies to the nnz values (nmf.py:369-381)."""
    A, W0, H0 = _sparse_problem(5)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm="fro", itr=50,
                                 a_precision="bfloat16")
    Bj, At = _jax_format(A, fmt, np.float32), _port_format(A, fmt, np.float32)
    jm = pydnmfk_tpu.NMF(jcfg)
    Wj, Hj, ej = jm.fit(Bj, factors=(W0, H0))
    assert jm._A.dtype == jnp.bfloat16
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    W, H, e = tm.fit(At, factors=(W0, H0))
    assert tm._A.dtype == torch.bfloat16
    np.testing.assert_allclose(np_(W), np_(Wj), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(e, float(ej), rtol=1e-3)


@pytest.mark.parametrize("kw", [dict(method="bcd"), dict(init="nnsvd"),
                                dict(a_precision="uint8")])
def test_sparse_rejections_are_the_configs(kw):
    """The JAX package rejects BCD, nnsvd, prune and uint8 storage for a
    sparse A. BCD, nnsvd and prune are not ported, so the port's config
    refuses them before any A is seen; uint8 storage is ported for a dense
    A, and NMF.fit refuses it on a sparse A with the JAX package's
    ValueError (nmf.py:364-368)."""
    assert not hasattr(port.NMFConfig(), "prune")
    if "a_precision" not in kw:
        with pytest.raises(port.NotPortedError):
            port.NMFConfig(**kw)
        return
    A, W0, H0 = _sparse_problem(6)
    with pytest.raises(ValueError, match="uint8"):
        port.NMF(port.NMFConfig(k=3, itr=2, **kw), "cpu").fit(
            _port_format(A, "triplet", np.float32), factors=(W0, H0))


def test_entry_points_default_to_the_card():
    """NMF, NMFk and Runner run on the CUDA card unless the caller passes
    device="cpu"; without a card, fit/run say so."""
    assert port.NMF(port.NMFConfig()).device.type == "cuda"
    assert port.NMFk(port.NMFkConfig()).device.type == "cuda"
    assert port.Runner().device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing raises")
    A = np.ones((8, 6))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.NMF(port.NMFConfig(k=2, itr=2)).fit(A)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.NMFk(port.NMFkConfig(nmf=port.NMFConfig(itr=2), end_k=2)).fit(A)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.Runner(itr=2).run(fpath="/nonexistent/", ftype="npy", fname="A")
