"""pydnmfk_tpu_torch's truncated SVD and NNDSVD init against pydnmfk_tpu's.

Eigenvectors carry an arbitrary sign, so the SVD is compared through S and
U diag(S) V^T, and NNDSVD factors only where they do not depend on it:
flag 1 (U and V flip together and the +/- parts swap), on inputs whose top
k singular values are well apart. Inputs come from numpy seeds. Tolerances:
f64 rtol 1e-10 (exact path; summation order only), the randomized path
1e-6 against the exact SVD (as tests/test_nnsvd_golden.py holds JAX's) and
1e-5 against JAX's NNDSVD factors, NMF fits rtol 1e-8 at f64 after 50
iterations."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_, x64
import pydnmfk_tpu
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu.models import svd as jsvd
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import svd as tsvd
from pydnmfk_tpu_torch.utils.convert import config_from_jax

EPS = float(np.finfo(np.float64).eps)


def _gapped(seed, m, n, k=4, top=(10.0, 7.0, 5.0, 3.0), tail=0.05):
    """A nonnegative matrix whose top singular values stand well apart
    from each other and from a small tail."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    V, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    s = np.concatenate([top, tail * rng.random(min(m, n) - len(top))])
    return np.abs((U * s) @ V.T) + rng.random((m, k)) @ rng.random((k, n))


def _usv(S, U, Vt):
    return (np_(U) * np_(S)[None, :]) @ np_(Vt)


@pytest.mark.parametrize("shape", [(50, 30), (30, 50)])
def test_svd_gram_matches_jax(shape):
    """The exact path, tall (eigh of A^T A) and wide (of A A^T)."""
    A = _gapped(0, *shape)
    with x64():
        Sj, Uj, Vj = jsvd._svd_gram(jnp.asarray(A), 4)
        ref_S, ref_usv = np_(Sj), _usv(Sj, Uj, Vj)
    S, U, Vt = tsvd._svd_gram(torch.from_numpy(A), 4)
    assert S.shape == (4,) and U.shape == (shape[0], 4)
    assert Vt.shape == (4, shape[1])
    np.testing.assert_allclose(np_(S), ref_S, rtol=1e-10)
    assert np.all(np.diff(np_(S)) < 0)
    np.testing.assert_allclose(_usv(S, U, Vt), ref_usv, rtol=0,
                               atol=1e-10 * np.abs(ref_usv).max())


def test_svd_gram_on_a_stack_is_per_member():
    """The batched path nnsvd_factors takes for the NMFk ensemble."""
    As = np.stack([_gapped(s, 40, 24) for s in (1, 2, 3)])
    S, U, Vt = tsvd._svd_gram(torch.from_numpy(As), 4)
    for i in range(3):
        Si, Ui, Vi = tsvd._svd_gram(torch.from_numpy(As[i]), 4)
        np.testing.assert_allclose(np_(S[i]), np_(Si), rtol=1e-12)
        np.testing.assert_allclose(_usv(S[i], U[i], Vt[i]),
                                   _usv(Si, Ui, Vi), atol=1e-12)


def test_distsvd_svd_and_rel_error_match_jax():
    A = _gapped(4, 60, 36)
    with x64():
        d = jsvd.DistSVD(k=4, eps=EPS)
        Sj, Uj, Vj = d.svd(jnp.asarray(A))
        ej = d.rel_error(jnp.asarray(A), Uj, Sj, Vj)
        ref_S, ref_usv = np_(Sj), _usv(Sj, Uj, Vj)
    d = tsvd.DistSVD(k=4, eps=EPS)
    At = torch.from_numpy(A)
    S, U, Vt = d.svd(At)
    np.testing.assert_allclose(np_(S), ref_S, rtol=1e-10)
    np.testing.assert_allclose(_usv(S, U, Vt), ref_usv, rtol=0,
                               atol=1e-10 * np.abs(ref_usv).max())
    np.testing.assert_allclose(d.rel_error(At, U, S, Vt), ej, rtol=1e-10)


@pytest.mark.parametrize("shape", [(50, 30), (30, 50)])
@pytest.mark.parametrize("verbose", [0, 1])
def test_nnsvd_flag1_matches_jax(shape, verbose):
    """DistSVD.nnsvd, flag 1, and its errors with verbose=1."""
    A = _gapped(5, *shape)
    with x64():
        out = jsvd.DistSVD(k=4, eps=EPS).nnsvd(jnp.asarray(A), flag=1,
                                                verbose=verbose)
    tout = tsvd.DistSVD(k=4, eps=EPS).nnsvd(torch.from_numpy(A), flag=1,
                                            verbose=verbose)
    (Wj, Hj), (W, H) = (out[0], tout[0]) if verbose else (out, tout)
    np.testing.assert_allclose(np_(W), np_(Wj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np_(H), np_(Hj), rtol=0,
                               atol=1e-10 * np.abs(np_(Hj)).max())
    np.testing.assert_allclose(np_(W).sum(0), 1.0, rtol=1e-12)
    if verbose:
        assert set(tout[1]) == {"recon_err_svd", "recon_err_nnsvd"}
        for key, val in out[1].items():
            np.testing.assert_allclose(tout[1][key], val, rtol=1e-10)


@pytest.mark.parametrize("flag", [0, 1])
def test_nnsvd_from_svd_matches_jax(flag):
    """The +/- construction and the L1 normalize-by-W on the same SVD
    factors (flag 0 depends on their signs, so both packages get the same
    ones)."""
    A = _gapped(6, 40, 30)
    U, S, Vt = np.linalg.svd(A, full_matrices=False)
    S, U, Vt = S[:4], U[:, :4], Vt[:4]
    with x64():
        Wj, Hj = jsvd._nnsvd_from_svd(*map(jnp.asarray, (S, U, Vt)), EPS,
                                      flag)
        Wj, Hj = np_(Wj), np_(Hj)
    W, H = tsvd._nnsvd_from_svd(*map(torch.from_numpy, (S, U, Vt)), EPS,
                                flag)
    np.testing.assert_allclose(np_(W), Wj, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np_(H), Hj, rtol=1e-12, atol=1e-13)
    assert (np_(W) >= 0).all() and (np_(H) >= 0).all()


def test_nnsvd_flag0_is_the_construction_of_its_svd():
    A = _gapped(7, 40, 30)
    d = tsvd.DistSVD(k=4, eps=EPS)
    At = torch.from_numpy(A)
    W, H = d.nnsvd(At, flag=0)
    W2, H2 = tsvd._nnsvd_from_svd(*d.svd(At), EPS, 0)
    np.testing.assert_array_equal(np_(W), np_(W2))
    np.testing.assert_array_equal(np_(H), np_(H2))


def test_randomized_svd_accuracy():
    """The randomized path against numpy's dense SVD on a decaying spectrum
    with noise, as tests/test_nnsvd_golden.py holds JAX's (a smaller
    size): top-k singular values and the rank-k residual."""
    m, n, k = 600, 400, 8
    rng = np.random.RandomState(11)
    U0, _ = np.linalg.qr(rng.standard_normal((m, 16)))
    V0, _ = np.linalg.qr(rng.standard_normal((n, 16)))
    A = (U0 * (10.0 * 0.5 ** np.arange(16))) @ V0.T
    A = A + 1e-6 * rng.standard_normal((m, n))
    g = torch.Generator()
    g.manual_seed(3)
    for X in (A, A.T.copy()):
        S, U, Vt = tsvd._svd_randomized(torch.from_numpy(X), g, k)
        s_all = np.linalg.svd(X, compute_uv=False)
        np.testing.assert_allclose(np_(S), s_all[:k], rtol=1e-6)
        R = X - _usv(S, U, Vt)
        assert np.linalg.norm(R) <= np.sqrt(np.sum(s_all[k:] ** 2)) * (1 + 1e-6)


def test_randomized_nnsvd_matches_jax(monkeypatch):
    """DistSVD takes the randomized path past _EXACT_GRAM_LIMIT (lowered
    here to 16 in both packages): on a gapped spectrum the NNDSVD factors
    agree with JAX's although the Gaussian starts differ."""
    monkeypatch.setattr(tsvd, "_EXACT_GRAM_LIMIT", 16)
    monkeypatch.setattr(jsvd, "_EXACT_GRAM_LIMIT", 16)
    A = _gapped(8, 120, 80, tail=1e-4)
    with x64():
        Wj, Hj = jsvd.DistSVD(k=4, eps=EPS).nnsvd(jnp.asarray(A))
        Wj, Hj = np_(Wj), np_(Hj)
    W, H = tsvd.DistSVD(k=4, eps=EPS, seed=1).nnsvd(torch.from_numpy(A))
    np.testing.assert_allclose(np_(W), Wj, rtol=0, atol=1e-5 * Wj.max())
    np.testing.assert_allclose(np_(H), Hj, rtol=0, atol=1e-5 * Hj.max())


@pytest.mark.parametrize("norm, method", [("fro", "mu"), ("kl", "mu"),
                                          ("fro", "hals"), ("fro", "bcd")])
def test_fit_with_nnsvd_init_matches_jax(norm, method):
    """NMF.fit(init="nnsvd") at f64: the init of each package from the
    same A, then the solve."""
    A = _gapped(9, 48, 36)
    jcfg = pydnmfk_tpu.NMFConfig(k=4, norm=norm, method=method, itr=50,
                                 init="nnsvd", precision="float64")
    with x64():
        Wj, Hj, ej = pydnmfk_tpu.NMF(jcfg).fit(A)
        Wj, Hj = np_(Wj), np_(Hj)
    W, H, e = port.NMF(config_from_jax(dataclasses.asdict(jcfg)),
                       "cpu").fit(A)
    np.testing.assert_allclose(np_(W), Wj, rtol=0, atol=1e-8 * Wj.max())
    np.testing.assert_allclose(np_(H), Hj, rtol=0, atol=1e-8 * Hj.max())
    np.testing.assert_allclose(e, float(ej), rtol=1e-8)


def test_ensemble_nnsvd_init_matches_jax():
    """The NMFk ensemble's init: every member's NNDSVD from its own
    perturbed copy, in one batched solve (JAX vmaps nnsvd_factors)."""
    A = _gapped(10, 40, 30)
    jcfg = pydnmfk_tpu.NMFkConfig(nmf=pydnmfk_tpu.NMFConfig(
        k=4, init="nnsvd", norm="fro", precision="float64"),
        perturbations=3)
    with x64():
        keys = js.member_keys(jax.random.key(100), 0, 3)
        A_ens = jax.vmap(lambda kk: js.sample_member(
            jnp.asarray(A), js.member_noise_key(kk), 0.015, "uniform"))(keys)
        Wj, Hj = jnmfk._draw_init_factors(jcfg.nmf, keys, A_ens, None, 40, 30)
        Wj, Hj, A_ens = np_(Wj), np_(Hj), np.asarray(A_ens)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    W, H = port.NMFk._init_members(cfg.nmf, torch.from_numpy(A_ens), None,
                                   A.shape, "cpu")
    assert W.shape == (3, 40, 4) and H.shape == (3, 4, 30)
    np.testing.assert_allclose(np_(W), Wj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np_(H), Hj, rtol=0, atol=1e-10 * Hj.max())
