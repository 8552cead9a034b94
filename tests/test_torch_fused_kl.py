"""Kernel K3's plain version (pydnmfk_tpu_torch.ops.fused_kl) against the
JAX package's one-pass KL-MU step, whose Pallas kernel runs in interpret
mode, and the use_fused switch through solve, NMFk and config_from_jax.

Tolerances: rtol 2e-5 / atol 1e-6 with an f32 A (summation order, as
tests/test_fused_mu.py holds its fused KL step). rtol 5e-3 / atol 1e-4 with
a bf16 or uint8 A: the products round W, U, W' and U' to bf16, and a
one-ulp f32 difference in summation order can flip one of those roundings
(a 2^-9 step)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import interpret_pallas, np_  # noqa: F401  (fixture)
import pydnmfk_tpu
from pydnmfk_tpu.ops import fused_kl as jfk
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.ops.pallas_kernels import fit_tile
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.ops import fused_kl as tfk
from pydnmfk_tpu_torch.utils.convert import config_from_jax

EPS = 1.19e-7
TOL = {"float32": dict(rtol=2e-5, atol=1e-6),
       "bfloat16": dict(rtol=5e-3, atol=1e-4),
       "uint8": dict(rtol=5e-3, atol=1e-4)}


def _inputs(seed, m, n, k, a_dtype="float32", b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    A = rng.random(lead + (m, n)).astype(np.float32)
    if a_dtype == "uint8":
        A = rng.integers(0, 256, size=lead + (m, n)).astype(np.uint8)
    return (A, rng.random(lead + (m, k)).astype(np.float32),
            rng.random(lead + (k, n)).astype(np.float32))


def _jax_a(A, a_dtype):
    return jnp.asarray(A, jnp.bfloat16 if a_dtype == "bfloat16" else A.dtype)


def _port_a(A, a_dtype):
    At = torch.from_numpy(A)
    return At.to(torch.bfloat16) if a_dtype == "bfloat16" else At


@pytest.mark.parametrize("m,n,k", [(300, 200, 8), (64, 48, 3), (128, 96, 8)])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16", "uint8"])
def test_step_matches_jax(m, n, k, a_dtype, interpret_pallas):
    A, W, H = _inputs(4, m, n, k, a_dtype)
    Wj, Hj = jfk.fused_mu_kl_step(_jax_a(A, a_dtype), jnp.asarray(W),
                                  jnp.asarray(H), jnp.float32(EPS))
    Wt, Ht = tfk.fused_mu_kl_step(_port_a(A, a_dtype), torch.from_numpy(W),
                                  torch.from_numpy(H), EPS)
    assert Wt.dtype == torch.float32 and Ht.dtype == torch.float32
    np.testing.assert_allclose(np_(Wt), np_(Wj), **TOL[a_dtype])
    np.testing.assert_allclose(np_(Ht), np_(Hj), **TOL[a_dtype])


@pytest.mark.parametrize("chunk", [0, 32])
def test_pass_outputs_match_jax(chunk, interpret_pallas):
    """(W', W'^T U') of the plain version, whole and in row slabs, against
    the Pallas pass itself, with A padded to its row tile as
    fused_mu_kl_step pads it (the padding rows give W' = 0, add nothing)."""
    m, n, k = 130, 97, 5
    A, W, H = _inputs(5, m, n, k)
    hrs = np.array(jl.sum_axis(jnp.asarray(H), axis=1))
    tm = fit_tile(m, jfk._pick_tm(m, n, k, 4))
    pad = (-m) % tm
    Wn, WTU = jfk._fused_kl_pass(jnp.pad(jnp.asarray(A), ((0, pad), (0, 0))),
                                 jnp.pad(jnp.asarray(W), ((0, pad), (0, 0))),
                                 jnp.asarray(H), jnp.asarray(hrs), EPS, tm)
    out = tfk.fused_kl_pass(*map(torch.from_numpy, (A, W, H, hrs)), EPS, chunk)
    np.testing.assert_allclose(np_(out[0]), np_(Wn)[:m], **TOL["float32"])
    np.testing.assert_allclose(np_(out[1]), np_(WTU), **TOL["float32"])


@pytest.mark.parametrize("a_dtype", ["float32", "uint8"])
def test_member_stack_matches_a_loop_of_members(a_dtype):
    """A 3-member stack in one call equals the step on each member alone."""
    A, W, H = _inputs(6, 72, 40, 5, a_dtype, b=3)
    Wt, Ht = tfk.fused_mu_kl_step(*map(torch.from_numpy, (A, W, H)), EPS)
    for i in range(3):
        Wi, Hi = tfk.fused_mu_kl_step(
            *map(torch.from_numpy, (A[i], W[i], H[i])), EPS)
        np.testing.assert_allclose(np_(Wt[i]), np_(Wi), rtol=1e-6)
        np.testing.assert_allclose(np_(Ht[i]), np_(Hi), rtol=1e-6)


def test_solve_fused_matches_standard():
    """use_fused=True routes the KL solve through the one-pass step, and it
    converges as the standard path does (tests/test_fused_mu.py:154-171)."""
    rng = np.random.default_rng(5)
    m, n, k = 72, 40, 3
    A = torch.from_numpy((rng.random((m, k)) @ rng.random((k, n))).astype(
        np.float32))
    W = torch.from_numpy(rng.random((m, k)).astype(np.float32))
    H = torch.from_numpy(rng.random((k, n)).astype(np.float32))
    cfg = port.NMFConfig(k=k, norm="kl", itr=30, use_fused=False)
    W1, H1, e1 = tnmf.solve(A, W, H, EPS, cfg)
    before = tfk.launches["fused_mu_kl"]
    W2, H2, e2 = tnmf.solve(A, W, H, EPS, cfg.replace(use_fused=True))
    assert tfk.launches["fused_mu_kl"] == before      # the CPU launches none
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)
    np.testing.assert_allclose(np_(W1), np_(W2), rtol=5e-3, atol=1e-5)


def _step_name(step):
    return getattr(getattr(step, "func", step), "__qualname__")


@pytest.mark.parametrize("use_fused,norm,k,precision,W_update,want", [
    (True, "kl", 8, torch.float32, True, "fused_mu_kl_step"),
    (None, "kl", 8, torch.float32, True, "mu_kl_step"),
    (False, "kl", 8, torch.float32, True, "mu_kl_step"),
    (True, "kl", 65, torch.float32, True, "mu_kl_step"),       # past MAX_K
    (True, "kl", 8, torch.float64, True, "mu_kl_step"),        # f64: plain
    (True, "kl", 8, torch.float32, False, "mu_kl_step"),       # refit
    (True, "fro", 8, torch.float32, True, "mu_fro_step"),      # the CPU
    # a bf16 or uint8 A (f32 factors): K3 up to MAX_K = 64, not past it
    (True, "kl", 64, torch.bfloat16, True, "fused_mu_kl_step"),
    (True, "kl", 65, torch.bfloat16, True, "mu_kl_step"),
    (True, "kl", 64, torch.uint8, True, "fused_mu_kl_step"),
    (True, "kl", 65, torch.uint8, True, "mu_kl_step"),
])
def test_step_for_follows_use_fused(use_fused, norm, k, precision, W_update,
                                    want):
    """``precision`` is A's dtype; the factors are f32 beside a narrow A."""
    A = torch.ones((16, 12), dtype=precision)
    narrow = precision in (torch.bfloat16, torch.uint8)
    W = torch.ones((16, k), dtype=torch.float32 if narrow else precision)
    step = tnmf.step_for(A, W, norm, W_update, 0, use_fused)
    assert _step_name(step) == want


def test_nmfk_ensemble_takes_the_fused_step(tmp_path, monkeypatch):
    """use_fused reaches the batched ensemble solve: every member stack of
    the sweep goes through the one-pass pass; the W-frozen refit does not."""
    from pydnmfk_tpu.utils.data_generator import generate_data
    calls = []
    real = tfk.fused_kl_pass

    def spy(A, *args, **kw):
        calls.append(tuple(A.shape))
        return real(A, *args, **kw)

    monkeypatch.setattr(tfk, "fused_kl_pass", spy)
    _, _, X = generate_data(m=40, n=30, k=2, seed=7)
    cfg = port.NMFkConfig(nmf=port.NMFConfig(itr=20, norm="kl",
                                             use_fused=True),
                          start_k=2, end_k=3, perturbations=4,
                          results_path=str(tmp_path) + "/", checkpoint=False)
    port.NMFk(cfg, "cpu").fit(X)
    assert len(calls) == 2 * 20 and set(calls) == {(4, 40, 30)}


# Per-k statistics of the fused KL sweep against JAX's. f32 members: rtol
# 1e-4 / atol 1e-6 (tests/test_torch_nmfk.py's sweep test; the two
# packages differ in summation order only, measured <= 2e-5). bf16 members:
# absolute 1e-3 on the statistics that live in [0, 1] (silhouettes, column
# and member relative errors) and rtol 1e-3 on AIC. The f32 ensemble test's
# rtol 1e-3 (tests/test_torch_nmf.py::test_batched_solve_matches_jax)
# cannot hold there: each step rounds U and U' to bf16 (steps of 2^-8), a
# one-ulp difference in summation order flips some of those roundings, and
# over the iterations the two ensembles drift apart by up to 6.5e-4 in
# these statistics (measured at 200 iterations; relative gaps reach a few
# per cent on the smallest column errors).
SWEEP_TOL = {None: dict(rtol=1e-4, atol=1e-6),
             "bfloat16": dict(rtol=0, atol=1e-3)}
UNIT_STATS = ("clusterSilhouetteCoefficients", "L_err", "recon_err",
              "avgSilhouetteCoefficients", "L_errDist")


@pytest.mark.parametrize("a_precision", [None, "bfloat16"])
def test_nmfk_fused_sweep_matches_jax(tmp_path, interpret_pallas,
                                      a_precision):
    """The KL NMFk sweep with use_fused=True on f32 and on bf16 members: the
    port (K3's plain version on the CPU) against pydnmfk_tpu (its Pallas
    kernel in interpret mode), the JAX package's perturbed copies and init
    factors fed to the port (members stored at a_precision by both); per-k
    statistics at SWEEP_TOL and the same k."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_nmfk import _jax_members
    from pydnmfk_tpu.utils.data_generator import generate_data
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    itr = 200
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=itr, norm="kl", method="mu",
                                  a_precision=a_precision, use_fused=True),
        start_k=2, end_k=4, perturbations=8, sill_thr=0.6,
        results_path=str(tmp_path / "jax") + "/", fname="syn",
        checkpoint=False, k_sweep_batch=False)
    jm = pydnmfk_tpu.NMFk(jcfg)
    nopt_jax = jm.fit(X)
    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/"))), "cpu")
    a_dtype = torch.bfloat16 if a_precision else torch.float32
    assert model.cfg.nmf.a_dtype == a_dtype and model.cfg.nmf.use_fused
    os.makedirs(model.results_path)
    At = torch.from_numpy(np.asarray(X, np.float32))
    calls = []
    real = tfk.fused_kl_pass

    def spy(A, *args, **kw):
        calls.append(A.dtype)
        return real(A, *args, **kw)

    tfk.fused_kl_pass = spy
    try:
        for k in jcfg.k_range:
            ens = model._solve_ensemble(At, k,
                                        members=_jax_members(jcfg, X, k))
            stats = model.pynmfk_per_k(At, k, ensemble=ens)
            ref = jm.per_k_stats[k]
            for key in (*UNIT_STATS, "AIC"):
                tol = (SWEEP_TOL[a_precision] if key in UNIT_STATS or
                       a_precision is None else dict(rtol=1e-3))
                np.testing.assert_allclose(
                    np.asarray(stats[key], np.float64),
                    np.asarray(ref[key], np.float64), **tol,
                    err_msg=f"k={k} {key}")
    finally:
        tfk.fused_kl_pass = real
    # every ensemble step went through the one-pass step, on a_dtype members
    assert len(calls) == 3 * itr and set(calls) == {a_dtype}
    assert model.pvalue_analysis() == nopt_jax


def test_config_from_jax_carries_use_fused_and_uint8():
    for use_fused in (None, True, False):
        cfg = config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFConfig(
            use_fused=use_fused, a_precision="uint8")))
        assert cfg.use_fused is use_fused and cfg.a_dtype == torch.uint8
    cfg = config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(norm="kl", use_fused=True))))
    assert cfg.nmf.use_fused is True
    with pytest.raises(port.NotPortedError, match="float16"):
        port.NMFConfig(a_precision="float16")


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Off the CPU the dispatch launches K3 or raises; here (meta tensors, no
    nvcc or card) it must raise rather than compute the plain version."""
    A, W, H = (torch.empty(s, device="meta") for s in
               [(64, 48), (64, 3), (3, 48)])
    with pytest.raises(Exception):
        tfk.fused_kl_pass(A, W, H, torch.empty((3,), device="meta"), EPS)
    assert tfk.launches["fused_mu_kl"] == 0
