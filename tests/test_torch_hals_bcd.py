"""pydnmfk_tpu_torch's HALS step and BCD solver against pydnmfk_tpu's, and
NMF.fit / the batched solve with each method.

Inputs come from numpy seeds and go to both packages. Tolerances (relative
to the largest value): one HALS step 1e-10 at f64, 1e-4 at f32 and on a
bf16 A (summation order only; both packages round the bf16 operands the
same way); BCD 1e-9 at f64 over 60 iterations, 1e-4 at f32 over 30; fits
1e-9 at f64 over 41-50 iterations."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_, x64
import pydnmfk_tpu
from pydnmfk_tpu.models import nmf as jnmf
from pydnmfk_tpu.models import updates as ju
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.models import updates as tu
from pydnmfk_tpu_torch.utils.convert import config_from_jax

K = 5
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _problem(seed, b=None, m=40, n=30, k=K):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    A = (rng.random(lead + (m, k)) @ rng.random(lead + (k, n))
         + 0.1 * rng.random(lead + (m, n)))
    return A, rng.random(lead + (m, k)), rng.random(lead + (k, n))


def _close(t, j, rtol):
    t, j = np_(t), np_(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * np.abs(j).max())


def _jax_hals(A, W, H, eps, W_update, block, batched):
    fn = lambda a, w, h: ju.hals_step(a, w, h, eps, W_update, block)
    return (jax.vmap(fn) if batched else fn)(A, W, H)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("W_update", [True, False])
@pytest.mark.parametrize("block", [None, 1, 3, K])
@pytest.mark.parametrize("b", [None, 3])
def test_hals_step_matches_jax(dtype, W_update, block, b):
    """One HALS step: the column sweep (None, and B = k, which JAX also
    sweeps by columns) and the delayed-update blocks (B = 1; B = 3 with a
    ragged tail of k % B = 2 columns), on one matrix and a 3-member
    stack."""
    A, W, H = (x.astype(dtype) for x in _problem(0, b))
    eps = float(np.finfo(dtype).eps)
    with x64():
        Wj, Hj = _jax_hals(*map(jnp.asarray, (A, W, H)), eps, W_update,
                           block, b is not None)
        Wj, Hj = np_(Wj), np_(Hj)
    Wt, Ht = tu.hals_step(*map(torch.from_numpy, (A, W, H)), eps, W_update,
                          block)
    assert Wt.dtype == Ht.dtype == torch.from_numpy(W).dtype
    _close(Wt, Wj, TOL[dtype])
    _close(Ht, Hj, TOL[dtype])


def _sparse_pair(fmt, A):
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu.ops.ell import ell_pack as jell_pack
    from pydnmfk_tpu_torch.ops.ell import ell_pack
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    Bj = jsparse.BCOO.fromdense(jnp.asarray(A))
    rows, cols = np.nonzero(A)
    T = sparse_from_numpy(rows, cols, A[rows, cols], A.shape)
    if fmt == "ell":
        return (jell_pack(Bj, w_cap=3, max_tail_frac=1.0),
                ell_pack(T, w_cap=3, max_tail_frac=1.0))
    return Bj, T


@pytest.mark.parametrize("fmt", ["triplet", "ell"])
@pytest.mark.parametrize("block", [None, 2])
def test_hals_step_sparse_matches_jax(fmt, block):
    """HALS on a sparse A (f64) takes its format's products: the triplet
    (the CPU's) and the dual ELL with COO tails (the card's, K4)."""
    A, W, H = _problem(1)
    A = A * (np.random.default_rng(1).random(A.shape) < 0.3)
    eps = float(np.finfo(np.float64).eps)
    with x64():
        Bj, Bt = _sparse_pair(fmt, A)
        Wj, Hj = ju.hals_step(Bj, jnp.asarray(W), jnp.asarray(H), eps, True,
                              block)
        Wj, Hj = np_(Wj), np_(Hj)
    Wt, Ht = tu.hals_step(Bt, torch.from_numpy(W), torch.from_numpy(H), eps,
                          True, block)
    _close(Wt, Wj, 1e-10)
    _close(Ht, Hj, 1e-10)


@pytest.mark.parametrize("block", [None, 3])
def test_hals_step_bf16_A_matches_jax(block):
    """A bf16 A with f32 factors: both packages round the product operands
    to bf16 and sum in f32."""
    A, W, H = (x.astype(np.float32) for x in _problem(2))
    eps = float(np.finfo(np.float32).eps)
    Wj, Hj = ju.hals_step(jnp.asarray(A, jnp.bfloat16), jnp.asarray(W),
                          jnp.asarray(H), eps, True, block)
    Wt, Ht = tu.hals_step(torch.from_numpy(A).to(torch.bfloat16),
                          torch.from_numpy(W), torch.from_numpy(H), eps, True,
                          block)
    assert Wt.dtype == torch.float32
    _close(Wt, Wj, 1e-4)
    _close(Ht, Hj, 1e-4)


@pytest.mark.parametrize("obj", ["gram", "residual"])
@pytest.mark.parametrize("dtype, itr", [(np.float64, 60), (np.float32, 30)])
def test_bcd_solve_matches_jax(obj, dtype, itr):
    """BCD's whole inner loop, both objectives; ``chunk`` sums the
    residual over row slabs of 8 rows."""
    A, W, H = (x.astype(dtype) for x in _problem(3))
    eps = float(np.finfo(dtype).eps)
    with x64():
        Wj, Hj = ju.bcd_solve(*map(jnp.asarray, (A, W, H)), eps, itr=itr,
                              obj_mode=obj)
        Wj, Hj = np_(Wj), np_(Hj)
    Wt, Ht = tu.bcd_solve(*map(torch.from_numpy, (A, W, H)), eps, itr=itr,
                          obj_mode=obj, chunk=8)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    _close(Wt, Wj, tol)
    _close(Ht, Hj, tol)


def test_bcd_stack_restores_members_apart(monkeypatch):
    """A 3-member stack in which the members restore at different
    iterations (one never): each member takes its own branch, as under
    JAX's vmap of lax.cond, and the stack equals JAX's at f64. The restore
    branch reuses the state's H H^T and A H^T, which JAX recomputes."""
    rng = np.random.default_rng(0)
    m, n, k = 40, 30, K
    A = rng.random((m, k)) @ rng.random((k, n))
    W, H = rng.random((m, k)), rng.random((k, n))
    As = np.stack([A, A + 0.3 * rng.random((m, n)), A + rng.random((m, n))])
    Ws, Hs = np.stack([W] * 3), np.stack([H] * 3)
    eps, itr = float(np.finfo(np.float64).eps), 80
    with x64():
        Wj, Hj = jax.vmap(lambda a, w, h: ju.bcd_solve(
            a, w, h, eps, itr=itr))(*map(jnp.asarray, (As, Ws, Hs)))
        Wj, Hj = np_(Wj), np_(Hj)
    restores = []
    where = torch.where

    def spy(cond, *args):
        if cond.dtype == torch.bool and cond.shape == (3, 1, 1):
            restores.append(cond.flatten().tolist())
        return where(cond, *args)

    monkeypatch.setattr(torch, "where", spy)
    Wt, Ht = tu.bcd_solve(*map(torch.from_numpy, (As, Ws, Hs)), eps, itr=itr)
    monkeypatch.undo()
    # eight selections an iteration, all on the same restore mask
    per_itr = np.array(restores[::8])
    assert per_itr.shape == (itr, 3)
    at = [set(np.nonzero(per_itr[:, i])[0]) for i in range(3)]
    assert at[0] and at[1] and at[0] != at[1] and not at[2], at
    _close(Wt, Wj, 1e-9)
    _close(Ht, Hj, 1e-9)


@pytest.mark.parametrize("itr", [11, 12])
def test_bcd_final_clip_rule(itr):
    """The solve clips BCD's factors at eps only where (itr - 1) % 10 == 0
    (JAX nmf.py:89-92): at 12 iterations the projected step's exact zeros
    stay, at 11 none is left. The batched solve equals JAX's."""
    A, W, H = _problem(4, b=2)
    jcfg = pydnmfk_tpu.NMFConfig(k=K, norm="fro", method="bcd", itr=itr,
                                 precision="float64")
    with x64():
        Wj, Hj, ej = jnmf.solve(*map(jnp.asarray, (A, W, H)),
                                jnp.asarray(jcfg.eps), jcfg, batched=True)
        Wj, Hj, ej = np_(Wj), np_(Hj), np_(ej)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    Wt, Ht, et = tnmf.solve(*map(torch.from_numpy, (A, W, H)), cfg.eps, cfg)
    _close(Wt, Wj, 1e-9)
    _close(Ht, Hj, 1e-9)
    np.testing.assert_allclose(np_(et), ej, rtol=1e-9)
    zeros = bool((Wt == 0).any() or (Ht == 0).any())
    assert zeros == (itr == 12)


@pytest.mark.parametrize("method, extra", [
    ("hals", {}), ("hals", {"hals_block": 3}), ("bcd", {}),
    ("bcd", {"bcd_obj": "residual"})])
@pytest.mark.parametrize("W_update", [True, False])
def test_fit_matches_jax(method, extra, W_update):
    """NMF.fit at f64 with the same init factors, and column_err. The BCD
    fit moves W also with W_update=False, as JAX's does."""
    A, W0, H0 = _problem(5)
    jcfg = pydnmfk_tpu.NMFConfig(k=K, norm="fro", method=method, itr=41,
                                 precision="float64", W_update=W_update,
                                 **extra)
    with x64():
        jm = pydnmfk_tpu.NMF(jcfg)
        Wj, Hj, ej = jm.fit(A, factors=(W0, H0))
        Wj, Hj, colj = np_(Wj), np_(Hj), np.asarray(jm.column_err())
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    W, H, e = tm.fit(A, factors=(W0, H0))
    np.testing.assert_allclose(np_(W), Wj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(H), Hj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(e, float(ej), rtol=1e-9)
    np.testing.assert_allclose(tm.column_err(), colj, rtol=1e-8, atol=1e-12)
    W1 = W0 / W0.sum(0)
    moved = not np.allclose(np_(W), W1, rtol=1e-6)
    assert moved == (W_update or method == "bcd")


@pytest.mark.parametrize("method, extra", [("hals", {}),
                                           ("hals", {"hals_block": 2}),
                                           ("bcd", {})])
def test_batched_solve_matches_jax(method, extra):
    """A 3-member stack in one port solve against JAX's vmapped solve."""
    A, W0, H0 = _problem(6, b=3)
    jcfg = pydnmfk_tpu.NMFConfig(k=K, norm="fro", method=method, itr=50,
                                 precision="float64", **extra)
    with x64():
        Wj, Hj, ej = jnmf.solve(*map(jnp.asarray, (A, W0, H0)),
                                jnp.asarray(jcfg.eps), jcfg, batched=True)
        Wj, Hj, ej = np_(Wj), np_(Hj), np_(ej)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    Wt, Ht, et = tnmf.solve(*map(torch.from_numpy, (A, W0, H0)), cfg.eps, cfg)
    np.testing.assert_allclose(np_(Wt), Wj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(Ht), Hj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(et), ej, rtol=1e-9)


@pytest.mark.parametrize("method", ["hals", "bcd"])
def test_kl_is_refused_for_hals_and_bcd(method):
    """HALS and BCD are Frobenius methods: the port's config raises JAX's
    ValueError, which JAX raises at its solve (nmf.py:81-82)."""
    with pytest.raises(ValueError, match="supports only norm='fro'"):
        port.NMFConfig(norm="kl", method=method)
    A, W0, H0 = _problem(7)
    with pytest.raises(ValueError, match="supports only norm='fro'"):
        pydnmfk_tpu.NMF(pydnmfk_tpu.NMFConfig(
            k=K, norm="kl", method=method, itr=2)).fit(A, factors=(W0, H0))


@pytest.mark.parametrize("flags", [["--method=bcd", "--bcd_obj=residual"],
                                   ["--method=hals"]])
def test_cli_runs_the_methods(tmp_path, flags):
    """--method and --bcd_obj run through the CLI's single factorization,
    which agrees with the library's fit of the same config."""
    from pydnmfk_tpu_torch import cli
    A, _, _ = _problem(8, m=30, n=24)
    np.save(tmp_path / "X.npy", A)
    out = cli.main(["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1",
                    "--ftype=npy", f"--fpath={tmp_path}/", "--fname=X",
                    "--k=5", "--norm=fro", "--itr=60",
                    f"--results_path={tmp_path}/res/", *flags])
    method = flags[0].split("=")[1]
    cfg = port.NMFConfig(k=5, norm="fro", itr=60, method=method,
                         bcd_obj="residual" if method == "bcd" else None)
    W, H, err = port.NMF(cfg, "cpu").fit(A.astype(np.float32))
    assert out["err"] == err and err < 0.1
    np.testing.assert_array_equal(out["W"].numpy(), W.numpy())
