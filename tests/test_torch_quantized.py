"""uint8-quantized A storage (a_precision="uint8") in pydnmfk_tpu_torch
against pydnmfk_tpu on the same numpy inputs.

Tolerances: Q and s equal JAX's exactly. The integer products (bf16
operands, f32 sums) at rtol 1e-5 (summation order). One FRO step with the
K1 plain version at rtol 5e-3 / atol 1e-4, as tests/test_fused_mu.py holds
a bf16 A. uint8 NMF.fit: KL after 30 iterations at rtol 1e-5 (its ratio
and products are f32: summation order only); FRO after 10 iterations at
rtol 3e-3 on W, H and column_err and 1e-3 on the error. FRO's products
round the factors to bf16, a one-ulp difference of f32 summation order can
flip such a rounding (a 2^-8 step of one operand), and the iterations carry
and compound the flips (about 4e-7 after 2 iterations, 5e-4 after 10)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import interpret_pallas, np_, x64  # noqa: F401  (fixture)
import pydnmfk_tpu
from pydnmfk_tpu.ops import fused_mu as jfm
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch import cli
from pydnmfk_tpu_torch.ops import fused_mu as tfm
from pydnmfk_tpu_torch.ops import linalg as tl
from pydnmfk_tpu_torch.utils.convert import config_from_jax

EPS = 1e-7


def _matrix(kind, seed=0, shape=(70, 45)):
    rng = np.random.default_rng(seed)
    if kind == "integer":                     # uint8-range data, max 255
        A = rng.integers(0, 256, size=shape).astype(np.float32)
        A.flat[0] = 255.0
        return A
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    A = rng.random(shape) * 7.3
    return A if kind == "float64" else A.astype(np.float32)


@pytest.mark.parametrize("kind", ["integer", "float", "float64", "zeros"])
def test_quantize_uint8_equals_jax(kind):
    A = _matrix(kind)
    with x64():
        Qj, sj = jl.quantize_uint8(jnp.asarray(A))
        Qj, sj = np.asarray(Qj), np.asarray(sj)
    Q, s = tl.quantize_uint8(torch.from_numpy(A))
    assert Q.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(Q.numpy(), Qj)
    assert float(s) == float(sj)
    if kind == "integer":
        assert float(s) == 1.0
        np.testing.assert_array_equal(Q.numpy().astype(np.float32), A)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_quantize_uint8_row_slabs_equal_the_whole(lead, monkeypatch):
    """Forced row slabs of 16 rows (70 rows leave a ragged last slab), for
    one matrix and for a stack, give the unchunked Q."""
    A = torch.from_numpy(_matrix("float", 1, lead + (70, 45)))
    whole = tl.quantize_uint8(A)
    monkeypatch.setattr(tl, "error_chunk_rows", lambda m, n: 16)
    slabs = tl.quantize_uint8(A)
    assert torch.equal(slabs[0], whole[0]) and torch.equal(slabs[1], whole[1])


@pytest.mark.parametrize("int_dtype,factor", [
    ("uint8", np.float32), ("int32", np.float32), ("uint8", np.float64)])
def test_integer_matmul_rule_matches_jax(int_dtype, factor):
    """An 8-bit A meets an f32 factor as bf16 operands, f32 sums, f32
    result; wider integers or f64 factors compute at the factor's
    accumulation dtype (linalg.py:60-80)."""
    rng = np.random.default_rng(2)
    A = rng.integers(0, 256, size=(40, 33)).astype(int_dtype)
    W = rng.random((40, 5)).astype(factor)
    H = rng.random((5, 33)).astype(factor)
    with x64():
        refs = [np_(jl.matmul_AHT(jnp.asarray(A), jnp.asarray(H))),
                np_(jl.matmul_WTA(jnp.asarray(W), jnp.asarray(A)))]
    At = torch.from_numpy(A)
    outs = [tl.matmul_AHT(At, torch.from_numpy(H)),
            tl.matmul_WTA(torch.from_numpy(W), At)]
    for out, ref in zip(outs, refs):
        assert out.dtype == torch.from_numpy(W).dtype
        np.testing.assert_allclose(np_(out), ref, rtol=1e-5)


def test_fused_w_pass_plain_uint8_matches_jax(interpret_pallas):
    """K1's plain version on a uint8 A: one fused FRO step against JAX's
    fused_mu_fro_step, whose Pallas kernel runs in interpret mode."""
    rng = np.random.default_rng(3)
    A = rng.integers(0, 256, size=(64, 48)).astype(np.uint8)
    W = rng.random((64, 4)).astype(np.float32)
    H = rng.random((4, 48)).astype(np.float32)
    Wj, Hj = jfm.fused_mu_fro_step(jnp.asarray(A), jnp.asarray(W),
                                   jnp.asarray(H), EPS)
    Wt, Ht = tfm.fused_mu_fro_step(*map(torch.from_numpy, (A, W, H)), EPS)
    assert Wt.dtype == torch.float32 and Ht.dtype == torch.float32
    np.testing.assert_allclose(np_(Wt), np_(Wj), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np_(Ht), np_(Hj), rtol=5e-3, atol=1e-4)


def _problem(seed=0, m=48, n=36, k=3):
    rng = np.random.default_rng(seed)
    _, _, X = generate_data(m, n, k, seed=seed)
    return (X * (1.0 + 0.05 * rng.random((m, n))), rng.random((m, k)),
            rng.random((k, n)))


@pytest.mark.parametrize("norm,itr,rtol,err_rtol", [("fro", 10, 3e-3, 1e-3),
                                                     ("kl", 30, 1e-5, 1e-5)])
def test_uint8_fit_matches_jax(norm, itr, rtol, err_rtol):
    """NMF.fit factorizes Q = round(A/s) and returns H at A's scale; W, H,
    the error and column_err (against Q) as JAX's NMF.fit gives them."""
    A, W0, H0 = _problem()
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, itr=itr, a_precision="uint8")
    jm = pydnmfk_tpu.NMF(jcfg)
    Wj, Hj, ej = jm.fit(A.astype(np.float32), factors=(W0, H0))
    colj = np.asarray(jm.column_err())
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    W, H, e = tm.fit(A, factors=(W0, H0))
    assert tm._A.dtype == torch.uint8 and tm._A.shape == A.shape
    np.testing.assert_allclose(np_(W), np_(Wj), rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(np_(H), np_(Hj), rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(e, float(ej), rtol=err_rtol)
    np.testing.assert_allclose(tm.column_err(), colj, rtol=rtol, atol=1e-9)
    # the returned H carries s: W H reconstructs A itself
    rel = np.linalg.norm(np_(W) @ np_(H) - A) / np.linalg.norm(A)
    np.testing.assert_allclose(rel, e, rtol=2e-2)


@pytest.mark.parametrize("where", ["sparse NMF.fit", "NMFk"])
def test_uint8_rejections_match_jax(where, tmp_path):
    """Both packages refuse uint8 storage for a sparse A (nmf.py:364-368)
    and for the NMFk ensemble (nmfk.py:647-652) with a ValueError."""
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    A, W0, H0 = _problem(1)
    A = A * (A > 0.5)
    if where == "NMFk":
        kw = dict(start_k=2, end_k=3, perturbations=2, checkpoint=False)
        jcfg = pydnmfk_tpu.NMFkConfig(
            nmf=pydnmfk_tpu.NMFConfig(k=3, itr=2, a_precision="uint8"),
            results_path=str(tmp_path / "jax") + "/", **kw)
        calls = [lambda: pydnmfk_tpu.NMFk(jcfg).fit(A),
                 lambda: port.NMFk(config_from_jax(dataclasses.asdict(
                     jcfg.replace(results_path=str(tmp_path) + "/"))),
                     "cpu").fit(A)]
    else:
        jcfg = pydnmfk_tpu.NMFConfig(k=3, itr=2, a_precision="uint8")
        rows, cols = np.nonzero(A)
        calls = [lambda: pydnmfk_tpu.NMF(jcfg).fit(
                     jsparse.BCOO.fromdense(jnp.asarray(A, jnp.float32)),
                     factors=(W0, H0)),
                 lambda: port.NMF(config_from_jax(dataclasses.asdict(jcfg)),
                                  "cpu").fit(sparse_from_numpy(
                                      rows, cols, A[rows, cols], A.shape),
                                      factors=(W0, H0))]
    for call in calls:
        with pytest.raises(ValueError, match="uint8"):
            call()


def test_cli_uint8_single_factorization(tmp_path):
    """--process=pyDNMF --a_precision=uint8: the quantized fit of
    NMF.fit, with the error close to the unquantized call's."""
    _, _, X = generate_data(m=64, n=48, k=3, seed=7)
    np.save(tmp_path / "X.npy", (37.0 * X).astype(np.float32))
    args = ["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1", "--ftype=npy",
            f"--fpath={tmp_path}/", "--fname=X", "--k=3", "--norm=fro",
            "--itr=200", f"--results_path={tmp_path}/res/"]
    q = cli.main(args + ["--a_precision=uint8"])
    f = cli.main(args)
    W, H, e = port.NMF(port.NMFConfig(k=3, norm="fro", itr=200,
                                      a_precision="uint8"), "cpu").fit(
        np.load(tmp_path / "X.npy"))
    assert q["err"] == e and torch.equal(q["H"], H)
    np.testing.assert_allclose(q["err"], f["err"], rtol=2e-2)
