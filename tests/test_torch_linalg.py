"""pydnmfk_tpu_torch.ops.linalg against pydnmfk_tpu.ops.linalg on the same
numpy inputs. Tolerance: rtol 1e-6 at f64 and 1e-5 at f32 (summation order
only); bf16-A products round the same operands in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_, x64
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu_torch.ops import linalg as tl

TOL = {np.float64: 1e-6, np.float32: 1e-5}


def _inputs(seed, m=70, n=40, k=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)).astype(dtype), rng.random((m, k)).astype(dtype),
            rng.random((k, n)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_same_dtype(dtype):
    A, W, H = _inputs(0, dtype=dtype)
    with x64():
        ref = np_(jl.matmul(jnp.asarray(W), jnp.asarray(H)))
    out = np_(tl.matmul(torch.from_numpy(W), torch.from_numpy(H)))
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype])


def test_matmul_bf16_a():
    """A bf16 A against an f32 factor: both rounded to bf16, summed in f32,
    returned as f32 (linalg.py:81-88)."""
    A, W, H = _inputs(1)
    Aj = jnp.asarray(A, jnp.bfloat16)
    At = torch.from_numpy(A).to(torch.bfloat16)
    ref = jl.matmul(Aj, jnp.asarray(H).T)
    out = tl.matmul(At, torch.from_numpy(H).mT)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-5)
    ref = jl.matmul_WTA(jnp.asarray(W), Aj)
    out = tl.matmul_WTA(torch.from_numpy(W), At)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-5)


@pytest.mark.parametrize("fn", ["gram", "gram_t"])
def test_grams_and_sums(fn):
    _, W, H = _inputs(2, dtype=np.float64)
    X = W if fn == "gram" else H
    with x64():
        ref = np_(getattr(jl, fn)(jnp.asarray(X)))
        ref_s = np_(jl.sum_axis(jnp.asarray(X), 0))
    np.testing.assert_allclose(np_(getattr(tl, fn)(torch.from_numpy(X))),
                               ref, rtol=1e-6)
    np.testing.assert_allclose(np_(tl.sum_axis(torch.from_numpy(X), 0)),
                               ref_s, rtol=1e-6)


@pytest.mark.parametrize("fn_name", ["relative_error", "column_error"])
@pytest.mark.parametrize("chunk", [0, 16, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_error_passes(fn_name, chunk, dtype):
    """Direct and row-chunked errors; 70 rows leave a ragged last chunk."""
    A, W, H = _inputs(3, dtype=dtype)
    with x64():
        ref = np_(getattr(jl, fn_name)(jnp.asarray(A), jnp.asarray(W),
                                       jnp.asarray(H), chunk))
    out = np_(getattr(tl, fn_name)(torch.from_numpy(A), torch.from_numpy(W),
                                   torch.from_numpy(H), chunk))
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype])


def test_relative_error_per_member():
    """A stack of members gives one error per member."""
    rng = np.random.default_rng(4)
    A, W, H = rng.random((3, 20, 12)), rng.random((3, 20, 2)), rng.random((3, 2, 12))
    out = np_(tl.relative_error(*map(torch.from_numpy, (A, W, H)), 8))
    with x64():
        ref = [float(jl.relative_error(jnp.asarray(a), jnp.asarray(w),
                                       jnp.asarray(h))) for a, w, h in zip(A, W, H)]
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_error_chunk_rows_matches_jax():
    for m, n in [(100, 100), (57600, 38400), (14400, 9600), (3000, 50000)]:
        assert tl.error_chunk_rows(m, n) == jl.error_chunk_rows(m, n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normalize_features(dtype):
    _, W, H = _inputs(5, dtype=dtype)
    eps = float(np.finfo(dtype).eps)
    with x64():
        Wj, Hj = jl.normalize_features(jnp.asarray(W), jnp.asarray(H), eps)
        Wj, Hj = np_(Wj), np_(Hj)
    Wt, Ht = tl.normalize_features(torch.from_numpy(W), torch.from_numpy(H), eps)
    np.testing.assert_allclose(np_(Wt), Wj, rtol=TOL[dtype])
    np.testing.assert_allclose(np_(Ht), Hj, rtol=TOL[dtype])
