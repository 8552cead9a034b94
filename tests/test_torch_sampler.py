"""pydnmfk_tpu_torch.models.sampler: the noise distributions of the
reference's sampler, and noise keyed by the global member index. torch and
jax.random draw different numbers, so distributions are compared, with
tolerances of a few standard errors of the sample size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu_torch.models import sampler as ts


def test_uniform_noise_range_and_moments():
    """X * (2 nv U + nv + 1): factors in [1 + nv, 1 + 3 nv), mean 1 + 2 nv,
    variance (2 nv)^2 / 12 (pyDNMFk.py:42-44)."""
    nv = 0.015
    A = torch.ones((200, 300), dtype=torch.float64)
    f = ts.sample_ensemble(A, 7, nv, range(4)).numpy()
    assert f.min() >= 1 + nv and f.max() < 1 + 3 * nv
    assert abs(f.mean() - (1 + 2 * nv)) < 1e-4
    assert abs(f.var() / ((2 * nv) ** 2 / 12) - 1) < 0.02
    ref = np.asarray(js.sample_ensemble(jnp.ones((200, 300)),
                                        jax.random.key(7), nv, 4))
    assert abs(f.mean() - ref.mean()) < 2e-4


def test_poisson_mean():
    A = torch.full((300, 200), 4.0, dtype=torch.float32)
    f = ts.sample_ensemble(A, 3, 0.0, range(3), "poisson").numpy()
    assert np.all(f == np.round(f)) and f.min() >= 0
    assert abs(f.mean() - 4.0) < 0.02 and abs(f.var() - 4.0) < 0.1


@pytest.mark.parametrize("method", ["uniform", "poisson"])
def test_members_do_not_depend_on_batching(method):
    """Member i's copy and init factors are the same whether it is drawn in
    one batch of 6 or in batches of 4 and 2."""
    A = torch.rand((20, 15), dtype=torch.float64) * 5
    whole = ts.sample_ensemble(A, 11, 0.03, range(6), method)
    parts = torch.cat([ts.sample_ensemble(A, 11, 0.03, range(0, 4), method),
                       ts.sample_ensemble(A, 11, 0.03, range(4, 6), method)])
    assert torch.equal(whole, parts)
    W, H = ts.init_ensemble_rand(11, range(6), 20, 15, 3, torch.float32, "cpu")
    W2, H2 = ts.init_ensemble_rand(11, range(4, 6), 20, 15, 3, torch.float32,
                                   "cpu")
    assert torch.equal(W[4:], W2) and torch.equal(H[4:], H2)
    assert not torch.equal(W[0], W[1])


def test_mixed_precision_copies_are_narrowed():
    A = torch.rand((8, 6))
    out = ts.sample_ensemble(A, 1, 0.015, range(2), dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = ts.sample_ensemble(A, 1, 0.015, range(2))
    assert torch.equal(out, ref.to(torch.bfloat16))
