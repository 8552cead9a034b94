"""pydnmfk_tpu_torch clustering against pydnmfk_tpu's ``_fit_impl`` on random
and planted ensembles (f32). The alignment permutations must be equal, so
the permuted H_all, the centroids and the MADs agree at rtol/atol 1e-5
(f32 summation order).

Silhouettes agree at atol 5e-4 per member and 1e-4 per cluster. The
reference's distance includes each column's distance to itself, arccos of a
self-similarity that f32 rounds to 1 +- a few ulps; arccos(1 - 1.2e-7) is
4.9e-4, so a one-ulp difference in a normalized column (from the norms'
summation order) moves that term by up to ~5e-4 and a silhouette averaged
over the p - 1 other members by ~1e-4. Fed the same W, the two silhouette
functions agree to 3e-7."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_
from pydnmfk_tpu.models import clustering as jc
from pydnmfk_tpu_torch.models import clustering as tc

EPS = float(np.finfo(np.float32).eps)
TOL = dict(rtol=1e-5, atol=1e-5)
SIL_TOL = {"cluster_sils": 1e-4, "avg_sil": 1e-4, "sils": 5e-4}


def _random(seed, p=7, m=40, k=4, n=12):
    rng = np.random.default_rng(seed)
    return (rng.random((p, m, k)).astype(np.float32),
            rng.random((p, k, n)).astype(np.float32))


def _planted(seed, p=8, m=60, k=5, n=10):
    """Members are one W with shuffled columns plus small noise."""
    rng = np.random.default_rng(seed)
    W = rng.random((m, k)) ** 4
    H = rng.random((k, n))
    Ws, Hs = [], []
    for _ in range(p):
        perm = rng.permutation(k)
        Ws.append(W[:, perm] * (1 + 0.05 * rng.random((m, k))))
        Hs.append(H[perm] * (1 + 0.05 * rng.random((k, n))))
    return np.float32(Ws), np.float32(Hs)


@pytest.mark.parametrize("make,seed", [(_random, 0), (_random, 1),
                                       (_planted, 2), (_planted, 3)])
def test_cluster_ensemble_matches_jax(make, seed):
    W_all, H_all = make(seed)
    ref = jc.cluster_ensemble(jnp.asarray(W_all), jnp.asarray(H_all), EPS)
    out = tc.cluster_ensemble(torch.from_numpy(W_all),
                              torch.from_numpy(H_all), EPS)
    names = ["centroids", "cent_std", "H_all", "cluster_sils", "avg_sil",
             "sils"]
    for name, o, r in zip(names, out, ref):
        tol = dict(rtol=0, atol=SIL_TOL[name]) if name in SIL_TOL else TOL
        np.testing.assert_allclose(np_(o), np_(r), err_msg=name, **tol)


def test_silhouettes_match_jax_on_the_same_ensemble():
    W_all, H_all = _random(6)
    W = tc.normalize_by_w(torch.from_numpy(W_all), torch.from_numpy(H_all),
                          EPS)[0]
    np.testing.assert_allclose(np_(tc._silhouettes(W)),
                               np_(jc._silhouettes(jnp.asarray(W.numpy()))),
                               rtol=0, atol=1e-6)


def test_greedy_assignment_matches_jax():
    rng = np.random.default_rng(4)
    for k in (1, 2, 5, 9):
        for _ in range(5):
            d = rng.random((k, k)).astype(np.float32)
            d[0, :] = d[0, 0]          # ties: the first maximum wins
            np.testing.assert_array_equal(
                tc.greedy_assignment(d),
                np.asarray(jc.greedy_assignment(jnp.asarray(d))))


@pytest.mark.parametrize("p", [5, 6])
def test_median_matches_numpy(p):
    x = np.random.default_rng(p).random((p, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(tc.median0(torch.from_numpy(x))),
                               np.median(x, axis=0), rtol=1e-7)


def test_single_column_ensemble():
    """k = 1: silhouettes are 1 by definition (clustering.py:138-139)."""
    W_all, H_all = _random(5, k=1)
    out = tc.cluster_ensemble(torch.from_numpy(W_all), torch.from_numpy(H_all),
                              EPS)
    assert float(out[4]) == 1.0 and out[5].shape == (1, 7)
