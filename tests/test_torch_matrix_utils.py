"""The port's ``utils/matrix_utils.py`` against the JAX package's on seeded
inputs, and ``split_files_save`` read back by the port's ``folder``
reader."""
import os

import numpy as np
import pytest

from pydnmfk_tpu.utils import matrix_utils as jmu
from pydnmfk_tpu_torch.utils import matrix_utils as mu
from pydnmfk_tpu_torch.utils.io import DataReader


def _with_zeros(shape=(12, 9, 4), seed=0):
    X = np.random.default_rng(seed).random(shape)
    X[3] = 0.0
    X[:, [1, 6]] = 0.0
    return X


def test_cut_zero_and_rec_zero():
    X = _with_zeros()
    cut, idx = mu.cut_zero(X)
    jcut, jidx = jmu.cut_zero(X)
    np.testing.assert_array_equal(cut, jcut)
    assert cut.shape == (11, 7, 4)
    for (keep, dim), (jkeep, jdim) in zip(idx, jidx):
        np.testing.assert_array_equal(keep, jkeep)
        assert dim == jdim
    back = mu.rec_zero(cut, idx, X.shape)
    np.testing.assert_array_equal(back, jmu.rec_zero(jcut, jidx, X.shape))
    np.testing.assert_array_equal(back, X)


@pytest.mark.parametrize("factor,axis", [(3, 0), (2, 1), (4, 2)])
def test_desample(factor, axis):
    X = np.random.default_rng(1).random((13, 10, 8))
    np.testing.assert_array_equal(mu.desample(X, factor, axis),
                                  jmu.desample(X, factor, axis))


def test_remove_bad_factors():
    rng = np.random.default_rng(2)
    k, p = 3, 10
    W_all, H_all = rng.random((20, k * p)), rng.random((k * p, 15))
    err = rng.random(p)
    got, want = (f(W_all, H_all, err, k) for f in (mu.remove_bad_factors,
                                                    jmu.remove_bad_factors))
    assert got[0].shape == (20, 9 * k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 97, 360, 1024, 9699690])
def test_prime_factors(n):
    assert mu.prime_factors(n) == jmu.prime_factors(n)
    assert int(np.prod(mu.prime_factors(n))) == n


def test_common_factors():
    for ints in ([12, 18], [360, 840, 96], [7, 11], [64, 32, 16]):
        assert mu.common_factors(ints) == jmu.common_factors(ints)


@pytest.mark.parametrize("pgrid", [(2, 2), (3, 1), (1, 3), (3, 2)])
def test_split_files_save_is_the_folder_layout(tmp_path, pgrid):
    A = np.random.default_rng(3).random((11, 7))
    mu.split_files_save(A, pgrid, str(tmp_path / "t"), "A_")
    jmu.split_files_save(A, pgrid, str(tmp_path / "j"), "A_")
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(f"A_{r}.npy" for r in range(pgrid[0] * pgrid[1]))
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name))
    back = DataReader(str(tmp_path / "t") + "/", "A_", "folder",
                      precision="float64", pgrid=pgrid).read()
    np.testing.assert_array_equal(back, A)


def test_mat_split(tmp_path):
    A = np.random.default_rng(4).random((8, 6))
    for root in ("t", "j"):
        os.makedirs(tmp_path / root)
        np.save(tmp_path / root / "M.npy", A)
    mu.mat_split(str(tmp_path / "t" / "M"), 2, 3)
    jmu.mat_split(str(tmp_path / "j" / "M"), 2, 3)
    names = sorted(os.listdir(tmp_path / "t" / "M"))
    assert names == sorted(os.listdir(tmp_path / "j" / "M"))
    assert len(names) == 6
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / "M" / name),
                                      np.load(tmp_path / "j" / "M" / name))
    with pytest.raises(ValueError, match="divisible"):
        mu.mat_split(str(tmp_path / "t" / "M"), 3, 3)
    with pytest.raises(ValueError, match="format"):
        mu.mat_split(str(tmp_path / "t" / "M"), 2, 3, fmt="mat")
