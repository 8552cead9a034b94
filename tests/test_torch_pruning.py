"""pydnmfk_tpu_torch's zero-row/column pruning against pydnmfk_tpu's: the
masks, the pruned A, W and H, the unprune, NMF.fit with ``prune=True``
(each method) and one NMFk per-k run with HALS, nnsvd and prune through
the ``members=`` path.

Inputs come from numpy seeds: planted matrices with all-zero rows and
columns. Tolerances: the masks and gathers are exact; fits at f64 rtol 1e-9
(summation order over the iterations); the NMFk per-k stats rtol 1e-4 (f64;
clustering's arccos amplifies summation order near identical columns)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import np_, x64
import pydnmfk_tpu
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu.utils import pruning as jp
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.utils import pruning as tp
from pydnmfk_tpu_torch.utils.convert import config_from_jax

ZERO_ROWS, ZERO_COLS = (0, 7, 21), (3, 4, 29)


def _planted(seed, m=40, n=32, k=3):
    """A planted rank-k matrix with the rows ZERO_ROWS and the columns
    ZERO_COLS all zero, and init factors of the full shape."""
    rng = np.random.default_rng(seed)
    A = rng.random((m, k)) @ rng.random((k, n)) + 0.01 * rng.random((m, n))
    A[list(ZERO_ROWS)] = 0.0
    A[:, list(ZERO_COLS)] = 0.0
    return A, rng.random((m, k)), rng.random((k, n))


def test_zero_masks_match_jax():
    A, _, _ = _planted(0)
    rows, cols = tp.zero_masks(torch.from_numpy(A))
    rj, cj = jp.zero_masks(jnp.asarray(A, jnp.float32))
    np.testing.assert_array_equal(rows, rj)
    np.testing.assert_array_equal(cols, cj)
    assert rows.dtype == bool and not rows[list(ZERO_ROWS)].any()
    assert not cols[list(ZERO_COLS)].any() and cols.sum() == 32 - 3


@pytest.mark.parametrize("zeros", [True, False])
def test_prune_all_and_unprune_match_jax(zeros):
    """prune_all's arrays and state, and unprune_factors of the pruned
    factors, equal JAX's; without zero rows or columns nothing changes."""
    A, W, H = _planted(1)
    if not zeros:
        A = A + 1.0
    At, Wt, Ht, st = tp.prune_all(*map(torch.from_numpy, (A, W, H)))
    Aj, Wj, Hj, sj = jp.prune_all(*(jnp.asarray(x, jnp.float32)
                                    for x in (A, W, H)))
    for t, j in ((At, Aj), (Wt, Wj), (Ht, Hj)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(np_(t), np_(j), rtol=1e-7)
    np.testing.assert_array_equal(st.row_mask, sj.row_mask)
    np.testing.assert_array_equal(st.col_mask, sj.col_mask)
    assert (st.n_rows_full, st.n_cols_full) == (sj.n_rows_full,
                                                sj.n_cols_full)
    assert st.pruned == zeros
    Wf, Hf = tp.unprune_factors(Wt, Ht, st)
    Wfj, Hfj = jp.unprune_factors(Wj, Hj, sj)
    np.testing.assert_allclose(np_(Wf), np_(Wfj), rtol=1e-7)
    np.testing.assert_allclose(np_(Hf), np_(Hfj), rtol=1e-7)
    assert Wf.shape == (40, 3) and Hf.shape == (3, 32)
    if zeros:
        assert not Wf[list(ZERO_ROWS)].any()
        assert not Hf[:, list(ZERO_COLS)].any()


def test_prune_A_matches_jax():
    A, _, _ = _planted(2)
    At, st = tp.prune_A(torch.from_numpy(A))
    Aj, sj = jp.prune_A(jnp.asarray(A, jnp.float32))
    np.testing.assert_allclose(np_(At), np_(Aj), rtol=1e-7)
    assert At.shape == (37, 29) and At.is_contiguous()
    np.testing.assert_array_equal(st.col_mask, sj.col_mask)
    col = np.arange(29, dtype=np.float64) + 1.0
    full = tp.unprune_columns(col, st)
    assert full.shape == (32,) and not full[list(ZERO_COLS)].any()
    np.testing.assert_array_equal(full[st.col_mask], col)


@pytest.mark.parametrize("norm, method", [("fro", "mu"), ("kl", "mu"),
                                          ("fro", "hals"), ("fro", "bcd")])
def test_fit_with_prune_matches_jax(norm, method):
    """NMF.fit(prune=True) at f64 with the same full-shape init factors:
    the factors come back at the full shape with zero rows and columns,
    and column_err is zero at the pruned columns."""
    A, W0, H0 = _planted(3)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, method=method, itr=41,
                                 precision="float64", prune=True)
    with x64():
        jm = pydnmfk_tpu.NMF(jcfg)
        Wj, Hj, ej = jm.fit(A, factors=(W0, H0))
        Wj, Hj, colj = np_(Wj), np_(Hj), np.asarray(jm.column_err())
    tm = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu")
    W, H, e = tm.fit(A, factors=(W0, H0))
    assert W.shape == (40, 3) and H.shape == (3, 32)
    np.testing.assert_allclose(np_(W), Wj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(H), Hj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(e, float(ej), rtol=1e-9)
    col = tm.column_err()
    np.testing.assert_allclose(col, colj, rtol=1e-8, atol=1e-12)
    assert col.shape == (32,) and not col[list(ZERO_COLS)].any()
    assert not np_(W)[list(ZERO_ROWS)].any()


def _jax_pruned_members(jcfg, X, k):
    """The perturbed copies the JAX per-k ensemble program draws from the
    pruned A (nmfk.py:705-716, :105-115)."""
    ncfg = jcfg.nmf.replace(k=k)
    A, _ = jp.prune_A(jnp.asarray(X, ncfg.dtype))
    keys = js.member_keys(jax.random.key(ncfg.seed), 0, jcfg.perturbations)
    return np.array(jax.vmap(lambda kk: js.sample_member(
        A, js.member_noise_key(kk), jcfg.noise_var, jcfg.sampling))(keys))


def test_nmfk_hals_nnsvd_prune_per_k_matches_jax(tmp_path):
    """One NMFk per-k run with HALS, nnsvd and prune: the port takes JAX's
    perturbed copies of the pruned A and makes its own nnsvd init of each
    (members=(A_ens, None, None)). AIC from the unpruned dims, L_err zero
    at the pruned columns and AvgW/AvgH at the full shape agree with
    JAX's."""
    _, _, X = generate_data(m=48, n=36, k=3, seed=100)
    X[[2, 30]] = 0.0
    X[:, [5, 6, 33]] = 0.0
    k = 3
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=200, norm="fro", method="hals",
                                  init="nnsvd", prune=True,
                                  precision="float64"),
        start_k=k, end_k=k, perturbations=6, sill_thr=0.6,
        results_path=str(tmp_path / "jax") + "/", fname="syn",
        checkpoint=False, k_sweep_batch=False)
    with x64():
        jm = pydnmfk_tpu.NMFk(jcfg)
        jm.fit(X)
        ref = jm.per_k_stats[k]
        A_ens = _jax_pruned_members(jcfg, X, k)
    jdir = os.path.join(jm.results_path, str(k))
    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/"))), "cpu")
    os.makedirs(model.results_path)
    At = model._prepare(X)
    assert At.shape == (46, 33) and model._orig_shape == (48, 36)
    ens = model._solve_ensemble(At, k, members=(A_ens, None, None))
    stats = model.pynmfk_per_k(At, k, ensemble=ens)
    for key in ("clusterSilhouetteCoefficients", "L_err", "recon_err"):
        np.testing.assert_allclose(np.asarray(stats[key]),
                                   np.asarray(ref[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    for key in ("avgSilhouetteCoefficients", "AIC", "L_errDist"):
        np.testing.assert_allclose(stats[key], float(ref[key]), rtol=1e-4,
                                   err_msg=key)
    assert stats["L_err"].shape == (36,)
    assert not stats["L_err"][[5, 6, 33]].any()
    tdir = os.path.join(model.results_path, str(k))
    for sub, name in (("W_reg_factors", "W.npy"), ("H_reg_factors", "H.npy")):
        t = np.load(os.path.join(tdir, sub, name))
        j = np.load(os.path.join(jdir, sub, name))
        assert t.shape == j.shape == ((48, k) if name == "W.npy" else (k, 36))
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-8, err_msg=name)
    W_reg = np.load(os.path.join(tdir, "W_reg_factors", "W.npy"))
    assert not W_reg[[2, 30]].any()


def test_cli_sweep_hals_nnsvd_prune(tmp_path):
    """The CLI runs --method=hals --init=nnsvd --prune=true on a planted
    rank-3 matrix with all-zero rows and columns: it picks k = 3, writes
    results for every k, and saves factors at the full shape with zero
    rows and columns where they were planted."""
    from pydnmfk_tpu_torch import cli
    from pydnmfk_tpu_torch.utils.io import read_cluster_results
    _, _, X = generate_data(m=48, n=36, k=3, seed=100)
    X[[2, 30]] = 0.0
    X[:, [5, 6, 33]] = 0.0
    np.save(tmp_path / "X.npy", X)
    out = cli.main(["--cpu", "--process=pyDNMFk", "--p_r=1", "--p_c=1",
                    "--ftype=npy", f"--fpath={tmp_path}/", "--fname=X",
                    "--norm=fro", "--method=hals", "--init=nnsvd",
                    "--prune=true", "--itr=300", "--precision=float64",
                    "--start_k=2", "--end_k=4", "--perturbations=6",
                    f"--results_path={tmp_path}/res/"])
    assert out["nopt"] == 3
    for k in (2, 3, 4):
        k_path = tmp_path / "res" / "X" / str(k)
        res = read_cluster_results(str(k_path))
        assert res["L_err"].shape == (36,)
        assert not res["L_err"][[5, 6, 33]].any()
        assert np.isfinite(res["AIC"])
        W = np.load(k_path / "W_reg_factors" / "W.npy")
        H = np.load(k_path / "H_reg_factors" / "H.npy")
        assert W.shape == (48, k) and H.shape == (k, 36)
        assert not W[[2, 30]].any() and not H[:, [5, 6, 33]].any()


@pytest.mark.parametrize("kw, match", [
    (dict(prune=True), "prune"), (dict(init="nnsvd"), "nnsvd"),
    (dict(method="bcd"), "BCD")])
def test_nmfk_sparse_refusals_match_jax(tmp_path, kw, match):
    """A sparse A refuses prune, nnsvd and BCD up front in the NMFk sweep
    too, with the JAX package's ValueErrors (nmfk.py:677-689), before any
    member is solved."""
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    A, _, _ = _planted(4)
    rows, cols = np.nonzero(A)
    nmf = dict(norm="fro", itr=5, **kw)
    cfg = port.NMFkConfig(nmf=port.NMFConfig(**nmf), start_k=2, end_k=2,
                          perturbations=2, checkpoint=False,
                          results_path=str(tmp_path / "t") + "/")
    with pytest.raises(ValueError, match=match):
        port.NMFk(cfg, "cpu").fit(sparse_from_numpy(
            rows, cols, A[rows, cols].astype(np.float32), A.shape))
    jcfg = pydnmfk_tpu.NMFkConfig(nmf=pydnmfk_tpu.NMFConfig(**nmf),
                                  start_k=2, end_k=2, perturbations=2,
                                  checkpoint=False,
                                  results_path=str(tmp_path / "j") + "/")
    with pytest.raises(ValueError, match=match):
        pydnmfk_tpu.NMFk(jcfg).fit(jsparse.BCOO.fromdense(
            jnp.asarray(A, jnp.float32)))
