"""The port's ensemble axis p_e against the JAX package's mesh axis 'e':
``NMFk(cfg, grid_context(2, 1, 2))`` of the JAX package, run here on
conftest's virtual CPU devices, and the port on two groups of a 2 x 1 grid
of CPU processes (gloo, f64) fed the JAX draws (keyed, in both packages,
by the global member index), for dense FRO-MU, KL-MU and BCD (whose
restore choice a world-wide broadcast would take from another group's
members) and sparse FRO-MU on the triplet and on the dual ELL: the same k,
the statistics downstream of the clustering within
``tests/test_torch_grid_nmfk.py``'s ``TOL``, and the ensemble's errors and
AIC within ``ERR_RTOL``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import pydnmfk_tpu
from _grid_workers import fed_sweeps, run_grid
from _parity import x64
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu_torch.utils.data_generator import generate_data
from test_torch_grid_nmfk import STATS, TOL

# the members' errors and the AIC, relative: the two packages' f64 solves
# take their sums in other orders, which 100 MU iterations move apart by up
# to 4e-8 (the port's grid and its 1x1 sweep agree to 1e-8)
ERR_RTOL = 1e-6


JAX_CASES = {"FRO-MU": (dict(norm="fro"), False),
             "KL-MU": (dict(norm="kl"), False),
             "BCD": (dict(norm="fro", method="bcd"), False),
             "sparse triplet": (dict(norm="fro",
                                     sparse_grid_format="triplet"), True),
             "sparse ELL": (dict(norm="fro", sparse_grid_format="ell"),
                            True)}
JAX_KS = range(2, 4)


def _jax_cfg(root, name, nmf_kw):
    return pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=100, precision="float64", seed=42,
                                  **nmf_kw),
        start_k=JAX_KS[0], end_k=JAX_KS[-1], perturbations=8,
        noise_var=0.03, sill_thr=0.6,
        results_path=f"{root}/jax/{name}/", fname="A", checkpoint=False,
        k_sweep_batch=False)


def _jax_dense():
    return np.asarray(generate_data(m=64, n=48, k=3, seed=100)[2],
                      dtype=np.float64)


def _jax_sparse():
    from test_torch_nmfk import _planted_sparse
    return _planted_sparse(m=78, n=60)


def _jax_draws(jcfg, X, sparse_A):
    """The members the JAX per-k programs draw (keys by global member
    index, on the whole A or its flat values): {k: (A_ens, W0, H0)}."""
    from jax.experimental import sparse as jsparse
    out = {}
    with x64():
        keys = js.member_keys(jax.random.key(jcfg.nmf.seed), 0,
                              jcfg.perturbations)
        source = (jsparse.BCOO.fromdense(jax.numpy.asarray(X)).data
                  if sparse_A else jax.numpy.asarray(X))
        A_ens = jax.vmap(lambda kk: js.sample_member(
            source, js.member_noise_key(kk), jcfg.noise_var,
            jcfg.sampling))(keys)
        for k in JAX_KS:
            W0, H0 = jnmfk._draw_init_factors(
                jcfg.nmf.replace(k=k), keys, None if sparse_A else A_ens,
                None, *X.shape)
            out[k] = (np.array(A_ens), np.array(W0), np.array(H0))
    return out


def _coo_of(X):
    rows, cols = np.nonzero(X)
    return (rows.astype(np.int32), cols.astype(np.int32),
            X[rows, cols].astype(np.float64), X.shape)


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    """The port at (2,1,e=2) fed the JAX draws of every case, in one
    group of ranks."""
    root = str(tmp_path_factory.mktemp("ens_jax"))
    X, S = _jax_dense(), _jax_sparse()
    cases = {}
    for name, (nmf_kw, sparse_A) in JAX_CASES.items():
        jcfg = _jax_cfg(root, name, nmf_kw)
        cfg = dataclasses.asdict(jcfg)
        kw = {key: cfg[key] for key in ("start_k", "end_k", "perturbations",
                                        "noise_var", "sill_thr", "fname",
                                        "checkpoint")}
        kw["results_path"] = f"{root}/torch/{name}/"
        cases[name] = (kw, dict(nmf_kw, itr=100, seed=42), sparse_A,
                       _jax_draws(jcfg, S if sparse_A else X, sparse_A))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = run_grid(fed_sweeps, (2, 1, 2), root, X, _coo_of(S), cases)
    finally:
        torch.set_num_threads(n)
    return root, out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sweep_on_groups_matches_the_jax_sweep_on_e(fed, name):
    """Chosen k and per-k statistics of the port at (2,1,e=2) with the
    JAX draws against the JAX package's sweep on grid_context(2, 1, 2)."""
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu.parallel.mesh import grid_context
    root, out = fed
    nmf_kw, sparse_A = JAX_CASES[name]
    jcfg = _jax_cfg(root, name, nmf_kw)
    with x64():
        X = _jax_sparse() if sparse_A else _jax_dense()
        jm = pydnmfk_tpu.NMFk(jcfg, grid_context(2, 1, 2))
        nopt = jm.fit(jsparse.BCOO.fromdense(jax.numpy.asarray(X))
                      if sparse_A else X)
    for o in out:
        got_nopt, stats = o[name]
        assert got_nopt == nopt, name
        for k in JAX_KS:
            for key in STATS:
                rtol, atol = TOL.get(key, (ERR_RTOL, 1e-12))
                np.testing.assert_allclose(
                    np.asarray(stats[k][key], dtype=np.float64),
                    np.asarray(jm.per_k_stats[k][key], dtype=np.float64),
                    rtol=rtol, atol=atol, err_msg=f"{name} k={k} {key}")
