"""The K-padded NMFk sweep of pydnmfk_tpu_torch (``k_sweep_batch``,
``k_sweep_merge``) against the port's per-k sweep and against pydnmfk_tpu,
on the shapes of the JAX package's ``tests/test_k_sweep.py`` (60 x 40,
ks 2..5, 4 members), whose contracts it carries over.

Tolerances:
* a masked K-padded solve against the unpadded one (the port, f32):
  inactive columns exactly 0, active ones rtol 2e-4 / atol 1e-5 and the
  error rtol 1e-5, as JAX's ``test_masked_padded_solve_matches_unpadded``
  (K-wide sums group the same partial sums in another order, and 40
  iterations amplify the last bit);
* the port's masked solve against JAX's ``_solve(..., col_mask)`` on the
  same numpy inputs at f64: 1e-9 of the largest value
  (``tests/test_torch_hals_bcd.py``'s fits; summation order only);
* the padded clustering against the unpadded one and against JAX's:
  JAX's rtol 1e-6 / atol 1e-7 (centroids, H); the silhouettes 1e-4
  absolute, the bound of ``tests/test_torch_clustering.py``: they are
  taken in f32 from arccos of each column's similarity to itself, which
  turns an ulp of that column's norm (the products' summation order,
  which the padding changes in torch and not in XLA) into up to ~1e-4
  (JAX's own padded and unpadded clusterings agree to 1e-5);
* a K-padded or merged sweep against the per-k sweep: recon_err rtol 1e-4,
  silhouettes rtol 1e-3 / atol 1e-4, L_err rtol 1e-3 / atol 1e-5, as JAX's
  ``test_polyk_sweep_matches_per_k``;
* the port's merged sweep fed the JAX package's draws against JAX's default
  (K-padded, merged) sweep at f64: rtol 1e-4, as
  ``tests/test_torch_nmfk.py`` holds the per-k sweeps, the silhouettes
  1e-3 absolute, as it holds them past the planted k (the f32 arccos
  above, on factorizations that are not unique).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _grid_workers import ensemble_checks, run_grid
from _parity import np_, one_thread, x64  # noqa: F401
from test_torch_grid_ensemble import _same_sweep, _sweep
from test_torch_nmfk import _jax_members
import pydnmfk_tpu
from pydnmfk_tpu.models import clustering as jcl
from pydnmfk_tpu.models import nmf as jnmf
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import clustering as tcl
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.models import nmfk as tnmfk
from pydnmfk_tpu_torch.models import sampler as tsampler
from pydnmfk_tpu_torch.utils.checkpoint import FLAG_RUNNING, FLAG_SAVED
from pydnmfk_tpu_torch.utils.convert import config_from_jax, sparse_from_numpy
from pydnmfk_tpu_torch.utils.data_generator import generate_data

k, K = 3, 7
SOLVES = {"fro-mu": dict(norm="fro"), "kl-mu": dict(norm="kl"),
          "hals": dict(norm="fro", method="hals"),
          "hals-block2": dict(norm="fro", method="hals", hals_block=2),
          "bcd-gram": dict(norm="fro", method="bcd"),
          "bcd-residual": dict(norm="fro", method="bcd",
                               bcd_obj="residual")}
SWEEP_STATS = {"recon_err": dict(rtol=1e-4),
               "clusterSilhouetteCoefficients": dict(rtol=1e-3, atol=1e-4),
               "L_err": dict(rtol=1e-3, atol=1e-5)}


def make_data(m=60, n=40, ktrue=3, seed=0):
    """JAX's ``tests/test_k_sweep.py::make_data``: three Gaussian bumps."""
    rng = np.random.default_rng(seed)
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    H = rng.random((ktrue, n)) + 0.1
    return (W @ H).astype(np.float32)


def _padded(W0, H0, kk, b=None):
    """(W0, H0) zero-padded from kk to K columns, and the bool (K,) mask,
    or for a stack the (b, K) mask of the member's kk."""
    Wp = np.zeros(W0.shape[:-1] + (K,), W0.dtype)
    Hp = np.zeros(H0.shape[:-2] + (K,) + H0.shape[-1:], H0.dtype)
    Wp[..., :kk] = W0
    Hp[..., :kk, :] = H0
    mask = np.arange(K) < kk
    return Wp, Hp, mask if b is None else np.broadcast_to(mask, (b, K))


def _problem(dtype, b=None):
    """A (the planted data, or a stack of b noisy copies of it) and rand
    factors at k."""
    rng = np.random.default_rng(1)
    A = make_data()
    if b is not None:
        A = A * (1 + 0.05 * rng.random((b,) + A.shape))
    lead = () if b is None else (b,)
    return (A.astype(dtype), rng.random(lead + (A.shape[-2], k)).astype(dtype),
            rng.random(lead + (k, A.shape[-1])).astype(dtype))


def _solve(A, W, H, mask, **kw):
    cfg = port.NMFConfig(itr=40, precision={
        np.float32: "float32", np.float64: "float64"}[A.dtype.type], **kw)
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    return tnmf.solve(t(A), t(W), t(H), cfg.eps, cfg, col_mask=t(mask))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("b", [None, 3], ids=["one", "stack"])
@pytest.mark.parametrize("name", SOLVES)
def test_masked_padded_solve_matches_unpadded(name, b):
    """K = 7 columns with k = 3 active, on one matrix and on a 3-member
    stack: the inactive columns come out exactly 0 and the active ones
    follow the unpadded k-column solve; HALS with ``hals_block=2`` runs
    blocks (2, 3) and (4, 5) across the mask's edge, where the unpadded
    solve sweeps column 2 alone."""
    A, W0, H0 = _problem(np.float32, b)
    W1, H1, e1 = _solve(A, W0, H0, None, **SOLVES[name])
    Wp, Hp, mask = _padded(W0, H0, k, b)
    W2, H2, e2 = _solve(A, Wp, Hp, mask, **SOLVES[name])
    assert not W2[..., k:].any() and not H2[..., k:, :].any()
    np.testing.assert_allclose(W2[..., :k].numpy(), W1.numpy(), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(H2[..., :k, :].numpy(), H1.numpy(), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-5)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("b", [None, 3], ids=["one", "stack"])
@pytest.mark.parametrize("name", SOLVES)
def test_masked_solve_matches_jax(name, b):
    """The port's masked solve against JAX's ``_solve(..., col_mask)``
    (vmapped over a stack whose members are active on 2, 3 and 5 of the 7
    columns), f64, 40 iterations, from the same padded inputs."""
    A, W0, H0 = _problem(np.float64, b)
    Wp, Hp, mask = _padded(W0, H0, k, b)
    if b is not None:
        mask = np.arange(K)[None, :] < np.array([2, 3, 5])[:, None]
        rng = np.random.default_rng(2)
        Wp = rng.random(Wp.shape) * mask[:, None, :]
        Hp = rng.random(Hp.shape) * mask[:, :, None]
    kw = SOLVES[name]
    jkw = dict(norm=kw["norm"], method=kw.get("method", "mu"), itr=40,
               W_update=True, chunk=0, bcd_obj=kw.get("bcd_obj", "gram"),
               hals_block=kw.get("hals_block"))
    with x64():
        fn = lambda a, w, h, msk: jnmf._solve(a, w, h, 2.0 ** -52, msk,
                                              **jkw)
        Wj, Hj, ej = jax.jit(jax.vmap(fn) if b is not None else fn)(
            *map(jnp.asarray, (A, Wp, Hp, mask)))
        Wj, Hj, ej = np_(Wj), np_(Hj), np_(ej)
    Wt, Ht, et = _solve(A, Wp, Hp, mask, **kw)
    assert not (Wt.numpy() * ~mask[..., None, :]).any()
    assert not (Ht.numpy() * ~mask[..., :, None]).any()
    for t, j in ((Wt, Wj), (Ht, Hj), (et, ej)):
        np.testing.assert_allclose(np_(t), j, rtol=0,
                                   atol=1e-9 * np.abs(j).max())


def test_col_mask_refusals():
    """A mask of the wrong dtype or shape, and a mask with
    ``solve_checkpoint_every`` (JAX's ValueError, nmf.py:486-491)."""
    A, W0, H0 = _problem(np.float32)
    with pytest.raises(ValueError, match="col_mask must be bool"):
        _solve(A, W0, H0, np.ones(k, np.float32), norm="fro")
    with pytest.raises(ValueError, match="col_mask must be bool"):
        _solve(A, W0, H0, np.ones((2, k), bool), norm="fro")
    cfg = port.NMFConfig(k=k, itr=20, norm="fro", solve_checkpoint_every=10)
    with pytest.raises(ValueError, match="solve_checkpoint_every"):
        port.NMF(cfg, "cpu").fit(A, factors=(W0, H0),
                                 col_mask=torch.ones(k, dtype=torch.bool))


@pytest.mark.parametrize("n_iter", [2, 100])
def test_padded_clustering_matches_unpadded_and_jax(n_iter):
    """The clustering of a K-padded ensemble with its ``active`` mask (9
    columns, 4 active) equals the unpadded clustering on the active
    columns and JAX's ``cluster_ensemble(..., active=)``, at ``n_iter``
    alignment iterations (2.7e-5 and 1.6e-5 measured on the
    silhouettes); ``CustomClustering(...).fit()`` is
    ``cluster_ensemble``, bitwise."""
    rng = np.random.default_rng(5)
    p, m, n, kk, KK = 6, 40, 25, 4, 9
    W_all = rng.random((p, m, kk)).astype(np.float32)
    H_all = rng.random((p, kk, n)).astype(np.float32)
    Wp = np.pad(W_all, ((0, 0), (0, 0), (0, KK - kk)))
    Hp = np.pad(H_all, ((0, 0), (0, KK - kk), (0, 0)))
    eps = np.float32(1.19e-7)
    active = np.arange(KK) < kk
    t = torch.from_numpy
    unpadded = tcl.cluster_ensemble(t(W_all), t(H_all), eps, n_iter=n_iter)
    padded = tcl.cluster_ensemble(t(Wp), t(Hp), eps, n_iter=n_iter,
                                  active=t(active))
    jax_padded = jcl.cluster_ensemble(jnp.asarray(Wp), jnp.asarray(Hp), eps,
                                      n_iter=n_iter,
                                      active=jnp.asarray(active))
    fitted = tcl.CustomClustering(t(Wp), t(Hp), eps, n_iter,
                                  t(active)).fit()
    for a, b in zip(fitted, padded):
        assert torch.equal(a, b)
    cp, _, Hpc, csp, ap, _ = padded
    assert not csp[kk:].any()
    for ref in (unpadded, jax_padded):
        cr, _, Hr, csr, ar, _ = ref
        np.testing.assert_allclose(cp[:, :kk].numpy(), np_(cr)[:, :kk],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(Hpc[:, :kk].numpy(), np_(Hr)[:, :kk],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(csp[:kk].numpy(), np_(csr)[:kk],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(ap), float(ar), rtol=0, atol=1e-4)


def _sweep_cfg(tmp_path, name, **kw):
    nmf_kw = dict(k=0, norm="fro", itr=200, seed=7)
    nmf_kw.update(kw.pop("nmf", {}))
    return port.NMFkConfig(
        nmf=port.NMFConfig(**nmf_kw),
        **{**dict(start_k=2, end_k=5, perturbations=4, noise_var=0.03,
                  sill_thr=0.6, checkpoint=False, fname="A",
                  results_path=f"{tmp_path}/{name}/"), **kw})


def _fit(cfg, A):
    model = port.NMFk(cfg, "cpu")
    return model.fit(A), model


def _same_stats(got, want, ks):
    for kk in ks:
        for key, tol in SWEEP_STATS.items():
            np.testing.assert_allclose(np.asarray(got[kk][key]),
                                       np.asarray(want[kk][key]),
                                       err_msg=f"k={kk} {key}", **tol)


@pytest.fixture(scope="module")
def per_k(tmp_path_factory):
    """The port's per-k sweep of make_data(): nopt and statistics."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        nopt, model = _fit(_sweep_cfg(tmp_path_factory.mktemp("perk"),
                                      "perk"), make_data())
    finally:
        torch.set_num_threads(n)
    return nopt, model.per_k_stats


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("merge", [False, True], ids=["padded", "merged"])
def test_k_sweep_matches_per_k(tmp_path, per_k, merge):
    """The K-padded sweep, one k a batch (``k_sweep_merge=False``) or
    merged (the default: all 16 members in one batch), selects the per-k
    sweep's k, 3, with its statistics."""
    nopt, model = _fit(_sweep_cfg(tmp_path, "pad", k_sweep_batch=True,
                                  k_sweep_merge=merge), make_data())
    assert nopt == per_k[0] == 3
    assert model.last_batch_size == (16 if merge else 4)
    _same_stats(model.per_k_stats, per_k[1], range(2, 6))


def test_merged_sweep_matches_jax_default(tmp_path, monkeypatch):
    """JAX's default sweep (K-padded and merged) against the port's merged
    sweep fed the JAX package's perturbed copies and init factors, f64: the
    same nopt, and every k's statistics within rtol 1e-4, the silhouettes
    within 1e-3 (2.0e-4 measured at k = 5)."""
    X = make_data().astype(np.float64)
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(k=0, norm="fro", itr=200, seed=7,
                                  precision="float64"),
        start_k=2, end_k=5, perturbations=4, noise_var=0.03, sill_thr=0.6,
        checkpoint=False, fname="A", results_path=f"{tmp_path}/jax/")
    assert jcfg.k_sweep_batch is None and jcfg.k_sweep_merge is None
    with x64():
        jm = pydnmfk_tpu.NMFk(jcfg)
        nopt_jax = jm.fit(X)
        draws = {kk: _jax_members(jcfg, X, kk) for kk in jcfg.k_range}
    cfg = config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=f"{tmp_path}/torch/", k_sweep_batch=True)))
    monkeypatch.setattr(tsampler, "sample_ensemble", lambda A, seed, nv,
                        members, *a, **kw: torch.from_numpy(
                            draws[2][0][list(members)]))
    monkeypatch.setattr(tnmfk.NMFk, "_init_members", staticmethod(
        lambda ncfg, A_ens, idx, *a, **kw: tuple(
            torch.from_numpy(x[list(idx)]) for x in draws[ncfg.k][1:])))
    model = port.NMFk(cfg, "cpu")
    assert model.fit(torch.from_numpy(X)) == nopt_jax
    assert model.last_batch_size == 16
    for kk in jcfg.k_range:
        ref = jm.per_k_stats[kk]
        stats = model.per_k_stats[kk]
        for key in ("clusterSilhouetteCoefficients", "L_err", "recon_err",
                    "avgSilhouetteCoefficients", "AIC", "L_errDist"):
            tol = dict(rtol=0, atol=1e-3) if "Silhouette" in key else dict(
                rtol=1e-4)
            np.testing.assert_allclose(
                np.asarray(stats[key], np.float64),
                np.asarray(ref[key], np.float64), err_msg=f"k={kk} {key}",
                **tol)


@pytest.mark.usefixtures("one_thread")
def test_merged_sweep_crash_resumes_without_solving(tmp_path, monkeypatch):
    """Merged, checkpointed, ks 2..4 in one batch: k = 3's clustering
    fails. The parts of k = 3 and k = 4 are on disk, the last FLAG_RUNNING
    saved names k = 3 with its 4 members done and the file names k = 3
    short of saved; the rerun, whose solver raises, replays every member
    and gives the unbroken sweep's statistics."""
    A = make_data()
    kw = dict(start_k=2, end_k=4, k_sweep_batch=True, checkpoint=True,
              nmf=dict(itr=120))
    _, gold = _fit(_sweep_cfg(tmp_path, "gold", **kw), A)
    cfg = _sweep_cfg(tmp_path, "run", **kw)
    real_cluster, real_save = tnmfk.cluster_ensemble, tnmfk.Checkpoint.save
    running, calls = [], []

    def crashing(*a, **kw):
        calls.append(a[0].shape[-1])
        if len(calls) == 2:                     # k = 3's clustering
            raise RuntimeError("injected failure in k = 3's clustering")
        return real_cluster(*a, **kw)

    def save(self, flag, perturbation, kk, seed=0):
        if flag == FLAG_RUNNING:
            running.append((kk, perturbation))
        return real_save(self, flag, perturbation, kk, seed)

    monkeypatch.setattr(tnmfk, "cluster_ensemble", crashing)
    monkeypatch.setattr(tnmfk.Checkpoint, "save", save)
    with pytest.raises(RuntimeError, match="injected failure"):
        _fit(cfg, A)
    monkeypatch.setattr(tnmfk, "cluster_ensemble", real_cluster)
    root = os.path.join(cfg.results_path, "A")
    for kk in (3, 4):
        assert os.listdir(os.path.join(root, str(kk), "ensemble_parts")), kk
    assert running[-1] == (3, 4)
    with open(os.path.join(root, "checkpoint.json")) as f:
        st = json.load(f)
    assert st["k"] == 3 and st["flag"] < FLAG_SAVED

    def no_solve(*a, **kw):
        raise AssertionError("a member was solved again on the resume")

    monkeypatch.setattr(tnmfk.NMFk, "_solve_members", no_solve)
    nopt, model = _fit(cfg, A)
    assert nopt == 3 and sorted(model.per_k_stats) == [3, 4]
    _same_stats(model.per_k_stats, gold.per_k_stats, (3, 4))
    assert not any(os.path.exists(os.path.join(root, str(kk),
                                               "ensemble_parts"))
                   for kk in (2, 3, 4))


@pytest.mark.usefixtures("one_thread")
def test_sparse_k_sweep_matches_per_k(tmp_path):
    """A sparse triplet (JAX's 78 x 60 half-dense planted matrix, ks
    2..4), K-padded and merged, against its per-k sweep."""
    rng = np.random.default_rng(7)
    m, n, ktrue = 78, 60, 3
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    Ad = ((W @ (rng.random((ktrue, n)) + 0.1))
          * (rng.random((m, n)) < 0.5)).astype(np.float32)
    rows, cols = np.nonzero(Ad)
    T = sparse_from_numpy(rows, cols, Ad[rows, cols], Ad.shape)
    kw = dict(end_k=4, nmf=dict(itr=250, seed=42))
    nopt_q, perk = _fit(_sweep_cfg(tmp_path, "q", **kw), T)
    nopt_p, poly = _fit(_sweep_cfg(tmp_path, "p", k_sweep_batch=True, **kw),
                        T)
    assert nopt_p == nopt_q == ktrue
    assert poly._ell is None and poly.last_batch_size == 12
    _same_stats(poly.per_k_stats, perk.per_k_stats, (2, 3, 4))


@pytest.mark.usefixtures("one_thread")
def test_nnsvd_k_sweep_matches_per_k(tmp_path):
    """nnsvd init, K-padded one k a batch: each member's NNDSVD at its k,
    padded, against the per-k sweep (the paths agree, as JAX's
    ``test_polyk_nnsvd_init`` holds them)."""
    kw = dict(end_k=4, nmf=dict(init="nnsvd"))
    nopt_q, perk = _fit(_sweep_cfg(tmp_path, "q", **kw), make_data())
    nopt_p, poly = _fit(_sweep_cfg(tmp_path, "p", k_sweep_batch=True,
                                   k_sweep_merge=False, **kw), make_data())
    assert nopt_p == nopt_q
    _same_stats(poly.per_k_stats, perk.per_k_stats, (2, 3, 4))


@pytest.mark.usefixtures("one_thread")
def test_merged_sweep_on_two_groups_of_2x1(tmp_path):
    """The merged K-padded sweep on a 2 x 1 grid with p_e = 2 (one batch
    of 18 members, 9 a group, k = 3's split between the groups): every
    member's blocks and every statistic bitwise those of the p_e = 1
    merged sweep on the 2 x 1 grid."""
    A = np.array(generate_data(m=48, n=36, k=3, seed=1)[2], np.float64)
    sweeps = {"merged": _sweep(tmp_path, "m", dict(norm="fro"),
                               k_sweep_batch=True)}
    groups = run_grid(ensemble_checks, (2, 1, 2), tmp_path, A, None, sweeps,
                      None, (), None)
    one = run_grid(ensemble_checks, (2, 1), tmp_path, A, None,
                   {"merged": _sweep(tmp_path, "one", dict(norm="fro"),
                                     k_sweep_batch=True)}, None, (), None)
    for rank, o in enumerate(groups):
        assert o["dense"]["batch"]["merged"] == 18
        ref = one[rank % 2]["dense"]
        assert sorted(o["dense"]["members"]["merged"]) == [2, 3, 4]
        _same_sweep(o["dense"], (ref["merged"][0], ref["merged"][1],
                                 ref["members"]["merged"]), "merged")
