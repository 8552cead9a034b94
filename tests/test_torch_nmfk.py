"""The slice as a whole: pydnmfk_tpu_torch's NMFk sweep, CLI and imports
against pydnmfk_tpu on a planted-k matrix (generate_data(64, 48, 3), FRO-MU).

With the JAX package's perturbed copies and init factors fed to the port,
the per-k silhouettes, column errors L_err and AIC agree at rtol 1e-4 (f64:
the two packages differ only in summation order, which clustering's arccos
amplifies near identical columns)."""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import x64
import pydnmfk_tpu
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.utils.convert import config_from_jax
from pydnmfk_tpu_torch.utils.io import read_cluster_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_members(jcfg, X, k):
    """The perturbed copies and rand inits the JAX per-k ensemble program
    draws (nmfk.py:105-115), for all members."""
    ncfg = jcfg.nmf.replace(k=k)
    A = jnp.asarray(X, ncfg.dtype)
    keys = js.member_keys(jax.random.key(ncfg.seed), 0, jcfg.perturbations)
    A_ens = jax.vmap(lambda kk: js.sample_member(
        A, js.member_noise_key(kk), jcfg.noise_var, jcfg.sampling))(keys)
    W0, H0 = jnmfk._draw_init_factors(ncfg, keys, A_ens, None, *A.shape)
    return np.array(A_ens), np.array(W0), np.array(H0)


def test_sweep_matches_jax_with_its_draws(tmp_path):
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=600, norm="fro", method="mu",
                                  precision="float64"),
        start_k=2, end_k=4, perturbations=8, sill_thr=0.6,
        results_path=str(tmp_path / "jax") + "/", fname="syn",
        checkpoint=False, k_sweep_batch=False)
    with x64():
        jm = pydnmfk_tpu.NMFk(jcfg)
        nopt_jax = jm.fit(X)
        members = {k: _jax_members(jcfg, X, k) for k in jcfg.k_range}
    assert nopt_jax == 3

    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/"))), "cpu")
    os.makedirs(model.results_path)
    At = torch.from_numpy(np.asarray(X))
    for k in jcfg.k_range:
        ens = model._solve_ensemble(At, k, members=members[k])
        stats = model.pynmfk_per_k(At, k, ensemble=ens)
        ref = jm.per_k_stats[k]
        for key in ("clusterSilhouetteCoefficients", "L_err", "recon_err"):
            np.testing.assert_allclose(np.asarray(stats[key]),
                                       np.asarray(ref[key]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"k={k} {key}")
        for key in ("avgSilhouetteCoefficients", "AIC", "L_errDist"):
            np.testing.assert_allclose(stats[key], float(ref[key]),
                                       rtol=1e-4, err_msg=f"k={k} {key}")
    assert model.pvalue_analysis() == nopt_jax


def test_kl_sweep_at_wide_k_matches_jax(tmp_path):
    """A KL-MU sweep over ks 4, 34 and 64 (K2's register kernel and its
    3xTF32 kernel at KP = 64 on the card; the plain products here), fed the
    JAX package's draws, at f64: per-k L_err, recon_err, L_errDist and AIC
    within rtol 1e-5 (1.4e-6 measured), the silhouettes within 1e-3
    absolute (1.2e-4 measured: at 34 and 64 clusters of a rank-4 matrix they
    lie near 0, where the clustering's arccos amplifies the summation order
    of 200 iterations of a factorization that is not unique), and the same
    choice of k, 4."""
    _, _, X = generate_data(m=96, n=72, k=4, seed=100)
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=200, norm="kl", method="mu",
                                  precision="float64"),
        start_k=4, end_k=64, step_k=30, perturbations=6, sill_thr=0.6,
        results_path=str(tmp_path / "jax") + "/", fname="kl",
        checkpoint=False, k_sweep_batch=False)
    with x64():
        jm = pydnmfk_tpu.NMFk(jcfg)
        nopt_jax = jm.fit(X)
        members = {k: _jax_members(jcfg, X, k) for k in jcfg.k_range}
    assert list(jcfg.k_range) == [4, 34, 64] and nopt_jax == 4

    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/"))), "cpu")
    os.makedirs(model.results_path)
    At = torch.from_numpy(np.asarray(X))
    for k in jcfg.k_range:
        ens = model._solve_ensemble(At, k, members=members[k])
        stats = model.pynmfk_per_k(At, k, ensemble=ens)
        ref = jm.per_k_stats[k]
        for key in ("L_err", "recon_err", "AIC", "L_errDist"):
            np.testing.assert_allclose(np.asarray(stats[key], np.float64),
                                       np.asarray(ref[key], np.float64),
                                       rtol=1e-5, err_msg=f"k={k} {key}")
        for key in ("clusterSilhouetteCoefficients",
                    "avgSilhouetteCoefficients"):
            np.testing.assert_allclose(np.asarray(stats[key], np.float64),
                                       np.asarray(ref[key], np.float64),
                                       rtol=0, atol=1e-3,
                                       err_msg=f"k={k} {key}")
    assert model.pvalue_analysis() == nopt_jax


def test_port_sweep_picks_planted_k(tmp_path):
    """With its own torch draws the port picks k = 3, as the JAX package
    does on the same matrix (tests/test_nmfk_pipeline.py)."""
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    cfg = port.NMFkConfig(
        nmf=port.NMFConfig(itr=600, norm="fro", precision="float64"),
        start_k=1, end_k=5, perturbations=8, sill_thr=0.6,
        results_path=str(tmp_path) + "/", fname="syn", ensemble_batch=3)
    model = port.NMFk(cfg, "cpu")
    assert model.fit(X) == 3
    assert model.last_batch_size == 3
    # checkpoint flags: every k saved, so a rerun resumes past the sweep
    assert model.checkpoint.resume_k(1, 1) == 6


def test_cli_writes_results_schema(tmp_path):
    _, _, X = generate_data(m=40, n=30, k=2, seed=7)
    np.save(tmp_path / "X.npy", X)
    out = subprocess.run(
        [sys.executable, "-m", "pydnmfk_tpu_torch", "--cpu",
         "--process=pyDNMFk", "--p_r=1", "--p_c=1", "--ftype=npy",
         f"--fpath={tmp_path}/", "--fname=X", "--norm=kl", "--itr=100",
         "--start_k=1", "--end_k=3", "--perturbations=4",
         f"--results_path={tmp_path}/res/", "--timing_stats=true"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Rank estimated by NMFk =" in out.stdout
    for k in (1, 2, 3):
        k_path = tmp_path / "res" / "X" / str(k)
        res = read_cluster_results(str(k_path))
        assert res["clusterSilhouetteCoefficients"].shape == (k,)
        assert res["L_err"].shape == (30,) and res["ErrTol"].shape == (4,)
        assert np.isfinite(res["AIC"]) and np.isfinite(res["L_errDist"])
        assert (k_path / "W_reg_factors" / "W.npy").exists()
        assert (k_path / "H_reg_factors" / "H.npy").exists()
    with open(tmp_path / "res" / "Timing_stats.csv") as f:
        names = f.readline().strip().split(",")
    assert {"ensemble_solve", "clustering", "regression"} <= set(names)


def test_cli_single_factorization(tmp_path, capsys):
    """--process=pyDNMF runs one NMF.fit and saves its factors."""
    from pydnmfk_tpu_torch import cli
    _, _, X = generate_data(m=40, n=30, k=2, seed=7)
    np.savetxt(tmp_path / "X.csv", X, delimiter=",")
    out = cli.main(["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1",
                    "--ftype=csv", f"--fpath={tmp_path}/", "--fname=X",
                    "--k=2", "--norm=fro", "--itr=300", "--save_factors=true",
                    f"--results_path={tmp_path}/res/"])
    assert out["W"].shape == (40, 2) and out["H"].shape == (2, 30)
    assert out["err"] < 0.05
    assert f"relative error = {out['err']}" in capsys.readouterr().out
    W = np.load(tmp_path / "res" / "W_factors" / "W.npy")
    np.testing.assert_array_equal(W, out["W"].numpy())


def test_cli_rejects_unported_flags(tmp_path):
    base = ["--cpu", "--p_r=1", "--p_c=1", f"--fpath={tmp_path}/"]
    from pydnmfk_tpu_torch import cli
    # --solve_checkpoint_every, --seed_grid and --ftype=folder at 1x1 are
    # ported (tests/test_torch_solve_checkpoint.py, test_torch_seed_grid.py,
    # test_torch_io_folder.py), and so are grids and --multihost
    # (tests/test_torch_grid_cli.py)
    for flag in ("--matmul_precision=bfloat16", "--k_sweep_batch=true",
                 "--k_sweep_merge=true", "--sparse_grid_format=ell"):
        with pytest.raises(port.NotPortedError, match="ROADMAP"):
            cli.main(base + [flag])
    # a grid outside torchrun says how to start its processes
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        cli.main(["--cpu", "--p_r=2", "--p_c=1"])


def test_import_loads_neither_jax_nor_the_jax_package():
    """Importing the port, its kernel modules and entry points pulls in no
    JAX, no pydnmfk_tpu and no triton, and builds nothing: the kernels build
    at first launch, and this test runs without nvcc."""
    code = (
        "import sys\n"
        "import pydnmfk_tpu_torch, pydnmfk_tpu_torch.cli\n"
        "from pydnmfk_tpu_torch.ops import (fused_mu, fused_kl, kl, cuda_lib,"
        " ell_gather)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pydnmfk_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert fused_mu.launches == {'fused_mu_fro': 0, "
        "'fused_mu_fro_bf16': 0, 'fused_mu_fro_f16': 0, "
        "'fused_mu_fro_u8': 0}\n"
        "assert fused_kl.launches == {'fused_mu_kl': 0, "
        "'fused_mu_kl_bf16': 0, 'fused_mu_kl_f16': 0, 'fused_mu_kl_u8': 0}\n"
        "assert fused_kl.wide_launches == fused_kl.launches\n"
        "assert kl.launches == {'kl_uht': 0, 'kl_wtu': 0, 'kl_uht_f16': 0, "
        "'kl_wtu_f16': 0}\n"
        "assert ell_gather.launches == {'ell_gather': 0, "
        "'ell_gather_ratio': 0, 'ell_gather_f16': 0, "
        "'ell_gather_ratio_f16': 0}\n"
        "assert not cuda_lib.load.cache_info().currsize\n")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME",
                                                            "CUDA_PATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    """A static scan: no module of pydnmfk_tpu_torch, and not chip_smoke.py,
    imports jax, jaxlib or pydnmfk_tpu, at any depth of the code."""
    import ast
    import glob
    files = glob.glob(os.path.join(REPO, "pydnmfk_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(path, n) for n in names if n.split(".")[0] in
                    ("jax", "jaxlib", "pydnmfk_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# sparse A: the sweep over nnz-sized members (triplet on the CPU, dual ELL as
# on the card), against pydnmfk_tpu's sparse sweep on BCOO
# ---------------------------------------------------------------------------
def _planted_sparse(m=80, n=60, ktrue=3, seed=7):
    """tests/test_sparse.py::_planted_sparse, as a dense numpy array."""
    rng = np.random.default_rng(seed)
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    H = rng.random((ktrue, n)) + 0.1
    return (W @ H) * (rng.random((m, n)) < 0.5)


def _triplet(A, dtype=np.float64):
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    rows, cols = np.nonzero(A)
    return sparse_from_numpy(rows, cols, A[rows, cols].astype(dtype), A.shape)


@pytest.mark.parametrize("k,l2,slabs", [(32, None, False), (40, None, False),
                                         (256, 1 << 12, False),
                                         (257, None, True),
                                         (300, 1 << 12, True)])
def test_sparse_kl_budget_counts_k4s_ratio_workspace(tmp_path, monkeypatch,
                                                     k, l2, slabs):
    """Under KL a sparse member on the dual ELL also costs K4's f32 ratio
    workspace, the wider orientation's (dim, w), where the ratio's slab
    plan takes more than one slab: past the widest slab (k = 257, 300),
    whatever the L2; not at k = 32 (no slabs) or up to k = 256, where the
    ratio takes one slab even on an L2 too small for the table. There the
    budget that holds three FRO members holds two KL ones."""
    from pydnmfk_tpu_torch.models.nmfk import HEADROOM
    from pydnmfk_tpu_torch.ops import ell, ell_gather
    if l2:
        monkeypatch.setattr(ell_gather, "H100_L2_BYTES", l2)
    A = _triplet(_planted_sparse(), np.float32)
    E = ell.ell_pack(A, return_perms=True)
    ws = max(E[0].rvals.numel(), E[0].cvals.numel()) * 4
    assert ws > 0
    cost, batch = {}, {}
    for norm in ("fro", "kl"):
        cfg = port.NMFkConfig(nmf=port.NMFConfig(norm=norm), perturbations=8,
                              results_path=str(tmp_path) + "/", fname=norm,
                              checkpoint=False)
        model = port.NMFk(cfg, "cpu")
        model._ell = E
        cost[norm] = model._member_bytes(A, k)
        per, shared = cost["fro"]
        model.cfg = cfg.replace(hbm_budget=int(
            (3 * per + 1 + shared) / HEADROOM) + 1)
        batch[norm] = model._ensemble_batch_size(A, k)
    assert cost["kl"] == (cost["fro"][0] + (ws if slabs else 0),
                          cost["fro"][1])
    assert batch == {"fro": 3, "kl": 2 if slabs else 3}


@functools.lru_cache(maxsize=None)
def _jax_sparse_sweep(root):
    """pydnmfk_tpu's per-k sparse sweep on _planted_sparse at f64, with the
    member draws its sparse programs make (nmfk.py:232-276)."""
    from jax.experimental import sparse as jsparse
    A = _planted_sparse()
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=250, norm="fro", precision="float64",
                                  seed=42),
        start_k=2, end_k=4, perturbations=4, noise_var=0.03, sill_thr=0.6,
        results_path=os.path.join(root, "jax") + "/", fname="sp",
        checkpoint=False, k_sweep_batch=False)
    with x64():
        B = jsparse.BCOO.fromdense(jnp.asarray(A))
        jm = pydnmfk_tpu.NMFk(jcfg)
        nopt = jm.fit(B)
        keys = js.member_keys(jax.random.key(42), 0, jcfg.perturbations)
        data = np.array(jax.vmap(lambda kk: js.sample_member(
            B.data, js.member_noise_key(kk), jcfg.noise_var))(keys))
        members = {k: (data, *map(np.array, jnmfk._draw_init_factors(
            jcfg.nmf.replace(k=k), keys, None, None, *A.shape)))
            for k in jcfg.k_range}
    return jcfg, nopt, jm.per_k_stats, members


@pytest.fixture(scope="module")
def jax_sparse_sweep(tmp_path_factory):
    return _jax_sparse_sweep(str(tmp_path_factory.mktemp("jax_sparse")))


@pytest.mark.parametrize("fmt", ["triplet", "ell"])
def test_sparse_sweep_matches_jax_with_its_draws(tmp_path, jax_sparse_sweep,
                                                 fmt):
    """The port's sparse ensemble (the triplet, or the dual ELL with tails
    as the card runs it), fed the JAX draws through ``members=``: per-k
    statistics at rtol 1e-4 (f64, summation order) and the same k."""
    from pydnmfk_tpu_torch.ops.ell import ell_pack
    jcfg, nopt_jax, ref_stats, members = jax_sparse_sweep
    assert nopt_jax == 3
    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path) + "/"))), "cpu")
    os.makedirs(model.results_path)
    A = _triplet(_planted_sparse())
    if fmt == "ell":
        model._ell = ell_pack(A, return_perms=True, w_cap=20,
                              max_tail_frac=1.0)
        assert model._ell[0].rtail_d.numel() > 0
    for k in jcfg.k_range:
        ens = model._solve_ensemble(A, k, members=members[k])
        stats = model.pynmfk_per_k(A, k, ensemble=ens)
        ref = ref_stats[k]
        for key in ("clusterSilhouetteCoefficients", "L_err", "recon_err"):
            np.testing.assert_allclose(np.asarray(stats[key]),
                                       np.asarray(ref[key]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"k={k} {key}")
        for key in ("avgSilhouetteCoefficients", "AIC", "L_errDist"):
            np.testing.assert_allclose(stats[key], float(ref[key]),
                                       rtol=1e-4, err_msg=f"k={k} {key}")
    assert model.pvalue_analysis() == nopt_jax


def test_sparse_sweep_with_ell_forced_picks_the_jax_k(tmp_path,
                                                      jax_sparse_sweep,
                                                      monkeypatch):
    """With its own torch draws and the ELL format forced (the card's
    choice; the CPU keeps the triplet), the port picks the JAX package's k
    on _planted_sparse."""
    from pydnmfk_tpu_torch.ops import ell, sparse
    jcfg, nopt_jax, _, _ = jax_sparse_sweep
    monkeypatch.setattr(
        sparse, "densify_for_backend",
        lambda A, **kw: ell.ell_pack(A, return_perms=True)
        if isinstance(A, sparse.SparseTriplet) else A)
    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path) + "/"))), "cpu")
    assert model.fit(_triplet(_planted_sparse())) == nopt_jax
    assert model._ell is not None


def test_topic_generator_picks_4_in_both_packages(tmp_path):
    """A reduced copy of chip_smoke.py's planted topic matrix (rank 4,
    block-sparse with anchor words): both packages' sparse sweeps choose
    k = 4 with their own draws."""
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu_torch.utils.data_generator import generate_topic_sparse
    rows, cols, vals, shape = generate_topic_sparse(400, 120, 4, 12, seed=7)
    A = np.zeros(shape, np.float32)
    np.add.at(A, (rows, cols), vals)
    kw = dict(start_k=2, end_k=6, perturbations=6, sill_thr=0.6,
              fname="topic", checkpoint=False)
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=300, norm="fro"),
        results_path=str(tmp_path / "jax") + "/", **kw)
    assert pydnmfk_tpu.NMFk(jcfg).fit(
        jsparse.BCOO.fromdense(jnp.asarray(A))) == 4
    cfg = port.NMFkConfig(nmf=port.NMFConfig(itr=300, norm="fro"),
                          results_path=str(tmp_path / "torch") + "/", **kw)
    assert port.NMFk(cfg, "cpu").fit(_triplet(A, np.float32)) == 4


def test_sparse_cli_and_runner_on_npz(tmp_path):
    """--ftype=npz reaches the sparse FRO sweep through the CLI, which picks
    the planted rank 3, and the Runner factorizes an .npz with KL
    (tests/test_sparse.py::test_sparse_npz_cli_and_runner for the JAX
    package)."""
    from scipy import sparse as sp
    from pydnmfk_tpu_torch import cli
    A = _planted_sparse(m=60, n=45)
    sp.save_npz(tmp_path / "S.npz", sp.csr_matrix(A.astype(np.float32)))
    out = cli.main(["--cpu", "--process=pyDNMFk", "--p_r=1", "--p_c=1",
                    "--ftype=npz", f"--fpath={tmp_path}/", "--fname=S",
                    "--norm=fro", "--itr=150", "--start_k=2", "--end_k=4",
                    "--perturbations=4", "--noise_var=0.03",
                    f"--results_path={tmp_path}/res/"])
    assert out["nopt"] == 3                      # the planted rank
    for k in (2, 3, 4):
        res = read_cluster_results(str(tmp_path / "res" / "S" / str(k)))
        assert res["L_err"].shape == (45,) and np.isfinite(res["AIC"])
    r = port.Runner(itr=150, norm="kl", process="pyDNMF", device="cpu")
    got = r.run(fpath=str(tmp_path) + "/", ftype="npz", fname="S", k=3,
                results_path=str(tmp_path / "res2") + "/")
    assert got["W"].shape == (60, 3) and 0 < got["err"] < 0.9
