"""The slice as a whole: pydnmfk_tpu_torch's NMFk sweep, CLI and imports
against pydnmfk_tpu on a planted-k matrix (generate_data(64, 48, 3), FRO-MU).

With the JAX package's perturbed copies and init factors fed to the port,
the per-k silhouettes, column errors L_err and AIC agree at rtol 1e-4 (f64:
the two packages differ only in summation order, which clustering's arccos
amplifies near identical columns)."""
import dataclasses
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
        results_path=str(tmp_path / "torch") + "/"))))
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


def test_port_sweep_picks_planted_k(tmp_path):
    """With its own torch draws the port picks k = 3, as the JAX package
    does on the same matrix (tests/test_nmfk_pipeline.py)."""
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    cfg = port.NMFkConfig(
        nmf=port.NMFConfig(itr=600, norm="fro", precision="float64"),
        start_k=1, end_k=5, perturbations=8, sill_thr=0.6,
        results_path=str(tmp_path) + "/", fname="syn", ensemble_batch=3)
    model = port.NMFk(cfg)
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
    for flag in ("--init=nnsvd", "--method=hals", "--ftype=npz",
                 "--prune=true", "--seed_grid=2,2", "--multihost=true"):
        with pytest.raises(port.NotPortedError, match="ROADMAP"):
            cli.main(base + [flag])
    with pytest.raises(port.NotPortedError, match="item 15"):
        cli.main(["--cpu", "--p_r=2", "--p_c=1"])


def test_import_loads_neither_jax_nor_the_jax_package():
    """Importing the port, its kernel modules and entry points pulls in no
    JAX, no pydnmfk_tpu and no triton, and builds nothing: the kernels build
    at first launch, and this test runs without nvcc."""
    code = (
        "import sys\n"
        "import pydnmfk_tpu_torch, pydnmfk_tpu_torch.cli\n"
        "from pydnmfk_tpu_torch.ops import fused_mu, kl, cuda_lib\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pydnmfk_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert fused_mu.launches == {'fused_mu_fro': 0}\n"
        "assert not cuda_lib.load.cache_info().currsize\n")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME",
                                                            "CUDA_PATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
