"""``seed_grid``, the reference's MPI seeding, in the port
(``models/sampler.py``, ``models/nmfk.py::_init_members``) against the JAX
package's (``sampler.py:54-115``, ``nmfk.py:55-78``): the tiled uniform
field, the per-block Poisson draw and the tiled rand init hold as in
tests/test_sampler.py::test_seed_grid_*; a sweep fed JAX's seed-grid members
gives JAX's per-k statistics (rtol 1e-4 at f64, as tests/test_torch_nmfk.py);
a sparse A and dims the grid does not divide raise JAX's ValueErrors."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import one_thread, x64
import pydnmfk_tpu
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch import cli
from pydnmfk_tpu_torch.models import sampler
from pydnmfk_tpu_torch.utils.convert import config_from_jax

pytestmark = pytest.mark.usefixtures("one_thread")


def _gen(seed=7):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("grid", [(2, 2), (4, 3), (1, 2)])
def test_tiled_uniform_noise(grid):
    A = torch.ones((8 * grid[0] // 2, 6 * grid[1] // 2)) * 2.0
    X = sampler.sample_member(A, _gen(), 0.1, "uniform", tile_grid=grid)
    br, bc = A.shape[0] // grid[0], A.shape[1] // grid[1]
    for i in range(grid[0]):
        for j in range(grid[1]):
            assert torch.equal(X[i * br:(i + 1) * br, j * bc:(j + 1) * bc],
                               X[:br, :bc])
    Y = sampler.sample_member(A, _gen(), 0.1, "uniform")
    assert not torch.equal(Y[:br, :bc], Y[br:2 * br, :bc]) or grid[0] == 1
    assert float(X.min()) >= 2 * 1.1 and float(X.max()) < 2 * 1.3
    # the JAX package's tiled field has the same structure
    Xj = np.asarray(js.sample_member(jnp.asarray(A.numpy()),
                                     jax.random.key(7), 0.1, "uniform",
                                     tile_grid=grid))
    np.testing.assert_array_equal(np.tile(Xj[:br, :bc], grid), Xj)


def test_poisson_blocks():
    """tests/test_sampler.py::test_seed_grid_poisson_blocks with the port:
    blocks of equal data get bitwise-equal draws, each block marginally
    Poisson."""
    base = np.random.default_rng(3).random((20, 15)) * 9
    A = torch.from_numpy(np.tile(base, (2, 2)).astype(np.float32))
    X = sampler.sample_member(A, _gen(11), 0.0, "poisson", tile_grid=(2, 2))
    for blk in (X[20:, :15], X[:20, 15:], X[20:, 15:]):
        assert torch.equal(X[:20, :15], blk)
    assert torch.equal(X, X.round())
    Y = sampler.sample_member(A, _gen(11), 0.0, "poisson")
    assert not torch.equal(Y[:20, :15], Y[20:, :15])
    B = torch.from_numpy((np.random.default_rng(4).random((40, 30)) * 9 + 1)
                         .astype(np.float32))
    Z = sampler.sample_member(B, _gen(11), 0.0, "poisson", tile_grid=(2, 2))
    assert not torch.equal(Z[:20, :15], Z[20:, :15])
    assert abs(float(Z.mean()) - float(B.mean())) < 0.15
    # JAX's draw has the same property on the same data
    Xj = np.asarray(js.sample_member(jnp.asarray(A.numpy()),
                                     jax.random.key(11), 0.0, "poisson",
                                     tile_grid=(2, 2)))
    np.testing.assert_array_equal(Xj[:20, :15], Xj[20:, 15:])


def test_tiled_init():
    """The rand init of a member is one (m/p, k), (k, n/p) draw tiled p =
    p_r p_c times, in the port as in the JAX package."""
    W, H = sampler.init_ensemble_rand(100, range(3), 16, 8, 3, torch.float32,
                                      "cpu", tile_grid=(2, 2))
    assert W.shape == (3, 16, 3) and H.shape == (3, 3, 8)
    for i in range(1, 4):
        assert torch.equal(W[:, :4], W[:, 4 * i:4 * (i + 1)])
        assert torch.equal(H[:, :, :2], H[:, :, 2 * i:2 * (i + 1)])
    assert not torch.equal(W[0], W[1])
    ncfg = pydnmfk_tpu.NMFConfig(k=3, itr=0, norm="fro", init="rand")
    keys = js.member_keys(jax.random.key(0), 0, 2)
    Wj, Hj = jnmfk._draw_init_factors(ncfg, keys, None, (2, 2), 16, 8)
    Wj, Hj = np.asarray(Wj), np.asarray(Hj)
    np.testing.assert_array_equal(np.tile(Wj[:, :4], (1, 4, 1)), Wj)
    np.testing.assert_array_equal(np.tile(Hj[:, :, :2], (1, 1, 4)), Hj)
    # (1, 1) and None are the one-stream draws
    W1, _ = sampler.init_ensemble_rand(100, range(3), 16, 8, 3,
                                       torch.float32, "cpu", tile_grid=(1, 1))
    W0, _ = sampler.init_ensemble_rand(100, range(3), 16, 8, 3,
                                       torch.float32, "cpu")
    assert torch.equal(W0, W1) and not torch.equal(W0, W)


def _jax_members(jcfg, X, k):
    """The perturbed copies and rand inits of JAX's per-k ensemble program
    under its seed grid (nmfk.py:105-115)."""
    ncfg = jcfg.nmf.replace(k=k)
    A = jnp.asarray(X, ncfg.dtype)
    sg = tuple(jcfg.seed_grid)
    keys = js.member_keys(jax.random.key(ncfg.seed), 0, jcfg.perturbations)
    A_ens = jax.vmap(lambda kk: js.sample_member(
        A, js.member_noise_key(kk), jcfg.noise_var, jcfg.sampling,
        tile_grid=sg))(keys)
    W0, H0 = jnmfk._draw_init_factors(ncfg, keys, A_ens, sg, *A.shape)
    return np.array(A_ens), np.array(W0), np.array(H0)


@pytest.mark.parametrize("sampling", ["uniform", "poisson"])
def test_sweep_with_jax_seed_grid_members_matches_jax(tmp_path, sampling):
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    if sampling == "poisson":
        X = np.round(X * 50)
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=300, norm="fro", method="mu",
                                  precision="float64"),
        start_k=2, end_k=4, perturbations=6, sampling=sampling,
        seed_grid=(2, 2), results_path=str(tmp_path / "jax") + "/",
        fname="syn", checkpoint=False, k_sweep_batch=False)
    with x64():
        jm = pydnmfk_tpu.NMFk(jcfg)
        nopt_jax = jm.fit(X)
        members = {k: _jax_members(jcfg, X, k) for k in jcfg.k_range}
    cfg = config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/")))
    assert cfg.seed_grid == (2, 2)
    model = port.NMFk(cfg, "cpu")
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
    assert model.pvalue_analysis() == nopt_jax


def test_port_sweep_with_seed_grid_runs_its_own_draws(tmp_path, monkeypatch):
    """The port draws its own seed-grid members through NMFk, the Runner
    and the CLI; each member is tiled as the grid says."""
    _, _, X = generate_data(m=64, n=48, k=3, seed=100)
    cfg = port.NMFkConfig(nmf=port.NMFConfig(norm="fro", itr=200),
                          start_k=2, end_k=4, perturbations=6,
                          seed_grid=(2, 2), results_path=f"{tmp_path}/a/",
                          fname="X", checkpoint=False)
    seen = []
    real = sampler.sample_ensemble

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((out, kw.get("tile_grid")))
        return out

    monkeypatch.setattr(sampler, "sample_ensemble", spy)
    nopt = port.NMFk(cfg, "cpu").fit(X.astype(np.float32))
    monkeypatch.undo()
    assert nopt == 3
    out, grid = seen[0]
    assert grid == (2, 2)
    noise = out / torch.from_numpy(X.astype(np.float32))
    assert torch.allclose(noise[:, :32, :24], noise[:, 32:, 24:], rtol=1e-6)
    np.save(tmp_path / "X.npy", X.astype(np.float32))
    args = ["--cpu", "--process=pyDNMFk", "--p_r=1", "--p_c=1",
            "--ftype=npy", f"--fpath={tmp_path}/", "--fname=X", "--norm=fro",
            "--itr=200", "--start_k=2", "--end_k=4", "--perturbations=6",
            f"--results_path={tmp_path}/b/", "--seed_grid=2,2"]
    assert cli.main(args)["nopt"] == nopt
    assert port.Runner(norm="fro", itr=200, perturbations=6, device="cpu",
                       process="pyDNMFk", seed_grid=(2, 2)).run(
        fpath=f"{tmp_path}/", ftype="npy", fname="X",
        results_path=f"{tmp_path}/c/", k_range=(2, 4))["nopt"] == nopt


def test_refusals_match_jax(tmp_path):
    # dims the grid does not divide
    A = torch.ones((9, 8))
    with pytest.raises(ValueError, match="divisible by") as exc:
        sampler.sample_member(A, _gen(), 0.1, "uniform", tile_grid=(2, 2))
    with pytest.raises(ValueError, match="divisible by") as jexc:
        js.sample_member(jnp.ones((9, 8)), jax.random.key(0), 0.1, "uniform",
                         tile_grid=(2, 2))
    assert str(exc.value) == str(jexc.value)
    # the init's p-fold tiling needs m and n divisible by p_r p_c
    with pytest.raises(ValueError, match="p_r\\*p_c=4") as exc:
        sampler.init_ensemble_rand(0, range(1), 8, 6, 2, torch.float32,
                                   "cpu", tile_grid=(2, 2))
    ncfg = pydnmfk_tpu.NMFConfig(k=2, init="rand")
    with pytest.raises(ValueError, match="p_r\\*p_c=4") as jexc:
        jnmfk._draw_init_factors(ncfg, js.member_keys(jax.random.key(0), 0, 1),
                                 None, (2, 2), 8, 6)
    assert str(exc.value) == str(jexc.value)
    # a sparse A
    from pydnmfk_tpu_torch.utils.convert import sparse_from_numpy
    D = np.eye(8) + 0.5
    rows, cols = np.nonzero(D)
    T = sparse_from_numpy(rows, cols, D[rows, cols], D.shape)
    cfg = port.NMFkConfig(nmf=port.NMFConfig(norm="fro", itr=5), start_k=2,
                          end_k=2, perturbations=2, seed_grid=(2, 2),
                          results_path=f"{tmp_path}/", checkpoint=False)
    with pytest.raises(ValueError, match="dense-only") as exc:
        port.NMFk(cfg, "cpu").fit(T)
    from jax.experimental import sparse as jsparse
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(norm="fro", itr=5), start_k=2, end_k=2,
        perturbations=2, seed_grid=(2, 2), results_path=f"{tmp_path}/j/",
        checkpoint=False)
    with pytest.raises(ValueError, match="dense-only") as jexc:
        pydnmfk_tpu.NMFk(jcfg).fit(jsparse.BCOO.fromdense(jnp.asarray(D)))
    assert str(exc.value) == str(jexc.value)
