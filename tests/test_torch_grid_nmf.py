"""The port's dense NMF on a p_r x p_c grid of CPU processes
(``parallel/mesh.py``, one gloo rank a process) against the JAX package's
NMF on a ``grid_context`` of the same shape (the 8 virtual CPU devices of
tests/conftest.py), at f64: FRO-MU, KL-MU, HALS and BCD from the same init
(JAX's global factors cut into each rank's blocks) and nnsvd (each
package's own). A is 28 x 20, which 2 x 2, 4 x 1 and 1 x 4 tile evenly and
3 x 1 does not: there the port's blocks are uneven (10, 9, 9 rows) and JAX
pads A and W with a zero row, which MU keeps at zero and HALS lifts to eps,
moving the error at the eps^2 level. Also: the replicas of every W and H
block bitwise equal, the collectives of one MU step, the partition against
JAX's, and the refusals that stay."""
import numpy as np
import pytest
import torch

from _grid_workers import nmf_cases, run_grid
from _parity import np_, x64
import pydnmfk_tpu
from pydnmfk_tpu.parallel import partition as jpart
from pydnmfk_tpu_torch import NMF, NMFConfig, NotPortedError
from pydnmfk_tpu_torch.parallel import mesh, partition

GRIDS = [(2, 2), (4, 1), (1, 4), (3, 1)]
M, N, K, ITR = 28, 20, 3, 20
CASES = {"fro-mu": dict(norm="fro"), "kl-mu": dict(norm="kl"),
         "hals": dict(norm="fro", method="hals"),
         "bcd": dict(norm="fro", method="bcd"),
         "nnsvd": dict(norm="fro", init="nnsvd")}
# JAX and the port sum in other orders (f64: ~1e-15 a step); the 3 x 1
# grid's padded row adds eps^2-level terms under HALS and BCD
TOL = 1e-9


def _data():
    rng = np.random.default_rng(18)
    A = rng.random((M, 5)) @ rng.random((5, N)) + 0.01 * rng.random((M, N))
    return A, rng.random((M, K)), rng.random((K, N))


_FITS = {}


def _port(grid, tmp_path_factory):
    """The port's fits of every case on ``grid`` (one spawn a grid)."""
    if grid not in _FITS:
        A, W0, H0 = _data()
        cases = {name: dict(k=K, itr=ITR, **kw)
                 for name, kw in CASES.items()}
        _FITS[grid] = run_grid(nmf_cases, grid,
                               tmp_path_factory.mktemp("grid"), A, W0, H0,
                               cases)
    return _FITS[grid]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_nmf_matches_jax(grid, case, tmp_path_factory):
    out = _port(grid, tmp_path_factory)
    A, W0, H0 = _data()
    kw = CASES[case]
    with x64():
        cfg = pydnmfk_tpu.NMFConfig(k=K, itr=ITR, precision="float64",
                                    grid=grid, **kw)
        model = pydnmfk_tpu.NMF(cfg)
        Wj, Hj, errj = model.fit(A, factors=None if case == "nnsvd"
                                 else (W0, H0))
        colj = np.asarray(model.column_err())
    for rank in out:
        got = rank[case]
        assert got["W"].shape == (M, K) and got["H"].shape == (K, N)
        np.testing.assert_allclose(got["err"], float(errj), rtol=TOL)
        np.testing.assert_allclose(np_(got["W"]), np_(Wj), rtol=0,
                                   atol=TOL * np.abs(np_(Wj)).max())
        np.testing.assert_allclose(np_(got["H"]), np_(Hj), rtol=0,
                                   atol=TOL * np.abs(np_(Hj)).max())
        np.testing.assert_allclose(got["col"], colj, rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_replicas_stay_bitwise_equal(grid, tmp_path_factory):
    """W's row block i is bitwise equal on every rank of row i, H's column
    block j on every rank of column j, and the gathered factors on every
    rank, for every method."""
    out = _port(grid, tmp_path_factory)
    for case in CASES:
        for a in out:
            for b in out:
                (ia, ja), (ib, jb) = a["coords"], b["coords"]
                if ia == ib:
                    assert torch.equal(a[case]["W_blk"], b[case]["W_blk"])
                if ja == jb:
                    assert torch.equal(a[case]["H_blk"], b[case]["H_blk"])
            assert torch.equal(a[case]["W"], out[0][case]["W"])
            assert torch.equal(a[case]["H"], out[0][case]["H"])
            assert a[case]["err"] == out[0][case]["err"]


def test_one_mu_step_issues_the_summa_all_reduces(tmp_path_factory):
    """One FRO-MU step all-reduces H H^T and A H^T over 'c' and W^T W and
    W^T A over 'r'; one KL-MU step U H^T and H's row sums over 'c', W^T U
    and W's column sums over 'r': four all-reduces of these bytes (f64)."""
    out = _port((2, 2), tmp_path_factory)
    for rank in out:
        m_i, n_j = rank["shape"]
        fro, kl = rank["stats"]["fro"], rank["stats"]["kl"]
        assert fro["counts"] == {"all-reduce": 4}
        assert fro["bytes"] == 8 * (2 * K * K + m_i * K + K * n_j)
        assert kl["counts"] == {"all-reduce": 4}
        assert kl["bytes"] == 8 * (2 * K + m_i * K + K * n_j)
        # record_dist_comm: those bytes over 45 GB/s, 10 iterations, under
        # dist_comm_est beside the measured dist_comm, one category
        est, timings, category = rank["dist_comm"]
        assert est["counts"] == fro["counts"]
        assert est["est_seconds"] == pytest.approx(
            fro["bytes"] * 10 / 45e9)
        assert timings["dist_comm_est"] == est["est_seconds"]
        assert timings["dist_comm"] > 0
        assert category == pytest.approx(timings["dist_comm"]
                                         + timings["dist_comm_est"])


@pytest.mark.parametrize("shape, pgrid", [
    ((28, 20), (2, 2)), ((28, 20), (3, 1)), ((96, 21), (4, 1)),
    ((7, 5), (1, 4)), ((57600, 38400), (2, 2)), ((13, 11), (3, 2))])
def test_partition_is_the_jax_packages(shape, pgrid):
    p = int(np.prod(pgrid))
    assert partition.partition_slices(pgrid, shape) == \
        jpart.partition_slices(pgrid, shape)
    for rank in range(p):
        ours = partition.BlockPartition(rank, pgrid, shape)
        theirs = jpart.BlockPartition(rank, pgrid, shape)
        assert ours.index_range_inclusive() == theirs.index_range_inclusive()
        assert ours.block_shape() == theirs.block_shape()
    assert partition.mesh_padding(shape, pgrid) == \
        jpart.mesh_padding(shape, pgrid)
    assert partition.rank_to_block_order_H(*pgrid) == \
        jpart.rank_to_block_order_H(*pgrid)


def test_config_from_jax_carries_the_grid():
    from pydnmfk_tpu_torch.utils.convert import config_from_jax
    import dataclasses
    cfg = config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(grid=(4, 1)))))
    assert cfg.nmf.grid == (4, 1)
    with pytest.raises(ValueError, match="grid"):
        NMFConfig(grid=(2, 0))


def test_refusals_that_stay(tmp_path):
    """Without a process group a grid asks for torchrun; a sparse A on a
    grid and the ensemble axis raise NotPortedError naming their ROADMAP
    entry; a GridContext needs a group of p_r * p_c ranks."""
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        NMF(NMFConfig(grid=(2, 2)), "cpu")
    with pytest.raises(NotPortedError, match="queue 1 item 15"):
        mesh.GridContext(1, 1, "cpu", p_e=2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.GridContext(1, 1, "cpu")
