"""The port's sparse A on a p_r x p_c grid of CPU processes
(``parallel/mesh.py``, one gloo rank a process) against the JAX package's
on a ``grid_context`` of the same shape, at f64, in both of each rank's
formats (the triplet, and the dual ELL forced: on the CPU the auto format
is the triplet, as it is in the JAX package):

* each rank's block and perm against JAX's ``shard_sparse_grid``, and the
  union of the blocks against the whole triplet on uneven grids and on a
  4 x 1 grid with an empty block;
* a block whose column lines are mostly empty packs (``grid_ell_pack``
  counts the blow-up over the lines that hold a nonzero) while its
  padding stays within ``GRID_MAX_SLOTS`` slots a nonzero;
* the grid products (A H^T, W^T A, the KL U H^T and W^T U, the column sums
  of squares, sqnorm, the relative and column errors) against JAX's
  ``rs_*`` and ``gell_*``;
* NMF.fit with FRO-MU, KL-MU and HALS from JAX's init on 2 x 2, 4 x 1 and
  1 x 4 (A is 28 x 20, which they tile evenly) against JAX's sparse grid
  NMF, on the uneven 3 x 1 (where JAX pads) against the port's own 1x1
  fit, and on a 4 x 1 grid over a matrix whose bottom quarter is empty
  against JAX's on its 4 x 1 grid;
  the replicas of every W and H block bitwise equal; one MU step's four
  all-reduces;
* ``DataReader.read(grid)`` of a CSR .npz (this rank's row panel only) and
  of a COO one (read whole and cut); the CLI under ``python -m
  torch.distributed.run`` on an .npz with the auto and the ELL format;
* the refusals that stay: BCD, nnsvd, prune and a uint8 ``a_precision``
  with a sparse A, a bad ``sparse_grid_format``, and an ``"ell"`` that one
  block refuses, which raises on every rank."""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp
from jax.experimental import sparse as jsp

from _grid_workers import (run_grid, sparse_grid_cases, sparse_refusals,
                           _triplet)
from _parity import np_, one_thread, x64  # noqa: F401
import pydnmfk_tpu
from pydnmfk_tpu.ops import ell as jell, linalg as jlinalg, sparse as jsparse
from pydnmfk_tpu.parallel.mesh import grid_context
from pydnmfk_tpu_torch import NMF, NMFConfig
from pydnmfk_tpu_torch.ops import sparse
from pydnmfk_tpu_torch.parallel.partition import block_range
from pydnmfk_tpu_torch.utils import io
from pydnmfk_tpu_torch.utils.data_generator import generate_topic_sparse

GRIDS = [(2, 2), (4, 1), (1, 4), (3, 1)]
M, N, K, ITR = 28, 20, 3, 20
METHODS = {"fro-mu": dict(norm="fro"), "kl-mu": dict(norm="kl"),
           "hals": dict(norm="fro", method="hals")}
FORMATS = ("triplet", "ell")
CASES = {f"{name} {fmt}": dict(k=K, itr=ITR, sparse_grid_format=fmt, **kw)
         for name, kw in METHODS.items() for fmt in FORMATS}
# JAX and the port sum in other orders (f64: ~1e-15 a step)
TOL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo(A):
    r, c = np.nonzero(A)
    return r.astype(np.int32), c.astype(np.int32), A[r, c], A.shape


def _data():
    """A (28 x 20, about a third nonzero), A with its bottom quarter (rows
    21-27) empty, and the init factors."""
    rng = np.random.default_rng(19)
    A = (rng.random((M, 5)) @ rng.random((5, N))) * (rng.random((M, N))
                                                     < 0.35)
    empty = A.copy()
    empty[3 * M // 4:] = 0
    return A, empty, rng.random((M, K)), rng.random((K, N))


def _bcoo(A):
    r, c = np.nonzero(A)
    return jsp.BCOO((jnp.asarray(A[r, c]), jnp.asarray(np.stack([r, c], 1))),
                    shape=A.shape)


_OUT = {}


def _port(grid, tmp_path_factory):
    """The port's fits, products and blocks on ``grid`` (one spawn a
    grid)."""
    if grid not in _OUT:
        A, empty, W0, H0 = _data()
        _OUT[grid] = run_grid(sparse_grid_cases, grid,
                              tmp_path_factory.mktemp("sgrid"), _coo(A), W0,
                              H0, CASES,
                              _coo(empty) if grid == (4, 1) else None)
    return _OUT[grid]


class _Place:
    """A rank's place on a grid, as far as the blocks need it (the rows and
    columns of ``parallel/mesh.py::GridContext``), without a group."""

    def __init__(self, shape, rank):
        self.shape, self.coords = shape, divmod(rank, shape[1])

    def rows(self, m):
        return block_range(m, self.shape[0], self.coords[0])

    def cols(self, n):
        return block_range(n, self.shape[1], self.coords[1])


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_blocks_and_perms_are_jax_shard_sparse_grid(grid):
    A = _data()[0]
    with x64():
        gs, _, perm = jsparse.shard_sparse_grid(_bcoo(A), grid_context(*grid),
                                                return_perm=True)
        data, lrows, lcols, perm = (np.asarray(x) for x in
                                    (gs.data, gs.lrows, gs.lcols, perm))
    T = _triplet(_coo(A))
    for rank in range(grid[0] * grid[1]):
        G = sparse.shard_sparse_grid(T, _Place(grid, rank))
        i, j = divmod(rank, grid[1])
        cnt = G.nse
        assert cnt == int((perm[i, j] < T.nse).sum())
        np.testing.assert_array_equal(G.perm.numpy(), perm[i, j, :cnt])
        np.testing.assert_array_equal(G.block.rows.numpy(), lrows[i, j, :cnt])
        np.testing.assert_array_equal(G.block.cols.numpy(), lcols[i, j, :cnt])
        np.testing.assert_array_equal(G.block.data.numpy(), data[i, j, :cnt])
        assert G.block.shape == (M // grid[0], N // grid[1])
        assert G.global_shape == (M, N) and G.flat is T.data


@pytest.mark.parametrize("grid, which", [((3, 1), 0), ((3, 2), 0),
                                         ((4, 1), 1)],
                         ids=["3x1", "3x2", "4x1-empty"])
def test_union_of_blocks_is_the_triplet(grid, which):
    """Every nonzero lies in one block, at its local indices, and the
    block's perm names it; on the 4 x 1 grid over the matrix with an empty
    bottom quarter the last block holds none."""
    T = _triplet(_coo(_data()[which]))
    seen = []
    for rank in range(grid[0] * grid[1]):
        place = _Place(grid, rank)
        G = sparse.shard_sparse_grid(T, place)
        (r0, r1), (c0, c1) = place.rows(M), place.cols(N)
        assert G.block.shape == (r1 - r0, c1 - c0)
        p = G.perm
        assert torch.equal(G.block.rows.long() + r0, T.rows[p].long())
        assert torch.equal(G.block.cols.long() + c0, T.cols[p].long())
        assert torch.equal(G.block.data, T.data[p])
        seen.append(p)
        if which and rank == 3:
            assert G.nse == 0
    assert torch.equal(torch.cat(seen).sort().values, torch.arange(T.nse))


@pytest.mark.parametrize("share, packs", [(8, True), (32, False)])
def test_grid_pack_counts_the_lines_that_hold_a_nonzero(share, packs):
    """A block whose rows use the first 1/share of the columns (a 4 x 1
    block of a topic matrix uses a quarter): ell_pack, as the JAX package's
    shared widths, refuses its mostly empty column lines; grid_ell_pack
    takes the mean over the occupied lines, and packs while the padding
    stays within GRID_MAX_SLOTS slots a nonzero. The packed block carries
    every nonzero once in each orientation."""
    from pydnmfk_tpu_torch.ops import ell
    g = torch.Generator().manual_seed(share)
    m, n = 400, 800
    rows = torch.arange(m).repeat_interleave(60)
    cols = torch.randint(0, n // share, (rows.numel(),), generator=g)
    T = sparse.from_coo(rows, cols, torch.rand(rows.numel(), generator=g,
                                               dtype=torch.float64), (m, n))
    assert ell.ell_pack(T) is None
    packed = ell.grid_ell_pack(T)
    assert (packed is not None) == packs
    if packs:
        E, rperm, cperm, rtail, ctail = packed
        assert E.cvals.numel() <= ell.GRID_MAX_SLOTS * T.nse + 8 * n
        for perm, tail in ((rperm, rtail), (cperm, ctail)):
            held = torch.cat([perm.flatten(), tail]).long()
            assert torch.equal(held[held < T.nse].sort().values,
                               torch.arange(T.nse))
        H = torch.rand((K, n), generator=g, dtype=torch.float64)
        np.testing.assert_allclose(np_(ell.ell_a_ht(E, H)),
                                   np_(sparse.a_ht_triplet(T, H)), rtol=1e-12)


_JAX_PRODUCTS = {}


def _jax_products(grid, A, W0, H0):
    """JAX's grid products of A on ``grid`` at f64 in each of FORMATS, by
    format, whole (one jit for both formats: each shard_map alone would
    compile on its own)."""
    if grid in _JAX_PRODUCTS:
        return _JAX_PRODUCTS[grid]
    import jax

    def products(Gs, W, H):
        eps = 1e-16
        out = {}
        for fmt, G in zip(FORMATS, Gs):
            if fmt == "ell":
                kl = (jell.gell_kl_uht(G, W, H, eps),
                      jell.gell_kl_wtu(G, W, H, eps), jell.gell_col_sqsum(G))
            else:
                kl = (jsparse.rs_kl_uht(G, W, H, eps),
                      jsparse.rs_kl_wtu(G, W, H, eps),
                      jsparse.rs_col_sqsum(G, N))
            out[fmt] = dict(aht=jlinalg.matmul_AHT(G, H),
                            wta=jlinalg.matmul_WTA(W, G), uht=kl[0],
                            wtu=kl[1], colsq=kl[2], sqnorm=jlinalg.sqnorm(G),
                            err=jlinalg.relative_error(G, W, H),
                            col=jlinalg.column_error(G, W, H))
        return out

    with x64():
        ctx = grid_context(*grid)
        Gs = (jsparse.shard_sparse_grid(_bcoo(A), ctx)[0],
              jell.grid_ell_pack(_bcoo(A), ctx))
        out = jax.jit(products)(Gs, jnp.asarray(W0), jnp.asarray(H0))
        _JAX_PRODUCTS[grid] = {fmt: {key: np.asarray(v)
                                     for key, v in got.items()}
                               for fmt, got in out.items()}
    return _JAX_PRODUCTS[grid]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_grid_products_match_jax(grid, fmt, tmp_path_factory):
    out = _port(grid, tmp_path_factory)
    A, _, W0, H0 = _data()
    want = _jax_products(grid, A, W0, H0)[fmt]
    close = lambda got, ref: np.testing.assert_allclose(
        np_(got), ref, rtol=TOL, atol=TOL * np.abs(ref).max())
    for rank in out:
        got = rank[fmt]
        (r0, r1), (c0, c1) = (block_range(M, grid[0], rank["coords"][0]),
                              block_range(N, grid[1], rank["coords"][1]))
        close(got["aht"], want["aht"][r0:r1])
        close(got["wta"], want["wta"][:, c0:c1])
        close(got["kl"][0], want["uht"][r0:r1])
        close(got["kl"][1], want["wtu"][:, c0:c1])
        close(got["colsq"], want["colsq"][c0:c1])
        close(got["sqnorm"], want["sqnorm"])
        close(got["err"], want["err"])
        close(got["col"], want["col"][c0:c1])


_JAX = {}


def _jax_fit(grid, case, which=0):
    """JAX's sparse grid NMF of case's method on ``grid`` from (W0, H0), of
    A (``which`` 0) or of A with its empty bottom quarter (1), at f64, on
    the triplet blocks: JAX's two formats give one fit to f64 rounding, so
    one fit a method (each compiles for seconds) holds the port's fits in
    both formats."""
    method = case.split()[0]
    key = (grid, method, which)
    if key not in _JAX:
        A, W0, H0 = (_data()[i] for i in (which, 2, 3))
        kw = {**CASES[case], "sparse_grid_format": "triplet"}
        with x64():
            cfg = pydnmfk_tpu.NMFConfig(precision="float64", grid=grid, **kw)
            model = pydnmfk_tpu.NMF(cfg)
            W, H, err = model.fit(_bcoo(A), factors=(W0, H0))
            _JAX[key] = (np_(W), np_(H), float(err),
                         np.asarray(model.column_err()))
    return _JAX[key]


def _port_1x1(A, W0, H0, kw):
    model = NMF(NMFConfig(precision="float64", **kw), "cpu")
    W, H, err = model.fit(_triplet(_coo(A)), factors=(torch.from_numpy(W0),
                                                      torch.from_numpy(H0)))
    return np_(W), np_(H), err, model.column_err()


def _check_fit(got, want):
    W, H, err, col = want
    assert got["W"].shape == (M, K) and got["H"].shape == (K, N)
    np.testing.assert_allclose(got["err"], err, rtol=TOL)
    np.testing.assert_allclose(np_(got["W"]), W, rtol=0,
                               atol=TOL * np.abs(W).max())
    np.testing.assert_allclose(np_(got["H"]), H, rtol=0,
                               atol=TOL * np.abs(H).max())
    np.testing.assert_allclose(got["col"], col, rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_sparse_nmf_matches_jax(grid, case, tmp_path_factory):
    """On the even grids against JAX's sparse grid NMF on its 2 x 2 grid
    (:func:`_jax_fit`; the JAX package's even grids give one fit to f64
    rounding); on the uneven 3 x 1, where JAX pads A and W with zero rows,
    against the port's 1x1 fit."""
    out = _port(grid, tmp_path_factory)
    A, _, W0, H0 = _data()
    kw = CASES[case]
    want = (_port_1x1(A, W0, H0, kw) if grid == (3, 1)
            else _jax_fit((2, 2), case))
    for rank in out:
        assert rank[case]["fmt"] == ("EllSparse" if kw["sparse_grid_format"]
                                     == "ell" else "SparseTriplet")
        _check_fit(rank[case], want)


@pytest.mark.parametrize("case", list(CASES))
def test_empty_block_fits_match_jax(case, tmp_path_factory):
    """A 4 x 1 grid over the matrix whose bottom quarter is empty: the last
    rank's block holds no nonzero (no ELL slot, no tail), and the fit is
    JAX's on its 4 x 1 grid."""
    out = _port((4, 1), tmp_path_factory)
    want = _jax_fit((4, 1), case, which=1)
    for rank in out:
        _check_fit(rank["empty " + case], want)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_replicas_stay_bitwise_equal(grid, tmp_path_factory):
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
            assert a[case]["err"] == out[0][case]["err"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_one_sparse_mu_step_issues_four_all_reduces(fmt, tmp_path_factory):
    """As a dense block's: A H^T and H H^T over 'c', W^T A and W^T W over
    'r' (KL: U H^T and H's row sums, W^T U and W's column sums), and no
    gather of A."""
    for rank in _port((2, 2), tmp_path_factory):
        m_i, n_j = (e - s for s, e in (
            block_range(M, 2, rank["coords"][0]),
            block_range(N, 2, rank["coords"][1])))
        fro, kl = rank[fmt]["stats"]["fro"], rank[fmt]["stats"]["kl"]
        assert fro["counts"] == kl["counts"] == {"all-reduce": 4}
        assert fro["bytes"] == 8 * (2 * K * K + m_i * K + K * n_j)
        assert kl["bytes"] == 8 * (2 * K + m_i * K + K * n_j)


def test_data_reader_reads_its_row_panel(tmp_path):
    """A CSR .npz: each rank of a 2 x 2 grid reads indptr, then only its
    rows' indices and data, keeps its columns, and its perm indexes the
    flat values in storage order (the 1x1 triplet's, for a canonical CSR);
    a COO .npz is read whole and cut, its perm indexing the 1x1 triplet."""
    A = _data()[0]
    sp.save_npz(tmp_path / "R.npz", sp.csr_matrix(A))
    sp.save_npz(tmp_path / "C.npz", sp.coo_matrix(A), compressed=False)
    whole = io.DataReader(f"{tmp_path}/", "R", "npz", "float64").read()
    for fname in ("R", "C"):
        blocks = []
        for rank in range(4):
            place = _Place((2, 2), rank)
            reader = io.DataReader(f"{tmp_path}/", fname, "npz", "float64")
            G = reader.read(place)
            (r0, r1), (c0, c1) = place.rows(M), place.cols(N)
            assert reader.rows_read == ([(r0, r1)] if fname == "R"
                                        else [(0, M)])
            assert G.global_shape == (M, N) and G.shape == (r1 - r0, c1 - c0)
            assert torch.equal(G.flat, whole.data)
            dense = np.zeros(G.shape)
            dense[G.block.rows.numpy(), G.block.cols.numpy()] = \
                G.block.data.numpy()
            np.testing.assert_array_equal(dense, A[r0:r1, c0:c1])
            assert torch.equal(G.block.data, G.flat[G.perm])
            assert torch.equal(G.block.rows.long() + r0, whole.rows[G.perm])
            blocks.append(G.perm)
        assert torch.equal(torch.cat(blocks).sort().values,
                           torch.arange(whole.nse))


def test_refusals_that_stay(tmp_path):
    """BCD, nnsvd, prune and a uint8 a_precision with a sparse A raise the
    JAX package's ValueErrors on every rank; so does an ``"ell"`` that only
    block (0, 0) refuses (three dense rows of a 100 x 100 block), after
    the ranks agree, with no rank left waiting; a bad sparse_grid_format
    raises where the config is made."""
    with pytest.raises(ValueError, match="'ell' or 'triplet'"):
        NMFConfig(sparse_grid_format="dense")
    rng = np.random.default_rng(3)
    A = np.eye(200) * rng.random(200)
    A[:3, :100] = rng.random((3, 100)) + 0.5
    out = run_grid(sparse_refusals, (2, 2), tmp_path, _coo(A),
                   str(tmp_path / "res") + "/")
    want = {"bcd": "sparse A supports MU (fro/kl) and HALS",
            "nnsvd": "nnsvd init requires dense A",
            "prune": "prune is not supported with sparse A",
            "uint8": "quantized (uint8) A storage applies to dense A",
            "nmfk prune": "prune is not supported with sparse A",
            "ell": "sparse_grid_format='ell' but the matrix does not "
                   "ELL-pack",
            "auto": "SparseTriplet"}
    for rank in out:
        assert sorted(rank) == sorted(want)
        for key, text in want.items():
            assert text in rank[key], (key, rank[key])


def _torchrun(args, cwd):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=4", "-m", "pydnmfk_tpu_torch", "--cpu",
           "--p_r=2", "--p_c=2", *args]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=180)


@pytest.mark.parametrize("fmt", [None, "ell"])
def test_cli_sparse_sweep_under_torchrun(fmt, tmp_path):
    """``--ftype=npz`` on a 2 x 2 grid: each rank reads its row panel, and
    the sweep picks the 1x1 sweep's k (3) and writes the factors as
    ``W_0..3.npy``."""
    r, c, v, shape = generate_topic_sparse(50, 36, 3, 8, seed=5)
    sp.save_npz(tmp_path / "T.npz", sp.csr_matrix((v.astype(np.float64),
                                                   (r, c)), shape=shape))
    extra = [f"--sparse_grid_format={fmt}"] if fmt else []
    run = _torchrun(["--process=pyDNMFk", "--ftype=npz", "--fname=T",
                     f"--fpath={tmp_path}/", "--norm=fro", "--itr=100",
                     "--start_k=2", "--end_k=4", "--perturbations=6",
                     "--precision=float64", f"--results_path={tmp_path}/res/",
                     *extra], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("Rank estimated by NMFk = 3") == 1, run.stdout
    for k in (2, 3, 4):
        k_dir = tmp_path / "res" / "T" / str(k)
        assert sorted(os.listdir(k_dir / "W_reg_factors")) == \
            [f"W_{b}.npy" for b in range(4)]
        W, H = io.read_factors(str(k_dir), (2, 2))
        assert W.shape == (50, k) and H.shape == (k, 36)
