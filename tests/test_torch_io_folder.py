"""The port's ``folder`` reader (``utils/io.py::DataReader`` with
``ftype="folder"``) against the JAX package's ``DataReader(..., pgrid)`` on
the same chunk files ``{fname}{rank}.npy``: equal arrays, bitwise, for even
and uneven dims; ``read_chunk`` alike; and the CLI and Runner reading a
folder at 1x1 (the chunk file ``{fname}0.npy``)."""
import numpy as np
import pytest
import torch

from pydnmfk_tpu.parallel.partition import block_range as jax_block_range
from pydnmfk_tpu.utils.io import DataReader as JaxReader
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch import cli
from pydnmfk_tpu_torch.utils.io import DataReader, block_range


def _write_chunks(path, A, pgrid, fname="F"):
    p_r, p_c = pgrid
    for i in range(p_r):
        r0, r1 = jax_block_range(A.shape[0], p_r, i)
        for j in range(p_c):
            c0, c1 = jax_block_range(A.shape[1], p_c, j)
            np.save(path / f"{fname}{i * p_c + j}.npy", A[r0:r1, c0:c1])


@pytest.mark.parametrize("dim, nblocks", [(10, 3), (12, 4), (7, 7), (5, 1),
                                          (3, 5)])
def test_block_range_is_the_jax_packages(dim, nblocks):
    assert [block_range(dim, nblocks, i) for i in range(nblocks)] == [
        jax_block_range(dim, nblocks, i) for i in range(nblocks)]


@pytest.mark.parametrize("shape", [(12, 8), (11, 7), (10, 6)])
@pytest.mark.parametrize("pgrid", [(1, 1), (2, 2), (3, 2), (1, 3)])
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_folder_equals_the_jax_reader(tmp_path, shape, pgrid, precision):
    A = np.random.default_rng(sum(shape)).random(shape)
    _write_chunks(tmp_path, A, pgrid)
    ours = DataReader(f"{tmp_path}/", "F", "folder", precision,
                      pgrid=pgrid).read()
    theirs = JaxReader(f"{tmp_path}/", "F", "folder", pgrid=pgrid,
                       precision=precision).read()
    assert ours.dtype == np.dtype(precision)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_array_equal(ours, A.astype(precision))
    reader = DataReader(f"{tmp_path}/", "F", "folder", precision, pgrid=pgrid)
    jreader = JaxReader(f"{tmp_path}/", "F", "folder", pgrid=pgrid,
                        precision=precision)
    assert reader._folder_shape() == jreader._folder_shape() == shape
    for rank in range(pgrid[0] * pgrid[1]):
        np.testing.assert_array_equal(reader.read_chunk(rank),
                                      jreader.read_chunk(rank))


def test_folder_at_bfloat16_is_a_rounded_tensor(tmp_path):
    A = np.random.default_rng(0).random((9, 7)).astype(np.float32)
    _write_chunks(tmp_path, A, (2, 2))
    out = DataReader(f"{tmp_path}/", "F", "folder", "bfloat16",
                     pgrid=(2, 2)).read()
    assert torch.equal(out, torch.from_numpy(A).to(torch.bfloat16))


def test_a_chunk_off_the_layout_raises(tmp_path):
    A = np.random.default_rng(0).random((10, 6))
    _write_chunks(tmp_path, A, (2, 2))
    np.save(tmp_path / "F3.npy", A[:4, :3])       # block (1, 1) is 5 x 3
    with pytest.raises(ValueError, match="chunk 3"):
        DataReader(f"{tmp_path}/", "F", "folder", pgrid=(2, 2)).read()


def test_dense_read_chunk_is_the_jax_packages(tmp_path):
    A = np.random.default_rng(1).random((11, 7))
    np.save(tmp_path / "X.npy", A)
    for rank in range(6):
        np.testing.assert_array_equal(
            DataReader(f"{tmp_path}/", "X", "npy", "float64",
                       pgrid=(3, 2)).read_chunk(rank),
            JaxReader(f"{tmp_path}/", "X", "npy", pgrid=(3, 2),
                      precision="float64").read_chunk(rank))


def test_cli_and_runner_read_a_folder_at_1x1(tmp_path):
    rng = np.random.default_rng(0)
    A = (rng.random((30, 4)) @ rng.random((4, 20))).astype(np.float32)
    np.save(tmp_path / "F0.npy", A)
    np.save(tmp_path / "X.npy", A)
    base = ["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1",
            f"--fpath={tmp_path}/", "--norm=fro", "--k=4", "--itr=30",
            f"--results_path={tmp_path}/res/"]
    folder = cli.main(base + ["--ftype=folder", "--fname=F"])
    npy = cli.main(base + ["--ftype=npy", "--fname=X"])
    assert folder["err"] == npy["err"]
    assert torch.equal(folder["W"], npy["W"])
    out = port.Runner(norm="fro", itr=30, device="cpu").run(
        fpath=f"{tmp_path}/", ftype="folder", fname="F",
        results_path=f"{tmp_path}/res2/", k=4)
    assert out["err"] == npy["err"]
    # a larger grid names the mesh at the CLI, which is not ported
    with pytest.raises(port.NotPortedError, match="item 15"):
        cli.main(base + ["--ftype=folder", "--fname=F", "--p_r=2"])
