"""The port's native block reader (``pydnmfk_tpu_torch/native/``) against
numpy slicing and the JAX package's reader, and ``DataReader``'s block
reads through it: an .npy by the C reader, a .mat or .csv through a
one-time .npy copy in the cache directory, the whole file where that
directory is not writable (with a warning), and a numpy memory map where
no C compiler builds the reader (with a warning)."""
import os
import types

import numpy as np
import pytest
from scipy.io import savemat

from pydnmfk_tpu.native import read_npy_block as jax_read_npy_block
from pydnmfk_tpu_torch import native
from pydnmfk_tpu_torch.parallel.partition import BlockPartition, block_range
from pydnmfk_tpu_torch.utils import io

PGRID = (3, 2)


def _need_lib():
    if native.get_lib() is None:
        pytest.skip("no C compiler")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8,
                                   np.int32])
def test_block_read_is_numpy_slicing_and_the_jax_readers(tmp_path, dtype):
    _need_lib()
    A = (np.random.default_rng(0).random((57, 43)) * 100).astype(dtype)
    path = str(tmp_path / "a.npy")
    np.save(path, A)
    before = native.READS["native"]
    for rows, cols in (((11, 40), (7, 31)), ((0, 57), (0, 43)),
                       ((56, 57), (42, 43))):
        blk = native.read_npy_block(path, *rows, *cols)
        assert blk.dtype == A.dtype
        np.testing.assert_array_equal(blk, A[slice(*rows), slice(*cols)])
        np.testing.assert_array_equal(blk, jax_read_npy_block(
            path, *rows, *cols))
    assert native.READS["native"] == before + 3
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()


def test_fortran_order_is_left_to_numpy(tmp_path):
    path = str(tmp_path / "f.npy")
    np.save(path, np.asfortranarray(np.arange(12.0).reshape(3, 4)))
    assert native.parse_npy_header(path) is None
    assert native.read_npy_block(path, 0, 2, 0, 2) is None


def _grid(rank, pgrid=PGRID):
    """The rows and columns of a rank's block, as a GridContext gives
    them."""
    i, j = divmod(rank, pgrid[1])
    return types.SimpleNamespace(rows=lambda m: block_range(m, pgrid[0], i),
                                 cols=lambda n: block_range(n, pgrid[1], j))


def _write(tmp_path, ftype, A):
    if ftype == "npy":
        np.save(tmp_path / "A.npy", A)
    elif ftype == "mat":
        savemat(tmp_path / "A.mat", {"X": A})
    else:
        np.savetxt(tmp_path / "A.csv", A, delimiter=",")


def _blocks(tmp_path, ftype, A):
    """Every rank's block on the 3 x 2 grid through DataReader.read(grid)
    and read_chunk, each bitwise A's."""
    reader = io.DataReader(f"{tmp_path}/", "A", ftype, precision="float64",
                           pgrid=PGRID)
    for rank in range(PGRID[0] * PGRID[1]):
        want = A[BlockPartition(rank, PGRID, A.shape).slices()]
        np.testing.assert_array_equal(reader.read(_grid(rank)), want)
        np.testing.assert_array_equal(reader.read_chunk(rank), want)


@pytest.mark.parametrize("ftype", ["npy", "mat", "csv"])
def test_reader_block_reads_go_through_the_native_reader(tmp_path,
                                                         monkeypatch, ftype):
    _need_lib()
    cache = tmp_path / "cache"
    monkeypatch.setenv(io.CACHE_ENV, str(cache))
    A = np.random.default_rng(1).random((31, 20))
    _write(tmp_path, ftype, A)
    reads = dict(io.BLOCK_READS)
    served = dict(native.READS)
    _blocks(tmp_path, ftype, A)
    key = "npy" if ftype == "npy" else "cache"
    assert io.BLOCK_READS[key] - reads[key] == 12
    assert native.READS["native"] - served["native"] == 12
    assert native.READS["mmap"] == served["mmap"]
    assert io.BLOCK_READS["whole"] == reads["whole"]
    copies = sorted(os.listdir(cache)) if cache.exists() else []
    assert len(copies) == (0 if ftype == "npy" else 1)
    if copies:
        np.testing.assert_array_equal(np.load(cache / copies[0]), A)


def test_unwritable_cache_directory_reads_the_whole_file_loudly(
        tmp_path, monkeypatch):
    (tmp_path / "file").write_text("")
    monkeypatch.setenv(io.CACHE_ENV, str(tmp_path / "file" / "cache"))
    A = np.random.default_rng(2).random((17, 9))
    _write(tmp_path, "mat", A)
    whole = io.BLOCK_READS["whole"]
    with pytest.warns(UserWarning, match="not writable") as record:
        _blocks(tmp_path, "mat", A)
    assert len(record) == 1                  # once a reader
    assert io.BLOCK_READS["whole"] - whole == 12


def test_without_a_compiler_the_reader_warns_and_maps(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda cc: None)
    A = np.random.default_rng(3).random((13, 8))
    _write(tmp_path, "npy", A)
    mapped = native.READS["mmap"]
    with pytest.warns(UserWarning, match="no C compiler"):
        _blocks(tmp_path, "npy", A)
    assert native.READS["mmap"] - mapped == 12
