"""Data and results IO on one device.

Port of ``pydnmfk_tpu/utils/io.py`` (reference pyDNMFk/data_io.py) for a 1x1
grid: the reader loads a whole .npy, .mat (variable ``X``) or .csv/.txt
matrix, a scipy.sparse ``save_npz`` file (.npz) as a canonical
``ops/sparse.py::SparseTriplet``, or a ``folder`` of chunk files
``{fname}{rank}.npy`` that split A into the remainder-balanced blocks of a
``pgrid`` (reference data_io.py:44-47), assembled into the whole matrix;
the writer keeps the reference's layout of factors
(``W_[reg_]factors/W.npy``, ``H_[reg_]factors/H.npy``) and per-k
statistics.

A reader at ``precision="bfloat16"`` returns a bf16 torch tensor (read at
f32 and rounded by torch: numpy has no bf16 without ``ml_dtypes``); every
other precision a numpy array. The writers save bf16 factors widened to f32
(exact), since ``.npy`` has no bf16; f16 factors stay f16.

The statistics go to ``results.h5`` with the reference's dataset names
(data_io.py:198-209) where ``h5py`` is installed, and otherwise to
``results.npz`` with the same names; :func:`read_cluster_results` reads
whichever exists.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

# dataset names of results.h5 (pydnmfk_tpu/utils/io.py:557-565) and the
# stats keys they hold
RESULT_DATASETS = {
    "clusterSilhouetteCoefficients": "clusterSilhouetteCoefficients",
    "avgSilhouetteCoefficients": "avgSilhouetteCoefficients",
    "L_err": "L_err",
    "L_errDist": "L_errDist",
    "avgErr": "avgErr",
    "ErrTol": "recon_err",
    "AIC": "AIC",
}


def block_range(dim: int, nblocks: int, index: int):
    """[start, end) of block ``index`` of ``nblocks`` over ``dim``, the
    first ``dim % nblocks`` blocks one longer
    (``pydnmfk_tpu/parallel/partition.py:27-32``)."""
    q, r = divmod(dim, nblocks)
    return index * q + min(index, r), (index + 1) * q + min(index + 1, r)


class DataReader:
    """API mirror of reference ``data_read`` (data_io.py:12-105), whole-file
    reads on one host. ``pgrid=(p_r, p_c)`` is the chunk layout of a
    ``folder``: chunk ``i * p_c + j`` holds block (i, j)."""

    def __init__(self, fpath: str, fname: str, ftype: str = "mat",
                 precision: str = "float32", pgrid=(1, 1)):
        if ftype not in ("npy", "mat", "csv", "txt", "npz", "folder"):
            raise ValueError(f"unknown ftype {ftype!r}")
        self.fpath = fpath
        self.fname = fname
        self.ftype = ftype
        self.precision = precision
        self.pgrid = tuple(int(p) for p in pgrid)

    def read(self):
        """The matrix: a numpy array (a bf16 tensor at bfloat16), or a
        SparseTriplet for npz."""
        if self.ftype == "folder":
            return self._cast(self._read_folder())
        path = os.path.join(self.fpath, self.fname + "." + self.ftype)
        if self.ftype == "npz":
            return self._read_sparse(path)
        if self.ftype == "npy":
            data = np.load(path)
        elif self.ftype == "mat":
            from scipy.io import loadmat
            data = loadmat(path)["X"]
        else:
            data = np.loadtxt(path, delimiter=",", ndmin=2)
        return self._cast(np.asarray(data))

    def read_chunk(self, rank: int):
        """Chunk ``rank`` of a ``folder`` (reference data_partition,
        data_io.py:70-83), or block ``rank`` of the ``pgrid`` of any other
        dense format, read whole."""
        if self.ftype == "folder":
            return self._cast(np.load(self._chunk_path(rank)))
        if self.ftype == "npz":
            raise ValueError("read_chunk takes a dense format, not npz")
        i, j = divmod(rank, self.pgrid[1])
        data = self.read()
        r0, r1 = block_range(data.shape[0], self.pgrid[0], i)
        c0, c1 = block_range(data.shape[1], self.pgrid[1], j)
        return data[r0:r1, c0:c1]

    def _chunk_path(self, rank: int) -> str:
        return os.path.join(self.fpath, f"{self.fname}{rank}.npy")

    def _folder_shape(self) -> tuple:
        """The dims from the chunks' headers (``utils/io.py:375-391``): m
        sums the first column's heights, n the first row's widths."""
        p_r, p_c = self.pgrid
        shape = lambda rank: np.load(self._chunk_path(rank),
                                     mmap_mode="r").shape
        return (sum(shape(i * p_c)[0] for i in range(p_r)),
                sum(shape(j)[1] for j in range(p_c)))

    def _read_folder(self) -> np.ndarray:
        """The whole matrix from its chunks (``utils/io.py:393-420``), each
        checked against its block of the remainder-balanced layout."""
        p_r, p_c = self.pgrid
        m, n = self._folder_shape()
        out = None
        for i in range(p_r):
            r0, r1 = block_range(m, p_r, i)
            for j in range(p_c):
                c0, c1 = block_range(n, p_c, j)
                chunk = np.load(self._chunk_path(i * p_c + j), mmap_mode="r")
                if chunk.shape != (r1 - r0, c1 - c0):
                    raise ValueError(
                        f"chunk {i * p_c + j} of {self.fname!r} has shape "
                        f"{chunk.shape}, not its block's "
                        f"{(r1 - r0, c1 - c0)} of {(m, n)} on a "
                        f"{self.pgrid} grid")
                if out is None:
                    out = np.empty((m, n), dtype=chunk.dtype)
                out[r0:r1, c0:c1] = chunk
        return out

    def _cast(self, data: np.ndarray):
        if self.precision == "bfloat16":
            return torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
        return data.astype(self.precision)

    def _read_sparse(self, path):
        """A save_npz matrix as a canonical triplet: duplicates summed,
        row-major order (``utils/io.py:150-161``), on the CPU."""
        from scipy import sparse as sp
        from ..ops.sparse import from_coo
        M = sp.load_npz(path).tocoo()
        M.sum_duplicates()
        return from_coo(torch.from_numpy(M.row.astype(np.int32)),
                        torch.from_numpy(M.col.astype(np.int32)),
                        torch.as_tensor(self._cast(M.data)), M.shape)


def to_numpy(x) -> np.ndarray:
    """x as a numpy array; a bf16 tensor widened to f32 (exact)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DataWriter:
    """API mirror of reference ``data_write`` (data_io.py:143-209) for a 1x1
    grid."""

    def __init__(self, results_path: str):
        self.fpath = results_path
        os.makedirs(self.fpath, exist_ok=True)

    def save_factors(self, W, H, reg: bool = False):
        tag = "reg_" if reg else ""
        for name, X in (("W", W), ("H", H)):
            d = os.path.join(self.fpath, f"{name}_{tag}factors")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{name}.npy"), to_numpy(X))

    def save_cluster_results(self, stats: dict, config: dict = None):
        """Per-k statistics under the reference's dataset names, with the
        run configuration as attributes (h5) or a ``config`` entry (npz)."""
        data = {name: to_numpy(stats[key])
                for name, key in RESULT_DATASETS.items()}
        try:
            import h5py
        except ImportError:
            np.savez(os.path.join(self.fpath, "results.npz"),
                     config=np.asarray(repr(config or {})), **data)
            return
        with h5py.File(os.path.join(self.fpath, "results.h5"), "w") as hf:
            for key, val in (config or {}).items():
                try:
                    hf.attrs[key] = val
                except TypeError:
                    hf.attrs[key] = str(val)
            for name, val in data.items():
                hf.create_dataset(name, data=val)


def read_cluster_results(k_path: str) -> dict:
    """The datasets of ``k_path/results.h5``, or of ``results.npz`` where
    the writer had no h5py."""
    h5 = os.path.join(k_path, "results.h5")
    if os.path.exists(h5):
        import h5py
        with h5py.File(h5, "r") as f:
            return {name: np.array(f[name]) for name in RESULT_DATASETS}
    with np.load(os.path.join(k_path, "results.npz")) as f:
        return {name: np.array(f[name]) for name in RESULT_DATASETS}


def read_factors(factors_path: str, pgrid=(1, 1), reg: bool = True):
    """(W, H) as :class:`DataWriter` saved them under ``factors_path``
    (``W_[reg_]factors/``, ``H_[reg_]factors/``; reference read_factors,
    data_io.py:212-261), one file each on a 1x1 grid."""
    if tuple(pgrid) != (1, 1):
        from ..config import NotPortedError
        raise NotPortedError(f"factors of a {tuple(pgrid)} grid",
                             "queue 1 item 15")
    tag = "reg_" if reg else ""
    W, H = (np.load(sorted(glob.glob(os.path.join(
        factors_path, f"{name}_{tag}factors", "*.npy")))[0])
        for name in ("W", "H"))
    return W, H
