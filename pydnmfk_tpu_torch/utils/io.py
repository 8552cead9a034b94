"""Data and results IO.

Port of ``pydnmfk_tpu/utils/io.py`` (reference pyDNMFk/data_io.py): the
reader loads a whole .npy, .mat (variable ``X``) or .csv/.txt matrix, a
scipy.sparse ``save_npz`` file (.npz) as a canonical
``ops/sparse.py::SparseTriplet``, or a ``folder`` of chunk files
``{fname}{rank}.npy`` that split A into the remainder-balanced blocks of a
``pgrid`` (reference data_io.py:44-47), assembled into the whole matrix.
On a p_r x p_c grid of processes, ``read(grid)`` gives this rank's block
alone: an .npy by slicing a memory map, a ``folder`` from the chunks that
meet the block (``io.py:393-420``), a .mat or .csv/.txt by reading the file
and slicing it, as the reference does. The writer keeps the reference's
layout of factors (``W_[reg_]factors/``, ``H_[reg_]factors/``, in the
chunks of the JAX package's ``DataWriter`` on a grid, ``io.py:504-545``)
and per-k statistics.

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

from ..parallel.partition import block_range, rank_to_block_order_H

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

    def read(self, grid=None):
        """The matrix: a numpy array (a bf16 tensor at bfloat16), or a
        SparseTriplet for npz; with a ``grid`` (``parallel/mesh.py``) this
        rank's block of it, read alone where the format allows."""
        if grid is not None:
            return self._read_block(grid)
        if self.ftype == "folder":
            return self._cast(self._read_folder())
        path = os.path.join(self.fpath, self.fname + "." + self.ftype)
        if self.ftype == "npz":
            return self._read_sparse(path)
        return self._cast(self._load(path, mmap=False))

    def _load(self, path, mmap: bool):
        if self.ftype == "npy":
            return np.load(path, mmap_mode="r" if mmap else None)
        if self.ftype == "mat":
            from scipy.io import loadmat
            return np.asarray(loadmat(path)["X"])
        return np.loadtxt(path, delimiter=",", ndmin=2)

    def _read_block(self, grid):
        """This rank's block of the remainder-balanced layout on ``grid``."""
        if self.ftype == "npz":
            from ..config import SPARSE_GRID, NotPortedError
            raise NotPortedError(SPARSE_GRID + ": npz to grid-ELL",
                                 "queue 1 item 15")
        if self.ftype == "folder":
            m, n = self._folder_shape()
            (r0, r1), (c0, c1) = grid.rows(m), grid.cols(n)
            return self._cast(self._read_folder_block(r0, r1, c0, c1, m, n))
        data = self._load(os.path.join(self.fpath,
                                       self.fname + "." + self.ftype),
                          mmap=True)
        return self._cast(np.ascontiguousarray(grid.block(data)))

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
        m, n = self._folder_shape()
        return self._read_folder_block(0, m, 0, n, m, n)

    def _read_folder_block(self, r0, r1, c0, c1, m, n) -> np.ndarray:
        """Rows [r0, r1) and columns [c0, c1) of the m x n matrix from only
        the chunks that meet them (``utils/io.py:393-420``), each checked
        against its block of the remainder-balanced layout."""
        p_r, p_c = self.pgrid
        out = None
        for i in range(p_r):
            rs, re = block_range(m, p_r, i)
            if re <= r0 or rs >= r1:
                continue
            for j in range(p_c):
                cs, ce = block_range(n, p_c, j)
                if ce <= c0 or cs >= c1:
                    continue
                chunk = np.load(self._chunk_path(i * p_c + j), mmap_mode="r")
                if chunk.shape != (re - rs, ce - cs):
                    raise ValueError(
                        f"chunk {i * p_c + j} of {self.fname!r} has shape "
                        f"{chunk.shape}, not its block's "
                        f"{(re - rs, ce - cs)} of {(m, n)} on a "
                        f"{self.pgrid} grid")
                if out is None:
                    out = np.empty((r1 - r0, c1 - c0), dtype=chunk.dtype)
                lo, hi = max(r0, rs), min(r1, re)
                left, right = max(c0, cs), min(c1, ce)
                out[lo - r0:hi - r0, left - c0:right - c0] = \
                    chunk[lo - rs:hi - rs, left - cs:right - cs]
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
    """API mirror of reference ``data_write`` (data_io.py:143-209): whole
    factors, saved in the chunks of a ``pgrid``'s layout."""

    def __init__(self, results_path: str, pgrid=(1, 1)):
        self.fpath = results_path
        self.pgrid = tuple(int(p) for p in pgrid)
        os.makedirs(self.fpath, exist_ok=True)

    def save_factors(self, W, H, reg: bool = False):
        """W (m, k) and H (k, n) as the JAX package's DataWriter lays them
        out (``io.py:504-545``): ``W.npy`` and ``H.npy`` on a 1x1 grid;
        H in p_c column chunks ``H_{j}.npy`` on a 1 x p_c grid; W in p_r
        row chunks ``W_{i}.npy`` on a p_r x 1 grid; on a 2D grid W in p =
        p_r p_c row chunks in rank order and H in p column chunks, chunk b
        saved as ``H_{order[b]}.npy`` (:func:`rank_to_block_order_H`)."""
        tag = "reg_" if reg else ""
        W, H = to_numpy(W), to_numpy(H)
        wdir = os.path.join(self.fpath, f"W_{tag}factors")
        hdir = os.path.join(self.fpath, f"H_{tag}factors")
        os.makedirs(wdir, exist_ok=True)
        os.makedirs(hdir, exist_ok=True)
        p_r, p_c = self.pgrid
        w_chunks = p_r if p_c == 1 else (1 if p_r == 1 else p_r * p_c)
        h_chunks = p_c if p_r == 1 else (1 if p_c == 1 else p_r * p_c)
        order = (rank_to_block_order_H(p_r, p_c) if min(p_r, p_c) > 1
                 else list(range(h_chunks)))
        if w_chunks == 1:
            np.save(os.path.join(wdir, "W.npy"), W)
        for b in range(w_chunks if w_chunks > 1 else 0):
            s, e = block_range(W.shape[0], w_chunks, b)
            np.save(os.path.join(wdir, f"W_{b}.npy"), W[s:e])
        if h_chunks == 1:
            np.save(os.path.join(hdir, "H.npy"), H)
        for b in range(h_chunks if h_chunks > 1 else 0):
            s, e = block_range(H.shape[1], h_chunks, b)
            np.save(os.path.join(hdir, f"H_{order[b]}.npy"), H[:, s:e])

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
    data_io.py:212-261), reassembled from the chunks of a ``pgrid``'s
    layout with its H order (``io.py:573-597``)."""
    tag = "reg_" if reg else ""

    def chunks(name):
        files = glob.glob(os.path.join(factors_path, f"{name}_{tag}factors",
                                       "*.npy"))
        key = lambda p: int(os.path.basename(p)[len(name) + 1:-4] or 0)
        return [np.load(f) for f in sorted(files, key=key)]

    W_parts, H_parts = chunks("W"), chunks("H")
    if len(H_parts) > 1 and len(W_parts) > 1:
        H_parts = [H_parts[b] for b in rank_to_block_order_H(*pgrid)]
    return np.vstack(W_parts), np.hstack(H_parts)
