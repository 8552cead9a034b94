"""Data and results IO.

Port of ``pydnmfk_tpu/utils/io.py`` (reference pyDNMFk/data_io.py): the
reader loads a whole .npy, .mat (variable ``X``) or .csv/.txt matrix, a
scipy.sparse ``save_npz`` file (.npz) as a canonical
``ops/sparse.py::SparseTriplet``, or a ``folder`` of chunk files
``{fname}{rank}.npy`` that split A into the remainder-balanced blocks of a
``pgrid`` (reference data_io.py:44-47), assembled into the whole matrix.
On a p_r x p_c grid of processes, ``read(grid)`` gives this rank's block
alone (on every ensemble group alike): an .npy through the native block
reader (``native/``), which reads only the block's bytes; a .mat or
.csv/.txt through a one-time .npy copy of it in a cache directory, read
the same way (``io.py:76-128``); a ``folder`` from the chunks that meet
the block (``io.py:393-420``); and an .npz as a
``ops/sparse.py::SparseGridInput``: of a CSR file only this rank's row
panel (``io.py:231-357``). ``read_chunk`` reads a block of a dense file
the same way. The writer keeps the reference's
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
import hashlib
import os
import warnings

import numpy as np
import torch

from .. import native
from ..parallel.partition import block_range, rank_to_block_order_H

# the directory of the .npy copies of .mat, .csv and .txt files that block
# reads take (the JAX package's, ``io.py:88-90``, under the port's name)
CACHE_ENV = "PYDNMFK_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join("~", ".cache", "pydnmfk_tpu_torch")
# dense block reads by source: the .npy itself, the cached copy of a .mat,
# .csv or .txt, or the whole file parsed (no writable cache directory);
# ``native.READS`` says which reader served the first two
BLOCK_READS = {"npy": 0, "cache": 0, "whole": 0}

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
        if self.ftype == "npz":
            return self._read_sparse(self._path())
        return self._cast(self._load(self._path()))

    def read_global(self):
        """The whole matrix, as :meth:`read` without a grid gives it (the
        JAX package's single-host read, ``io.py:130-148``): a numpy array
        (a bf16 tensor at bfloat16), a ``folder``'s chunks assembled, or a
        SparseTriplet for npz; timed under ``read_global``."""
        from . import timing
        with timing.timed("read_global"):
            return self.read()

    def _load(self, path):
        if self.ftype == "npy":
            return np.load(path)
        if self.ftype == "mat":
            from scipy.io import loadmat
            return np.asarray(loadmat(path)["X"])
        return np.loadtxt(path, delimiter=",", ndmin=2)

    def _read_block(self, grid):
        """This rank's block of the remainder-balanced layout on ``grid``."""
        if self.ftype == "npz":
            return self._read_sparse_block(grid)
        if self.ftype == "folder":
            m, n = self._folder_shape()
            (r0, r1), (c0, c1) = grid.rows(m), grid.cols(n)
            return self._cast(self._read_folder_block(r0, r1, c0, c1, m, n))
        return self._dense_block(lambda m, n: (grid.rows(m), grid.cols(n)))

    def read_chunk(self, rank: int):
        """Chunk ``rank`` of a ``folder`` (reference data_partition,
        data_io.py:70-83), or block ``rank`` of the ``pgrid`` of any other
        dense format, read as a grid's rank reads its block."""
        if self.ftype == "folder":
            return self._cast(np.load(self._chunk_path(rank)))
        if self.ftype == "npz":
            raise ValueError("read_chunk takes a dense format, not npz")
        i, j = divmod(rank, self.pgrid[1])
        return self._dense_block(lambda m, n: (
            block_range(m, self.pgrid[0], i), block_range(n, self.pgrid[1],
                                                          j)))

    def _dense_block(self, ranges):
        """The block ``ranges(m, n)`` = ((r0, r1), (c0, c1)) of a dense
        m x n file: of an .npy, or of a .mat, .csv or .txt through its
        cached .npy copy, only the block's bytes (the native reader, else
        a numpy memory map); where the cache directory is not writable,
        of the whole file parsed (``io.py:113-125``)."""
        path = self._block_readable_path()
        if path is None:
            data = self._load(self._path())
            BLOCK_READS["whole"] += 1
            (r0, r1), (c0, c1) = ranges(*data.shape)
            return self._cast(np.ascontiguousarray(data[r0:r1, c0:c1]))
        BLOCK_READS["npy" if self.ftype == "npy" else "cache"] += 1
        mapped = np.load(path, mmap_mode="r")
        (r0, r1), (c0, c1) = ranges(*mapped.shape)
        blk = native.read_npy_block(path, r0, r1, c0, c1)
        if blk is None:
            native.READS["mmap"] += 1
            blk = np.ascontiguousarray(mapped[r0:r1, c0:c1])
        return self._cast(blk)

    def _path(self) -> str:
        return os.path.join(self.fpath, self.fname + "." + self.ftype)

    def _block_readable_path(self):
        """An .npy that the block reader can read (``io.py:76-128``): the
        file itself for an .npy; for a .mat, .csv or .txt a copy of it as
        an .npy in ``$PYDNMFK_CACHE_DIR`` (default
        ``~/.cache/pydnmfk_tpu_torch``), written once, the first time a
        block is read, and again only where the source is newer. The
        reference parses the whole file on every rank of every run
        (data_io.py:92-105); here the whole parse happens once a file.
        None, with one loud warning a reader, where the directory is not
        writable: every block then parses the whole file."""
        if self.ftype == "npy":
            return self._path()
        src = self._path()
        root = os.path.expanduser(os.environ.get(CACHE_ENV)
                                  or DEFAULT_CACHE_DIR)
        key = hashlib.sha1(os.path.abspath(src).encode()).hexdigest()[:16]
        cache = os.path.join(root, f"{self.fname}.{key}.npy")
        try:
            if (os.path.exists(cache)
                    and os.path.getmtime(cache) >= os.path.getmtime(src)):
                return cache
            os.makedirs(root, exist_ok=True)
            data = np.ascontiguousarray(self._load(src))
            tmp = f"{cache}.tmp{os.getpid()}.npy"
            np.save(tmp, data)
            os.replace(tmp, cache)    # atomic: ranks that race write the
            return cache              # same bytes
        except OSError:
            if not getattr(self, "_warned_cache", False):
                self._warned_cache = True
                warnings.warn(
                    f"cache directory {root!r} is not writable: every block "
                    f"read of {src!r} parses the whole file (set "
                    f"{CACHE_ENV} to a writable directory to block-read "
                    f"{self.ftype} files)")
            return None

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

    def _read_sparse_block(self, grid):
        """This rank's block of a save_npz matrix on ``grid``, as a
        SparseGridInput (``utils/io.py:231-357``). A CSR file is read by
        row panels: ``indptr`` whole, then ``indices`` and ``data`` of this
        rank's rows alone, of which it keeps its columns; the flat values
        (every rank's, for the NMFk members' noise; the block's values are
        cut from them) in one pass, in storage order, which ``perm``
        indexes. A canonical CSR (sorted, unique
        column indices, as scipy writes a matrix it built) stores the
        entries in the 1x1 triplet's row-major order, so a member's block
        is the 1x1 member's. ``rows_read`` records the row panels read
        (the JAX package's ``npz_rows_materialized``). Any other .npz is
        read whole and cut (``io.py:270-278``)."""
        import zipfile
        from ..ops.sparse import SparseGridInput, SparseTriplet
        from ..ops.sparse import shard_sparse_grid
        path = os.path.join(self.fpath, self.fname + ".npz")
        with zipfile.ZipFile(path) as zf:
            csr = ("format.npy" in zf.namelist() and
                   bytes(_npz_member(zf, "format.npy")) == b"csr")
            if not csr:
                A = self._read_sparse(path)
                self.rows_read = [(0, A.shape[0])]
                return shard_sparse_grid(A, grid)
            m, n = (int(v) for v in _npz_member(zf, "shape.npy"))
            indptr = _npz_member(zf, "indptr.npy").astype(np.int64)
            (r0, r1), (c0, c1) = grid.rows(m), grid.cols(n)
            s, e = int(indptr[r0]), int(indptr[r1])
            cols = _npz_member(zf, "indices.npy", s, e - s).astype(np.int64)
            flat = _npz_member(zf, "data.npy")
        data = flat[s:e]
        self.rows_read = [(r0, r1)]
        rows = np.repeat(np.arange(r0, r1), np.diff(indptr[r0:r1 + 1]))
        if np.any((np.diff(cols) == 0) & (np.diff(rows) == 0)):
            raise ValueError(
                f"{path} holds a CSR matrix with duplicate entries in a "
                f"row; sum them (scipy's sum_duplicates) before save_npz")
        sel = np.nonzero((cols >= c0) & (cols < c1))[0]
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
        block = SparseTriplet(torch.as_tensor(self._cast(data[sel])),
                              t((rows[sel] - r0).astype(np.int32)),
                              t((cols[sel] - c0).astype(np.int32)),
                              (r1 - r0, c1 - c0))
        return SparseGridInput(block, t(s + sel), torch.as_tensor(
            self._cast(flat)), (m, n))

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


def _npz_member(zf, name, start: int = 0, count=None) -> np.ndarray:
    """The 1-D array ``name`` of an open .npz, or its elements [start,
    start + count): the stream is read from its header to the slice, so
    only the slice is kept."""
    from numpy.lib import format as npfmt
    with zf.open(name) as f:
        version = npfmt.read_magic(f)
        shape, _, dtype = (npfmt.read_array_header_1_0(f) if version == (1, 0)
                           else npfmt.read_array_header_2_0(f))
        count = int(np.prod(shape)) - start if count is None else count
        f.seek(f.tell() + start * dtype.itemsize)
        return np.frombuffer(f.read(count * dtype.itemsize), dtype, count)


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
