"""Miscellaneous matrix and ensemble utilities.

Port of ``pydnmfk_tpu/utils/matrix_utils.py`` (numpy only, as there): the
reference's legacy helpers on ``data_operations`` (pyDNMFk/utils.py:
221-342) and ``split_files_save`` (data_io.py:108-139), with the JAX
package's fixes (the reference's ``recZero`` names an undefined variable,
:251, and its ``split_files_save`` writes the whole matrix to every chunk,
:139). :func:`split_files_save` writes the remainder-balanced chunk layout
(``parallel/partition.py``) that ``utils/io.py``'s ``folder`` reader reads.
"""
from __future__ import annotations

import os
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from ..parallel.partition import partition_slices


def cut_zero(ten: np.ndarray, thresh: float = 1e-8):
    """Remove all-(near-)zero slices along every axis
    (reference cutZero :221-243).  Returns (pruned, index_lists) where
    index_lists[d] = (kept_indices, original_dim)."""
    ten = np.asarray(ten)
    index_lists = []
    for d in range(ten.ndim):
        orig_dim = ten.shape[d]
        axes = tuple(i for i in range(ten.ndim) if i != d)
        keep = np.nonzero(ten.sum(axis=axes) > thresh)[0]
        ten = np.take(ten, keep, axis=d)
        index_lists.append((keep, orig_dim))
    return ten, index_lists


def rec_zero(ten: np.ndarray, index_lists, full_shape: Sequence[int]):
    """Inverse of cut_zero: scatter back into a zero tensor of full_shape
    (reference recZero :245-268, fixed)."""
    out = np.zeros(full_shape, dtype=ten.dtype)
    idx = np.ix_(*[keep for keep, _ in index_lists])
    out[idx] = ten
    return out


def desample(ten: np.ndarray, factor: int = 3, axis: int = 0):
    """Downsample by summing consecutive groups of ``factor`` along axis
    (reference desampleT :270-281)."""
    ten = np.moveaxis(np.asarray(ten), axis, 0)
    ngroups = ten.shape[0] // factor
    ten = ten[:ngroups * factor]
    ten = ten.reshape((ngroups, factor) + ten.shape[1:]).sum(axis=1)
    return np.moveaxis(ten, 0, axis)


def remove_bad_factors(W_all: np.ndarray, H_all: np.ndarray,
                       err_tol: np.ndarray, k: int):
    """Drop the worst-erroring 10% of ensemble members
    (reference remove_bad_factors :283-294).  W_all: (m, k*p) stacked,
    H_all: (k*p, n), err_tol: (p,)."""
    err_tol = np.asarray(err_tol)
    p = len(err_tol)
    keep = np.argsort(err_tol)[:int(round(0.9 * p))]
    Wf = W_all.reshape(-1, p)[:, keep]
    Hf = H_all.reshape(p, -1)[keep, :]
    return (Wf.reshape(-1, len(keep) * k),
            Hf.reshape(len(keep) * k, -1),
            err_tol[keep])


def prime_factors(n: int) -> List[int]:
    """(reference primeFactors :322-333)"""
    i, out = 2, []
    while i * i <= n:
        if n % i:
            i += 1
        else:
            n //= i
            out.append(i)
    if n > 1:
        out.append(n)
    return out


def common_factors(ints: Sequence[int]) -> List[int]:
    """Multiset intersection of prime factorizations
    (reference commonFactors :335-342)."""
    counters = [Counter(prime_factors(i)) for i in ints]
    acc = counters[0]
    for c in counters[1:]:
        acc = acc & c
    return sorted(acc.elements())


def split_files_save(data: np.ndarray, pgrid: Tuple[int, int], fpath: str,
                     fname: str = "A_"):
    """Split a matrix into the blocks of a ``pgrid`` and save block ``r``
    as ``{fname}{r}.npy`` (reference split_files_save, data_io.py:108-139,
    fixed to write each chunk rather than the whole matrix): the layout
    that ``DataReader(fpath, fname, "folder", pgrid=pgrid)`` reads."""
    os.makedirs(fpath, exist_ok=True)
    for rank, sl in enumerate(partition_slices(pgrid, data.shape)):
        np.save(os.path.join(fpath, f"{fname}{rank}.npy"), data[sl])


def mat_split(name: str, p_r: int, p_c: int, fmt: str = "npy"):
    """Split `<name>.npy` into even per-rank chunks under `<name>/`
    (reference matSplit :296-320; requires exact divisibility as there)."""
    if fmt.lower() != "npy":
        raise ValueError("unknown format")
    mat = np.load(name + ".npy")
    if mat.shape[0] % p_r or mat.shape[1] % p_c:
        raise ValueError("matrix dims not evenly divisible by grid")
    os.makedirs(name, exist_ok=True)
    rs, cs = mat.shape[0] // p_r, mat.shape[1] // p_c
    idx = 0
    for ri in range(p_r):
        for ci in range(p_c):
            np.save(os.path.join(name, f"{os.path.basename(name)}_{idx}.npy"),
                    mat[ri * rs:(ri + 1) * rs, ci * cs:(ci + 1) * cs])
            idx += 1
