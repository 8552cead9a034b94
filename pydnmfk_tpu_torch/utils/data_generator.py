"""Synthetic planted-k matrices.

Port of ``pydnmfk_tpu/utils/data_generator.py`` (reference
pyDNMFk/data_generator.py): W columns are Gaussian bumps N(i m / k,
0.01 m^2) over the row index, H is seeded uniform noise, X = W H, written
as the per-rank .npy chunks that ``ftype='folder'`` reads. Run as

    python -m pydnmfk_tpu_torch.utils.data_generator --p_r=2 --p_c=2 \
        --m=1024 --n=256 --k=4 --fpath=data/

to write ``X_<rank>.npy``, ``W_<rank>.npy`` and ``H_<rank>.npy`` for each
rank of the grid.
"""
from __future__ import annotations

import os

import numpy as np

from ..parallel.partition import partition_slices


def gauss_matrix(m: int, k: int) -> np.ndarray:
    """W (m, k): column i is a Gaussian bump centered at i m / k
    (reference gauss_matrix_generator, data_generator.py:60-81)."""
    rows = np.arange(m)[:, None]
    centers = (np.arange(k) * m / k)[None, :]
    var = 0.01 * m * m
    return np.exp(-((rows - centers) ** 2) / (2.0 * var)).astype(np.float64)


def generate_data(m: int, n: int, k: int, seed: int = 100):
    """Global (W, H, X = W @ H)."""
    W = gauss_matrix(m, k)
    rng = np.random.RandomState(seed)
    H = rng.rand(k, n)
    return W, H, W @ H


def generate_and_save(m: int, n: int, k: int, pgrid, fpath: str,
                      seed: int = 100, fname: str = "X_"):
    """Write the chunks of X = W H on a ``pgrid`` = (p_r, p_c) grid:
    ``{fname}{rank}.npy`` holds X's block of rank i p_c + j, ``W_{rank}``
    its W rows and ``H_{rank}`` its H columns (reference fit,
    data_generator.py:140-150; the remainder-balanced blocks of
    ``parallel/partition.py``). Returns X's shape."""
    os.makedirs(fpath, exist_ok=True)
    W, H, X = generate_data(m, n, k, seed)
    for rank, (rsl, csl) in enumerate(partition_slices(pgrid, X.shape)):
        np.save(os.path.join(fpath, f"{fname}{rank}.npy"), X[rsl, csl])
        np.save(os.path.join(fpath, f"W_{rank}.npy"), W[rsl, :])
        np.save(os.path.join(fpath, f"H_{rank}.npy"), H[:, csl])
    return X.shape


def main(argv=None):
    """The generator's command line (the JAX package's flags)."""
    import argparse
    p = argparse.ArgumentParser(description="synthetic NMF data generator")
    p.add_argument("--p_r", type=int, default=1)
    p.add_argument("--p_c", type=int, default=1)
    p.add_argument("--m", type=int, default=1024)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--fpath", type=str, default="data/")
    args = p.parse_args(argv)
    generate_and_save(args.m, args.n, args.k, (args.p_r, args.p_c),
                      args.fpath)


def generate_disjoint(m: int, n: int, k: int, zeros: float = 0.0,
                      vmax=None, dtype=np.float32, seed: int = 100):
    """A planted rank-k m x n matrix whose W has disjoint supports, as
    ``examples/nmfk_large.py`` builds its W: row block j (m // k rows, the
    last block the rest) loads only on feature j, with U[0, 1) weights, so
    that k is unambiguous; H is 0.1 + U[0, 1), each entry set to zero with
    probability ``zeros`` (a fraction ``zeros`` of A's entries is then
    zero). With ``vmax`` A is scaled to that maximum and rounded, then
    cast to ``dtype`` (an integer dtype: counts, as a .mat of the
    reference's sample data holds)."""
    rng = np.random.RandomState(seed)
    W = np.zeros((m, k))
    block = m // k
    for j in range(k):
        rows = slice(j * block, (j + 1) * block if j < k - 1 else m)
        W[rows, j] = rng.rand(rows.stop - rows.start)
    H = 0.1 + rng.rand(k, n)
    H[rng.rand(k, n) < zeros] = 0.0
    X = W @ H
    if vmax is not None:
        X = np.round(X * (vmax / X.max()))
    return X.astype(dtype)


TOPIC_ANCHORS = 4          # anchor words per topic in generate_topic_sparse


def generate_topic_sparse(m: int, n: int, k: int = 4, nnz_per_row: int = 50,
                          seed: int = 100):
    """A planted rank-k, block-sparse "topic" matrix as COO arrays (rows,
    cols, vals, (m, n)), the shape of a document-term matrix. Row i belongs
    to topic t = i k // m, and column j to block j k // n. Each row holds
    ``nnz_per_row`` entries in its topic's block: the block's first
    ``TOPIC_ANCHORS`` columns (anchor words, which every row of the topic
    uses) and the rest at uniform columns of the block (repeated draws are
    summed by the reader). An entry's value is w_i h_j, with w, h ~
    U[0.5, 1.5).

    The topics are alike, so a fit with fewer than k components has no
    preferred subset of them (its clusters are unstable), and one with more
    splits a topic at random: only k has stable clusters. The anchor
    columns make each topic's block rank one where it is dense, well above
    the sampling noise of the rest, so that MU from a random start finds
    all k topics."""
    anchors = TOPIC_ANCHORS
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    slot = np.tile(np.arange(nnz_per_row), m)
    topic = rows * k // m
    lo = -(-topic * n // k)                      # first column of the block
    hi = -(-(topic + 1) * n // k)
    free = (rng.random(rows.shape[0]) * (hi - lo - anchors)).astype(np.int64)
    cols = np.where(slot < anchors, lo + slot, lo + anchors + free)
    w = rng.uniform(0.5, 1.5, m)
    h = rng.uniform(0.5, 1.5, n)
    vals = w[rows] * h[cols]
    return (rows.astype(np.int32), cols.astype(np.int32),
            vals.astype(np.float32), (m, n))


if __name__ == "__main__":
    main()
