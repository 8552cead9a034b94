"""Synthetic planted-k matrices.

Port-owned copy of ``pydnmfk_tpu/utils/data_generator.py:16-30`` (reference
pyDNMFk/data_generator.py): W columns are Gaussian bumps N(i m / k,
0.01 m^2) over the row index, H is seeded uniform noise, X = W H.
"""
from __future__ import annotations

import numpy as np


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
