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
