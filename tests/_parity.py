"""Helpers for the tests that hold pydnmfk_tpu_torch against pydnmfk_tpu:
inputs are made with numpy and handed to both packages."""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl


@contextlib.contextmanager
def x64():
    """JAX float64 for the calls inside only; the previous setting comes
    back after, so other tests on the same worker keep JAX's default."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def one_thread():
    """torch on one CPU thread for the test, the caller's count back after:
    the small matrices of the resume, seed-grid and k-predictor tests gain
    nothing from more, and under pytest-xdist every worker's threads
    contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU, as
    tests/test_fused_mu.py does."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def np_(x):
    """A JAX array or torch tensor as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, dtype=np.float64)
