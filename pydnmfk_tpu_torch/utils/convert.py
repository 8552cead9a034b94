"""State carried over from the JAX package.

:func:`config_from_jax` takes ``dataclasses.asdict`` of a
``pydnmfk_tpu`` NMFConfig or NMFkConfig; :func:`factors_from_numpy` takes
its factors as numpy arrays (bf16 ones too, :func:`as_tensor`), and
:func:`blocks_for_rank` cuts them, and A, into a grid rank's blocks;
:func:`sparse_from_numpy` and
:func:`ell_from_numpy` take the arrays of a BCOO or an ``EllSparse``, so
that both packages compute on the same operands. None of them imports JAX:
the caller converts its arrays with ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import JAX_ONLY, NMFConfig, NMFkConfig, check_jax_only
from ..ops.ell import EllSparse
from ..ops.sparse import SparseTriplet, from_coo
from ..parallel.partition import block_range

def _split(d: dict, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for key, val in d.items():
        if key in names:
            kept[key] = val
            continue
        if key not in JAX_ONLY:
            raise ValueError(f"unknown {cls.__name__} field {key!r}")
        check_jax_only(**{key: val})
    return kept


def config_from_jax(d: dict):
    """The port's NMFConfig or NMFkConfig for a JAX config dict."""
    if "nmf" in d:
        kept = _split(d, NMFkConfig)
        kept["nmf"] = config_from_jax(kept["nmf"])
        return NMFkConfig(**kept)
    return NMFConfig(**_split(d, NMFConfig))


def as_tensor(x) -> torch.Tensor:
    """``torch.as_tensor(x)``, which also takes the numpy arrays of
    ``ml_dtypes.bfloat16`` that ``numpy.asarray`` gives for a JAX bf16
    array (torch rejects their dtype): through their uint16 bits, exactly.
    A read-only array (``numpy.asarray`` of a JAX array) is copied."""
    if isinstance(x, np.ndarray):
        if not x.flags.writeable:
            x = x.copy()
        if x.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(x).view(np.uint16)
            return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.as_tensor(x)


def factors_from_numpy(W, H, device, dtype=torch.float32):
    """JAX factors (W (m,k), H (k,n), or ensembles (p,m,k), (p,k,n)) as
    contiguous tensors on ``device``."""
    W, H = np.asarray(W), np.asarray(H)
    if W.ndim != H.ndim or W.ndim not in (2, 3) or W.shape[-1] != H.shape[-2]:
        raise ValueError(f"factor shapes {W.shape} and {H.shape} do not "
                         f"pair as W (..., m, k) and H (..., k, n)")
    return (as_tensor(W).to(device, dtype).contiguous(),
            as_tensor(H).to(device, dtype).contiguous())


def blocks_for_rank(grid_shape, rank: int, A=None, W=None, H=None):
    """This rank's blocks, as numpy, of a global A (..., m, n), W
    (..., m, k) and H (..., k, n) on a (p_r, p_c) grid in the
    remainder-balanced layout (``parallel/partition.py``): A's block
    (i, j), W's row block i, H's column block j, rank = i * p_c + j.
    An array given as None comes back None."""
    p_r, p_c = grid_shape
    i, j = divmod(rank, p_c)
    rows = lambda x: slice(*block_range(x.shape[-2], p_r, i))
    cols = lambda x: slice(*block_range(x.shape[-1], p_c, j))
    A, W, H = (None if x is None else np.asarray(x) for x in (A, W, H))
    return (None if A is None else A[..., rows(A), cols(A)],
            None if W is None else W[..., rows(W), :],
            None if H is None else H[..., cols(H)])


def sparse_from_numpy(rows, cols, vals, shape, device="cpu") -> SparseTriplet:
    """A BCOO's ``indices[:, 0]``, ``indices[:, 1]`` and ``data`` as a
    canonical triplet (sorted row-major, duplicates summed) on ``device``."""
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    return from_coo(t(rows), t(cols), t(vals), shape)


def ell_from_numpy(rvals, rcols, rtail_d, rtail_r, rtail_c, cvals, crows,
                   ctail_d, ctail_r, ctail_c, shape, nse,
                   device="cpu") -> EllSparse:
    """An ``EllSparse``'s arrays, in its constructor's order, as the port's
    EllSparse on ``device``."""
    arrays = (rvals, rcols, rtail_d, rtail_r, rtail_c, cvals, crows, ctail_d,
              ctail_r, ctail_c)
    return EllSparse(*(torch.from_numpy(np.array(x)).to(device)
                       for x in arrays), shape, nse)
