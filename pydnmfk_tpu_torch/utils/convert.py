"""State carried over from the JAX package.

:func:`config_from_jax` takes ``dataclasses.asdict`` of a
``pydnmfk_tpu`` NMFConfig or NMFkConfig; :func:`factors_from_numpy` takes
its factors as numpy arrays; :func:`sparse_from_numpy` and
:func:`ell_from_numpy` take the arrays of a BCOO or an ``EllSparse``, so
that both packages compute on the same operands. None of them imports JAX:
the caller converts its arrays with ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import NMFConfig, NMFkConfig, NotPortedError
from ..ops.ell import EllSparse
from ..ops.sparse import SparseTriplet, from_coo

# JAX fields the port has no counterpart for: the values the port runs the
# same as (the JAX defaults, or settings that give the same results) and the
# ROADMAP item that ports the rest. Any other value is rejected.
_JAX_ONLY = {
    "grid": (((1, 1),), "queue 1 item 15"),
    "prune": ((False,), "queue 1 item 8"),
    "kl_chunk": ((0,), "queue 1 item 11"),
    "use_pallas": ((None, False), "queue 2"),
    "matmul_precision": ((None, "highest", "float32"), "queue 1 item 1"),
    "hals_block": ((None,), "queue 1 item 12"),
    "sparse_grid_format": ((None,), "queue 1 item 14"),
    "bcd_obj": ((None,), "queue 1 item 12"),
    "solve_checkpoint_every": ((0,), "queue 1 item 13"),
    "hbm_budget": ((0,), "queue 1 item 11"),
    # the K-padded sweep gives the per-k path's results (tests/test_k_sweep.py)
    "k_sweep_batch": ((None, False), "queue 1 item 10"),
    "k_sweep_merge": ((None, False), "queue 1 item 10"),
    "seed_grid": ((None, (1, 1)), "queue 1 item 6"),
}


def _split(d: dict, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for key, val in d.items():
        if key in names:
            kept[key] = val
            continue
        if key not in _JAX_ONLY:
            raise ValueError(f"unknown {cls.__name__} field {key!r}")
        accepted, item = _JAX_ONLY[key]
        if (tuple(val) if isinstance(val, list) else val) not in accepted:
            raise NotPortedError(f"{key}={val!r}", item)
    return kept


def config_from_jax(d: dict):
    """The port's NMFConfig or NMFkConfig for a JAX config dict."""
    if "nmf" in d:
        kept = _split(d, NMFkConfig)
        kept["nmf"] = config_from_jax(kept["nmf"])
        return NMFkConfig(**kept)
    return NMFConfig(**_split(d, NMFConfig))


def factors_from_numpy(W, H, device, dtype=torch.float32):
    """JAX factors (W (m,k), H (k,n), or ensembles (p,m,k), (p,k,n)) as
    contiguous tensors on ``device``."""
    W, H = np.asarray(W), np.asarray(H)
    if W.ndim != H.ndim or W.ndim not in (2, 3) or W.shape[-1] != H.shape[-2]:
        raise ValueError(f"factor shapes {W.shape} and {H.shape} do not "
                         f"pair as W (..., m, k) and H (..., k, n)")
    return (torch.as_tensor(W).to(device, dtype).contiguous(),
            torch.as_tensor(H).to(device, dtype).contiguous())


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
