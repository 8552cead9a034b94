"""State carried over from the JAX package.

:func:`config_from_jax` takes ``dataclasses.asdict`` of a
``pydnmfk_tpu`` NMFConfig or NMFkConfig; :func:`factors_from_numpy` takes
its factors as numpy arrays. Neither imports JAX: the caller converts its
arrays with ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import NMFConfig, NMFkConfig, NotPortedError

# JAX fields the port has no counterpart for: the values the port runs the
# same as (the JAX defaults, or settings that give the same results) and the
# ROADMAP item that ports the rest. Any other value is rejected.
_JAX_ONLY = {
    "grid": (((1, 1),), "queue 1 item 15"),
    "prune": ((False,), "queue 1 item 8"),
    "kl_chunk": ((0,), "queue 1 item 11"),
    "use_pallas": ((None, False), "queue 2"),
    "use_fused": ((None,), "queue 2"),
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
