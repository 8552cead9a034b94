"""Perturbation sampling and member init draws for the NMFk ensemble.

Port of ``pydnmfk_tpu/models/sampler.py`` (reference pyDNMFk.py:8-67):

  * uniform: X_per = X * (2 nv U[0,1) + nv + 1), multiplicative noise in
    [1 + nv, 1 + 3 nv) -- the reference's implementation, not its docstring;
  * poisson: X_per[i, j] ~ Poisson(X[i, j]).

A sparse A is perturbed through its flat nnz value vector, which is what
``models/nmfk.py`` hands to :func:`sample_ensemble` (sampler.py:65-75): both
kinds of noise map 0 to 0, so this is exact against the dense formula.

Every member draws from its own ``torch.Generator``, seeded from (seed,
global member index, stream), so a member's noise and init factors do not
depend on how the ensemble is cut into batches. torch cannot reproduce
``jax.random``: the two packages draw the same distributions, not the same
numbers.
"""
from __future__ import annotations

import numpy as np
import torch

# per-member sub-streams (the JAX package's NOISE_STREAM, W0_STREAM, H0_STREAM)
NOISE_STREAM, W0_STREAM, H0_STREAM = 0, 1, 2


def member_generator(seed: int, member: int, stream: int,
                     device) -> torch.Generator:
    """The generator of one member's sub-stream."""
    state = np.random.SeedSequence([seed, member, stream]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(torch.device(device))
    g.manual_seed(int(state))
    return g


def sample_member(A: torch.Tensor, generator: torch.Generator,
                  noise_var: float, method: str = "uniform") -> torch.Tensor:
    """One perturbed copy of A."""
    if method == "uniform":
        u = torch.rand(A.shape, generator=generator, device=A.device)
        return A * (2.0 * noise_var * u + noise_var + 1.0).to(A.dtype)
    if method == "poisson":
        return torch.poisson(A.to(torch.float32),
                             generator=generator).to(A.dtype)
    raise ValueError(f"unknown sampling method {method!r}")


def sample_ensemble(A: torch.Tensor, seed: int, noise_var: float,
                    members, method: str = "uniform",
                    dtype=None) -> torch.Tensor:
    """Perturbed copies of A for the given global member indices, stacked
    along a leading axis and stored at ``dtype`` (default A's): the noise is
    drawn at A's precision, then the copies are narrowed, as the JAX
    ensemble program does for mixed precision (nmfk.py:110-113)."""
    members = list(members)
    out = torch.empty((len(members), *A.shape), dtype=dtype or A.dtype,
                      device=A.device)
    for i, member in enumerate(members):
        g = member_generator(seed, member, NOISE_STREAM, A.device)
        out[i] = sample_member(A, g, noise_var, method)
    return out


def init_ensemble_rand(seed: int, members, m: int, n: int, k: int, dtype,
                       device):
    """Per-member U[0, 1) init factors, drawn in f32 (W0 (b, m, k), H0
    (b, k, n)); the JAX package's ``_draw_init_factors`` for rand init."""
    Ws, Hs = [], []
    for member in members:
        gw = member_generator(seed, member, W0_STREAM, device)
        gh = member_generator(seed, member, H0_STREAM, device)
        Ws.append(torch.rand((m, k), generator=gw, device=device))
        Hs.append(torch.rand((k, n), generator=gh, device=device))
    return torch.stack(Ws).to(dtype), torch.stack(Hs).to(dtype)
