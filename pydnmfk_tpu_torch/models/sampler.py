"""Perturbation sampling and member init draws for the NMFk ensemble.

Port of ``pydnmfk_tpu/models/sampler.py`` (reference pyDNMFk.py:8-67):

  * uniform: X_per = X * (2 nv U[0,1) + nv + 1), multiplicative noise in
    [1 + nv, 1 + 3 nv) -- the reference's implementation, not its docstring;
  * poisson: X_per[i, j] ~ Poisson(X[i, j]).

A sparse A is perturbed through its flat nnz value vector, which is what
``models/nmfk.py`` hands to :func:`sample_ensemble` (sampler.py:65-75): both
kinds of noise map 0 to 0, so this is exact against the dense formula. On a
grid every rank draws each member's whole vector, one member at a time, and
keeps its block's ``slots`` of it (``nmfk.py:426-438``): a Poisson draw's
use of its generator depends on the data, so only the whole draw makes a
rank's block of a member bitwise the 1x1 member's.

Every member draws from its own ``torch.Generator``s, seeded from (seed,
global member index, stream), so a member's noise and init factors do not
depend on how the ensemble is cut into batches. A dense member's noise is
keyed further by fixed row panels that do not depend on a process grid:
the uniform field of rows [p P, (p + 1) P), P = ``PANEL_ROWS``, is one
full-width draw from the generator of (seed, member, stream, p); a Poisson
draw, whose use of its generator depends on the data, takes one generator
per row. A rank of a p_r x p_c grid draws the panels that meet its rows
(a Poisson row gathered whole over its row of the grid) and keeps its
block, so that its block of a member is bitwise the 1x1 member's on the
CPU. torch cannot reproduce ``jax.random``: the two packages draw the same
distributions, not the same numbers.

``tile_grid=(p_r, p_c)`` reproduces the reference's MPI seeding, where every
rank of a p_r x p_c grid seeds numpy alike (pyDNMFk.py:32) and so draws the
same local block (sampler.py:54-115, nmfk.py:55-78): the uniform noise is
one block's field tiled over the grid; the Poisson draw takes every block
from the same generator state, so blocks with equal data get bitwise-equal
draws; the rand init factors are one (m/p, k) and (k, n/p) draw tiled
p = p_r p_c times. Dense A only, with dims divisible by the grid.
"""
from __future__ import annotations

import numpy as np
import torch

# per-member sub-streams (the JAX package's NOISE_STREAM, W0_STREAM, H0_STREAM)
NOISE_STREAM, W0_STREAM, H0_STREAM = 0, 1, 2
# rows of a uniform noise panel of a dense member
PANEL_ROWS = 256


def member_generator(seed: int, member: int, stream: int, device,
                     panel: int | None = None) -> torch.Generator:
    """The generator of one member's sub-stream, or of its row ``panel``."""
    key = [seed, member, stream] + ([] if panel is None else [panel])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    g = torch.Generator(torch.device(device))
    g.manual_seed(int(state))
    return g


def _grid(tile_grid):
    """(p_r, p_c) of a seed grid, or None for one stream."""
    if tile_grid is None or tuple(tile_grid) == (1, 1):
        return None
    return tuple(int(x) for x in tile_grid)


def sample_member(A: torch.Tensor, generator: torch.Generator,
                  noise_var: float, method: str = "uniform",
                  tile_grid=None) -> torch.Tensor:
    """One perturbed copy of a dense A (or of a sparse A's flat values);
    ``tile_grid`` as in the module's docstring."""
    grid = _grid(tile_grid)
    if grid is not None:
        if A.dim() != 2:
            raise ValueError("seed-grid MPI compat is dense-only")
        if A.shape[0] % grid[0] or A.shape[1] % grid[1]:
            raise ValueError(f"seed-grid compat needs dims {tuple(A.shape)} "
                             f"divisible by {grid}")
    if method == "uniform":
        shape = A.shape
        if grid is not None:
            shape = (A.shape[0] // grid[0], A.shape[1] // grid[1])
        u = torch.rand(shape, generator=generator, device=A.device)
        if grid is not None:
            u = u.tile(grid)
        return A * (2.0 * noise_var * u + noise_var + 1.0).to(A.dtype)
    if method == "poisson":
        if grid is None:
            return torch.poisson(A.to(torch.float32),
                                 generator=generator).to(A.dtype)
        (p_r, p_c), (m, n) = grid, A.shape
        br, bc = m // p_r, n // p_c
        start = generator.get_state()
        out = torch.empty_like(A)
        for i in range(p_r):
            for j in range(p_c):
                generator.set_state(start)
                block = A[i * br:(i + 1) * br, j * bc:(j + 1) * bc]
                out[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = (
                    torch.poisson(block.to(torch.float32),
                                  generator=generator))
        return out
    raise ValueError(f"unknown sampling method {method!r}")


def sample_panels(A: torch.Tensor, seed: int, member: int, noise_var: float,
                  method: str = "uniform", grid=None, spans=None):
    """One perturbed copy of a dense A, its noise keyed by row panels (the
    module's docstring); on a grid A is this rank's block, rows [r0, r1)
    and columns [c0, c1) of an m x n matrix (``spans``), and the copy its
    block of the 1x1 copy."""
    (r0, r1, m), (c0, c1, n) = spans or ((0, A.shape[0], A.shape[0]),
                                         (0, A.shape[1], A.shape[1]))
    if method not in ("uniform", "poisson"):
        raise ValueError(f"unknown sampling method {method!r}")
    height = PANEL_ROWS if method == "uniform" else 1
    out = torch.empty_like(A)
    for p in range(r0 // height, -(-r1 // height)):
        p0, p1 = p * height, min((p + 1) * height, m)
        lo, hi = max(r0, p0), min(r1, p1)
        g = member_generator(seed, member, NOISE_STREAM, A.device, panel=p)
        a = A[lo - r0:hi - r0]
        if method == "uniform":
            u = torch.rand((p1 - p0, n), generator=g, device=A.device)
            u = u[lo - p0:hi - p0, c0:c1]
            out[lo - r0:hi - r0] = a * (2.0 * noise_var * u + noise_var
                                        + 1.0).to(A.dtype)
        else:
            row = a if grid is None else grid.gather(a, "c", -1)
            drawn = torch.poisson(row.to(torch.float32), generator=g)
            out[lo - r0:hi - r0] = drawn[:, c0:c1].to(A.dtype)
    return out


def sample_ensemble(A: torch.Tensor, seed: int, noise_var: float,
                    members, method: str = "uniform",
                    dtype=None, tile_grid=None, grid=None,
                    spans=None, slots=None) -> torch.Tensor:
    """Perturbed copies of A for the given global member indices, stacked
    along a leading axis and stored at ``dtype`` (default A's): the noise is
    drawn at A's precision, then the copies are narrowed, as the JAX
    ensemble program does for mixed precision (nmfk.py:110-113). A dense A
    draws by row panels (:func:`sample_panels`); a sparse A's values, and a
    ``tile_grid``, by :func:`sample_member`. On a grid A is this rank's
    block (at ``spans``, as in :func:`sample_panels`); a ``tile_grid`` must
    then be the grid's shape and the blocks even, and every rank draws its
    block as the reference's MPI rank does. ``slots`` (a sparse A's flat
    values on a grid) keeps those entries of each member's whole draw."""
    members = list(members)
    shape = A.shape if slots is None else slots.shape
    out = torch.empty((len(members), *shape), dtype=dtype or A.dtype,
                      device=A.device)
    tiled = _grid(tile_grid) is not None
    if grid is not None and tiled:
        if tuple(tile_grid) != grid.shape:
            raise ValueError(f"seed_grid={tuple(tile_grid)} on a "
                             f"{grid.shape} grid: the seed grid must be the "
                             f"run's grid")
        shape = (spans[0][2], spans[1][2])
        if (shape[0] % grid.shape[0] or shape[1] % grid.shape[1]
                or A.shape != (shape[0] // grid.shape[0],
                               shape[1] // grid.shape[1])):
            raise ValueError(f"seed-grid compat needs dims {shape} "
                             f"divisible by {grid.shape}")
    for i, member in enumerate(members):
        if A.dim() == 2 and not tiled:
            out[i] = sample_panels(A, seed, member, noise_var, method, grid,
                                   spans)
            continue
        g = member_generator(seed, member, NOISE_STREAM, A.device)
        drawn = sample_member(A, g, noise_var, method,
                              None if grid is not None else tile_grid)
        out[i] = drawn if slots is None else drawn[slots]
    return out


def init_ensemble_rand(seed: int, members, m: int, n: int, k: int, dtype,
                       device, tile_grid=None):
    """Per-member U[0, 1) init factors, drawn in f32 (W0 (b, m, k), H0
    (b, k, n)); the JAX package's ``_draw_init_factors`` for rand init.
    Under ``tile_grid`` each is one (m/p, k) and (k, n/p) draw tiled p =
    p_r p_c times (nmfk.py:61-74)."""
    grid = _grid(tile_grid)
    p = 1 if grid is None else grid[0] * grid[1]
    if m % p or n % p:
        raise ValueError(f"seed-grid compat needs ({m},{n}) divisible by "
                         f"p_r*p_c={p}")
    Ws, Hs = [], []
    for member in members:
        gw = member_generator(seed, member, W0_STREAM, device)
        gh = member_generator(seed, member, H0_STREAM, device)
        Ws.append(torch.rand((m // p, k), generator=gw,
                             device=device).tile((p, 1)))
        Hs.append(torch.rand((k, n // p), generator=gh,
                             device=device).tile((1, p)))
    return torch.stack(Ws).to(dtype), torch.stack(Hs).to(dtype)
