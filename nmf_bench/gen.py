"""Inputs drawn from a run's seed, on the device, in a few large calls.

Every tensor a cell feeds the program (A, the init factors of a solve, the
seed of a sweep) comes from here, keyed by (seed, tags), so that the same
seed gives the same inputs and the reference can draw them again.
"""
from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, *tags) -> int:
    """A 63-bit seed for (seed, tags); tags are ints or short strings."""
    key = [int(seed) % (1 << 64)] + [t if isinstance(t, int) else
                         int.from_bytes(str(t).encode(), "little")
                         for t in tags]
    hi, lo = np.random.SeedSequence(key).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(torch.device(device))
    g.manual_seed(derived_seed(seed, *tags))
    return g


def planted_exact(m: int, n: int, rank: int, top: int, seed: int, device):
    """A = Wp Hp of two matrices of integers 0..top drawn from the seed, of
    rank ``rank``: every entry (at most rank * top**2) is an integer that
    float32 holds exactly, whatever the order of the sums (the grid phase's
    matrix of the port's chip smoke)."""
    g = generator(device, seed, "A")
    Wp = torch.randint(0, top + 1, (m, rank), generator=g, device=device)
    Hp = torch.randint(0, top + 1, (rank, n), generator=g, device=device)
    return (Wp.float() @ Hp.float()).contiguous()


def planted_gauss(m: int, n: int, k: int, seed: int, device):
    """A = W H of rank k: W's column i a Gaussian bump over the rows centred
    at i m / k with variance 0.01 m^2, H uniform in [0, 1) from the seed
    (the reference's data generator, pyDNMFk data_generator.py:60-81)."""
    rows = torch.arange(m, device=device, dtype=torch.float64)[:, None]
    centres = torch.arange(k, device=device, dtype=torch.float64) * m / k
    W = torch.exp(-(rows - centres) ** 2 / (2.0 * 0.01 * m * m)).float()
    H = torch.rand((k, n), generator=generator(device, seed, "H"),
                   device=device)
    return (W @ H).contiguous()


def rand_factors(m: int, n: int, k: int, seed: int, device, *tags):
    """U[0, 1) init factors (W0 (m, k), H0 (k, n)) for the solve ``tags``,
    drawn in float32 as the program's rand init draws them."""
    g = generator(device, seed, "factors", *tags)
    W0 = torch.rand((m, k), generator=g, device=device)
    H0 = torch.rand((k, n), generator=g, device=device)
    return W0, H0
