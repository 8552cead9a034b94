"""The least time of the work that an NMF solve or an NMFk sweep asks of
one H100: the yardstick of ``mfu_pct`` and ``roofline_pct``.

It counts the algorithm's work, whatever implements it, so that no kernel
can read above 100 %:

* an MU iteration reads A once (a row-panel pass can form A H^T, W's new
  rows and W'^T A, or KL's ratio products, in one read) and reads and
  writes W and H once; its operations are 4 m n k (FRO) or 8 m n k (KL)
  plus, for FRO, the four k x k Gram products 4 (m + n) k^2; a W-frozen
  iteration (the NMFk refit) halves the A-sized operations;
* a solve's error pass reads A once more (2 m n k operations for W H);
* each member of a sweep is its own perturbed A: the sampler reads A and
  writes every member once, and an iteration reads every member;
* one fused pass is one operation, and costs the larger of its operations
  over the peak and its bytes over the bandwidth.

Peaks are NMF's: NVIDIA's published H100 SXM figures (the card's power
limit is reported beside every reading). Float32 operations count at
165 TFLOP/s, the 495 TFLOP/s TF32 rate over the three passes that float32
accuracy takes (3xTF32), the fastest float32-accurate rate the card has.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense; HBM3 bandwidth
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12,
            "uint8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "uint8": 1}


def pass_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds of one fused pass."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)


def iteration_s(norm: str, m: int, n: int, k: int, members: int = 1,
                dtype: str = "float32", w_update: bool = True) -> float:
    """One MU iteration of ``members`` m x n matrices at width k."""
    item = ITEM_BYTES[dtype]
    per = {"fro": 4, "kl": 8}[norm] * m * n * k
    grams = 4 * (m + n) * k * k if norm == "fro" else 0
    factors = 2 * (n * k + (m * k if w_update else 0)) * item
    if not w_update:
        per, grams = per // 2, grams // 2
    return pass_s(members * (per + grams),
                  members * (m * n * item + factors), dtype)


def error_s(m: int, n: int, k: int, members: int = 1,
            dtype: str = "float32") -> float:
    """One pass of ||A - W H|| (or of its per-column sums) over the
    members."""
    item = ITEM_BYTES[dtype]
    return pass_s(members * 2 * m * n * k,
                  members * (m * n + (m + n) * k) * item, dtype)


def sample_s(m: int, n: int, members: int, dtype: str = "float32") -> float:
    """The sampler: A read once, every member written once."""
    return pass_s(members * 3 * m * n,
                  (1 + members) * m * n * ITEM_BYTES[dtype], dtype)


def solve_s(norm: str, m: int, n: int, k: int, itr: int,
            dtype: str = "float32") -> float:
    """One NMF fit: ``itr`` iterations and the error pass."""
    return itr * iteration_s(norm, m, n, k, 1, dtype) + error_s(m, n, k, 1,
                                                                dtype)


def sweep_s(norm: str, m: int, n: int, ks, perturbations: int, itr: int,
            dtype: str = "float32") -> float:
    """One NMFk sweep: for each k the sampler, the members' solves with
    their error pass, and the W-frozen refit with its error and
    per-column error passes (clustering and the host's work count
    nothing)."""
    total = 0.0
    for k in ks:
        total += sample_s(m, n, perturbations, dtype)
        total += itr * iteration_s(norm, m, n, k, perturbations, dtype)
        total += error_s(m, n, k, perturbations, dtype)
        total += itr * iteration_s(norm, m, n, k, 1, dtype, w_update=False)
        total += 2 * error_s(m, n, k, 1, dtype)
    return total
