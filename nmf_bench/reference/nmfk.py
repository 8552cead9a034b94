"""Plain NMFk for one k (reference pyDNMFk.py:8-300, dist_clustering.py).

* members: X (2 nv U + nv + 1), U uniform from the program's documented
  seeding rule: the generator of (seed, member, stream[, row panel]) is
  seeded with numpy's SeedSequence of that key; a member's noise is one
  full-width U[0, 1) draw a panel of 256 rows (stream 0), its init factors
  U[0, 1) draws of (m, k) and (k, n) (streams 1 and 2);
* the members' MU solves (``nmf.solve``);
* clustering: columns L2-normalized, greedy max-similarity alignment to
  the median centroids until nothing moves (at most 100 rounds), run twice
  as the reference does, cosine-distance silhouettes;
* the refit: H against the median factors with W frozen, ``itr`` steps,
  the relative and per-column errors;
* the Wilcoxon walk over the per-column errors, gated on the silhouettes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nmf

NOISE_STREAM, W0_STREAM, H0_STREAM = 0, 1, 2
PANEL_ROWS = 256
ROUNDS = 100


def member_generator(seed, member, stream, device, panel=None):
    key = [seed, member, stream] + ([] if panel is None else [panel])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    g = torch.Generator(torch.device(device))
    g.manual_seed(int(state))
    return g


def members(A, seed, idx, noise_var):
    """The perturbed copies of A for the member indices ``idx``."""
    m, n = A.shape
    out = torch.empty((len(idx), m, n), dtype=A.dtype, device=A.device)
    for i, member in enumerate(idx):
        for p0 in range(0, m, PANEL_ROWS):
            g = member_generator(seed, member, NOISE_STREAM, A.device,
                                 panel=p0 // PANEL_ROWS)
            u = torch.rand((min(PANEL_ROWS, m - p0), n), generator=g,
                           device=A.device)
            out[i, p0:p0 + PANEL_ROWS] = A[p0:p0 + PANEL_ROWS] * (
                2.0 * noise_var * u + noise_var + 1.0)
    return out


def init_factors(seed, idx, m, n, k, device):
    W = [torch.rand((m, k), generator=member_generator(seed, i, W0_STREAM,
                                                       device), device=device)
         for i in idx]
    H = [torch.rand((k, n), generator=member_generator(seed, i, H0_STREAM,
                                                       device), device=device)
         for i in idx]
    return torch.stack(W), torch.stack(H)


def median0(x):
    """numpy's median over axis 0 (the mean of the middle two)."""
    s = torch.sort(x, dim=0).values
    p = x.shape[0]
    return s[p // 2] if p % 2 else (s[p // 2 - 1] + s[p // 2]) / 2


def _greedy(sim):
    """perm with new column i = old column perm[i]: repeatedly the largest
    remaining similarity, first in row-major order (greedy_lsa)."""
    X = np.array(sim, dtype=np.float32)
    k = X.shape[0]
    perm = np.zeros(k, dtype=np.int64)
    for _ in range(k):
        r, c = divmod(int(np.argmax(X)), k)
        perm[r] = c
        X[r, :] = -np.inf
        X[:, c] = -np.inf
    return perm


def _align(W, H, mm):
    """The alignment rounds from W[0] as the first centroids; returns the
    permuted W, H and the L2-normalized median centroids."""
    p, _, k = W.shape
    eps = float(np.float32(nmf.EPS))
    centroids, rounds, moved = W[0], 0, True
    while rounds < ROUNDS and (moved or rounds <= 1):
        sims = mm(centroids.mT, W).cpu().numpy()
        perms = np.stack([_greedy(s) for s in sims])
        moved = bool((perms != np.arange(k)).any())
        idx = torch.as_tensor(perms, device=W.device)
        W = torch.gather(W, 2, idx[:, None, :].expand_as(W))
        H = torch.gather(H, 1, idx[:, :, None].expand_as(H))
        centroids = median0(W)
        centroids = centroids / torch.sqrt(
            centroids.square().sum(0) + eps)
        rounds += 1
    return W, H, centroids


def silhouettes(W):
    """(k, p) cosine-distance silhouettes of L2-normalized columns."""
    P, _, K = W.shape
    if K == 1:
        return torch.ones((1, P), dtype=W.dtype, device=W.device)
    G = torch.einsum("ami,bmj->iajb", W, W)
    D = torch.arccos(torch.clamp(G, -1.0, 1.0))
    ii = torch.arange(K, device=W.device)
    a = D[ii, :, ii, :].sum(-1) / (P - 1)
    rowsum = torch.where(ii[:, None, None] == ii[None, None, :], torch.inf,
                         D.sum(-1))
    b = rowsum.min(-1).values / P
    return (b - a) / torch.maximum(a, b)


def cluster(W_all, H_all, mm):
    """(centroids, H aligned by the second clustering, silhouettes (k,))."""
    eps = float(np.float32(nmf.EPS))
    norms = torch.sqrt(W_all.square().sum(1) + eps)
    W, H = W_all / norms[:, None, :], H_all * norms[:, :, None]
    W, H, centroids = _align(W, H, mm)
    W2, H2, _ = _align(W, H, mm)
    return centroids, H2, silhouettes(W2).mean(1)


def per_k(A, k, cfg, seed, norm, mm):
    """The statistics of one k: the members' errors, the clusters'
    silhouettes, the refit's factors, error and per-column errors."""
    m, n = A.shape
    idx = range(cfg["perturbations"])
    A_ens = members(A, seed, idx, cfg["noise_var"])
    W0, H0 = init_factors(seed, idx, m, n, k, A.device)
    W, H, errs = nmf.solve(A_ens, W0, H0, norm, cfg["itr"], mm)
    del A_ens, W0, H0
    centroids, H_c, sils = cluster(W, H, mm)
    Wr, Hr = nmf.iterate(A, centroids, median0(H_c), norm, cfg["itr"], mm,
                         w_update=False)
    Wr, Hr = nmf.normalize(Wr, Hr)
    return {"recon_err": errs.cpu().numpy(), "sils": sils.cpu().numpy(),
            "L_errDist": float(nmf.relative_error(A, Wr, Hr, mm)),
            "L_err": nmf.column_error(A, Wr, Hr, mm).cpu().numpy(),
            "W": Wr.cpu().numpy(), "H": Hr.cpu().numpy()}


def choose_k(ks, col_errs, sils, sill_thr):
    """The Wilcoxon walk (pvalueAnalysis, pyDNMFk.py:260-300): k moves up
    to a k whose per-column errors differ from the best's with p < 0.05,
    where the previous k's least silhouette, to two places, exceeds
    ``sill_thr``."""
    from scipy.stats import wilcoxon
    sill_min = [round(float(np.min(s)), 2) for s in sils]
    best, nopt = col_errs[0], 1
    for i in range(1, len(ks)):
        if sill_min[i - 1] > sill_thr:
            try:
                p = wilcoxon(best, col_errs[i])[1]
            except ValueError:
                p = 1.0
            if p < 0.05:
                nopt, best = i, np.copy(col_errs[i])
    return ks[nopt - 1]
