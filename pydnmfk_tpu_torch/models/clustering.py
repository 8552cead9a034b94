"""Custom clustering of ensemble W columns and cosine-distance silhouettes.

Port of ``pydnmfk_tpu/models/clustering.py`` (reference
dist_clustering.py:5-188). Ensemble tensors carry the perturbation as the
leading axis: W_all (p, m, k), H_all (p, k, n). Semantics kept:

  * normalize: W /= sqrt(colsumsq + eps); H *= the same     (:30-39)
  * initial centroids = first perturbation's W              (:109-110)
  * greedy max-similarity assignment                        (:58-69)
  * centroids = median over perturbations, renormalized     (:120-126)
  * the alignment loop stops at its fixed point, which equals running the
    reference's fixed 100 iterations                        (clustering.py:114-131)
  * silhouettes from arccos of the clipped gram             (:129-160)
  * the reference clusters twice (fit, then dist_silhouettes re-clusters
    from the permuted first slice, :140).

Half factors keep their dtype, with f32 sums in the norms and products
(clustering.py:40-41, :66, :98, :109-111); the silhouettes are summed in
f32 and returned at the factors' dtype.

Within one alignment iteration the centroids are fixed, so the p
perturbations align independently: their similarity matrices come from one
batched product and the greedy assignments run on the host, one transfer of
p k x k values per iteration.

A K-padded ensemble (the NMFk sweep's ``k_sweep_batch``, ``models/nmfk.py``)
clusters with an ``active`` mask of its k live columns: the padded columns
are exact zeros, a +2 bias on the active x active similarities (in f32,
before the greedy assignment) makes the assignment pick the actives in the
unpadded order, and the silhouettes are averaged over the active clusters
only (``clustering.py:71-86``, ``:208-215``); the caller slices off the
padded columns.

On a p_r x p_c grid (``grid``) W_all holds this rank's row block of every
member and H_all its column block; the ensemble is never gathered. Every
sum over W's rows (the column norms, the similarity matrices, the
silhouettes' Gram) is all-reduced over 'r' everywhere (``clustering.py:96``,
``:140``), so that every rank computes the same assignments. Under p_e
ensemble groups every group clusters all the members (gathered over 'e')
with its own ranks alone, and gets the same bits as the others.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import linalg


def _over_rows(x, grid):
    """x, a sum over W's rows, summed over the grid's 'r' everywhere."""
    return x if grid is None else grid.sum(x, "r", everywhere=True)


def normalize_by_w(W_all, H_all, eps, grid=None):
    """L2-normalize each W column (sums in f32), rescale H rows."""
    sumsq = _over_rows(W_all.to(torch.float32).square().sum(dim=1), grid)
    temp = torch.sqrt(sumsq + float(np.float32(eps))).to(W_all.dtype)
    return W_all / temp[:, None, :], H_all * temp[:, :, None]


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Greedy approximation of the max-similarity assignment (reference
    greedy_lsa + change_order, :50-69) on one k x k similarity matrix.
    Returns perm such that new_W[:, i] = W[:, perm[i]]."""
    X = np.array(dist, dtype=np.float32)
    k = X.shape[0]
    perm = np.zeros(k, dtype=np.int64)
    for _ in range(k):
        r, c = divmod(int(np.argmax(X)), k)      # first maximum, row-major
        perm[r] = c
        X[r, :] = -np.inf
        X[:, c] = -np.inf
    return perm


def median0(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0; the mean of the two middle values when the count
    is even (numpy's and JAX's median, not torch.median's lower one)."""
    s = torch.sort(x, dim=0).values
    p = x.shape[0]
    if p % 2:
        return s[p // 2]
    return (s[p // 2 - 1] + s[p // 2]) / 2


# the reference's fixed number of alignment iterations (:114)
N_ITER = 100


def _cluster_loop(W_all, H_all, eps, grid=None, n_iter=N_ITER,
                  active=None):
    """The alignment loop (reference :83-127), at most ``n_iter``
    iterations; centroids restart from the current first perturbation.
    Iteration 0's centroids are W_all[0], not a median, so iterations 0 and
    1 always run; after that an iteration that moves no column is a fixed
    point and ends the loop. ``active`` (bool (K,)) marks the live columns
    of a K-padded ensemble: the similarities of L2-normalized nonnegative
    columns lie in [0, 1], so the +2 on active x active pairs puts the
    actives first, in the unpadded order, and the padded columns pair among
    themselves (``clustering.py:71-86``)."""
    p, _, k = W_all.shape
    centroids = W_all[0]
    ident = np.arange(k)
    bias = None
    if active is not None:
        act = np.asarray(torch.as_tensor(active).cpu(), dtype=np.float32)
        bias = 2.0 * np.outer(act, act)
    it, moved = 0, True
    while it < n_iter and (moved or it <= 1):
        dist = _over_rows(linalg.matmul(centroids.mT, W_all), grid)  # (p,k,k)
        dist = dist.to(torch.float32).cpu().numpy()
        if bias is not None:
            dist = dist + bias
        perms = np.stack([greedy_assignment(d) for d in dist])
        moved = bool((perms != ident).any())
        idx = torch.as_tensor(perms, device=W_all.device)
        W_all = torch.gather(W_all, 2, idx[:, None, :].expand_as(W_all))
        H_all = torch.gather(H_all, 1, idx[:, :, None].expand_as(H_all))
        centroids = median0(W_all)
        cn = torch.sqrt(_over_rows(centroids.to(torch.float32).square()
                                   .sum(dim=0), grid)
                        + float(np.float32(eps)))
        centroids = centroids / cn.to(centroids.dtype)
        it += 1
    return W_all, H_all, centroids


def _silhouettes(W_all, grid=None):
    """Cosine-distance silhouettes (reference dist_silhouettes :129-160).
    W_all: (p, m, k) with L2-normalized columns. Returns (k, p)."""
    P, _, K = W_all.shape
    if K == 1:
        return torch.ones((K, P), dtype=W_all.dtype, device=W_all.device)
    Wf = W_all.to(torch.float32)
    G = _over_rows(torch.einsum("ami,bmj->iajb", Wf, Wf), grid)  # (K,P,K,P)
    D = torch.arccos(torch.clamp(G, -1.0, 1.0))
    ii = torch.arange(K, device=W_all.device)
    a = D[ii, :, ii, :].sum(-1) / (P - 1)                        # (K, P)
    rowsum = D.sum(-1)                                           # (K, P, K)
    rowsum = torch.where(ii[:, None, None] == ii[None, None, :],
                         torch.inf, rowsum)
    b = rowsum.min(-1).values / P                                # (K, P)
    return ((b - a) / torch.maximum(a, b)).to(W_all.dtype)


def _mad(data):
    """Median absolute deviation over the last axis (reference mad flag=1,
    :41-48)."""
    med = median0(data.movedim(-1, 0))
    return median0((data - med[..., None]).abs().movedim(-1, 0))


class CustomClustering:
    """API mirror of reference custom_clustering.fit (:162-188;
    ``clustering.py:176-222``): W_all (p, m, k) and H_all (p, k, n), with
    the perturbation as the leading axis (``x.movedim(-1, 0)`` converts
    the reference's (m, k, p) and (k, n, p) layout); ``n_iter`` bounds the
    alignment loop; ``active`` (bool (k,)) marks the live columns of a
    K-padded ensemble, whose statistics are taken over the active clusters
    only (the caller slices the factors); ``grid`` as in the module's
    docstring."""

    def __init__(self, W_all, H_all, eps: float, n_iter: int = N_ITER,
                 active=None, grid=None):
        if W_all.dim() != 3 or H_all.dim() != 3:
            raise ValueError("W_all/H_all must be rank-3 ensemble tensors")
        if (W_all.shape[0] != H_all.shape[0]
                or W_all.shape[2] != H_all.shape[1]):
            raise ValueError(
                f"layout mismatch: expected W_all (p,m,k), H_all (p,k,n); "
                f"got {tuple(W_all.shape)} and {tuple(H_all.shape)}")
        self.W_all, self.H_all = W_all, H_all
        self.eps = eps
        self.n_iter = n_iter
        self.active = active
        self.grid = grid

    def fit(self):
        """Returns (centroids (m,k), cent_std (m,k), H_all (p,k,n),
        cluster_sils (k,), avg_sil (scalar), sils (k,p)); on a grid the
        centroids and cent_std are this rank's row block, H_all its column
        block, and the silhouettes the same on every rank. Under ``active``
        a padded cluster's entry of cluster_sils is 0, and avg_sil is the
        mean over the active clusters (``clustering.py:208-215``)."""
        grid, eps = self.grid, self.eps
        W_all, H_all = normalize_by_w(self.W_all, self.H_all, eps, grid)
        W_all, H_all, centroids = _cluster_loop(W_all, H_all, eps, grid,
                                                self.n_iter, self.active)
        cent_std = _mad(W_all.movedim(0, -1))                    # (m, k)
        # the reference clusters again inside dist_silhouettes (:140)
        W_all2, H_all2, _ = _cluster_loop(W_all, H_all, eps, grid,
                                          self.n_iter, self.active)
        sils = _silhouettes(W_all2, grid)                        # (k, p)
        if self.active is None:
            return (centroids, cent_std, H_all2, sils.mean(dim=1),
                    sils.mean(), sils)
        # a padded cluster lies at the largest distance, pi/2, from every
        # other, so the active clusters' silhouettes are those of the
        # unpadded ensemble
        w = torch.as_tensor(self.active, device=sils.device).to(sils.dtype)
        P = sils.shape[1]
        return (centroids, cent_std, H_all2, (sils * w[:, None]).sum(1) / P,
                (sils * w[:, None]).sum() / (w.sum() * P), sils)


def cluster_ensemble(W_all, H_all, eps, grid=None, n_iter=N_ITER,
                     active=None):
    """``CustomClustering(W_all, H_all, eps, n_iter, active, grid).fit()``,
    as ``pydnmfk_tpu.models.clustering.cluster_ensemble``."""
    return CustomClustering(W_all, H_all, eps, n_iter, active, grid).fit()
