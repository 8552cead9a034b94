"""NMFk: automatic latent-dimension selection via perturbation ensembles.

Port of the per-k path of ``pydnmfk_tpu/models/nmfk.py`` (reference
``PyNMFk``, pyDNMFk.py:70-300). For each k in [start_k, end_k]: factorize
``perturbations`` noise-perturbed copies of A as one batched solve, cluster
the W columns across the ensemble, refit H against the median factors with W
frozen, and record per-column error distributions, silhouettes and AIC;
then walk k upward with a Wilcoxon signed-rank test gated on the minimum
silhouette to choose k (pvalueAnalysis, pyDNMFk.py:260-300).

A sparse A (``ops/sparse.py::SparseTriplet``) runs its members as nnz-sized
data vectors over shared indices (nmfk.py:232-328): each member perturbs the
flat values, and on the card, where the format policy picks the dual ELL,
the values are gathered into both ELL orientations through the slot -> nnz
perms, so that kernel K4 runs the whole member stack in one launch.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import NMFkConfig, check_device
from ..ops import ell, linalg, sparse
from ..utils import timing
from ..utils.checkpoint import (Checkpoint, FLAG_CLUSTERED, FLAG_PERTS_DONE,
                                FLAG_RUNNING, FLAG_SAVED)
from ..utils.io import DataWriter, read_cluster_results
from . import nmf as nmf_mod
from . import sampler
from .clustering import cluster_ensemble, median0
from .nmf import NMF


# working-set multiple of the factors per ensemble member: W and H, the MU
# numerators and denominators, the init draws (utils/memory.py's F_WORK)
F_WORK = 8


class NMFk:
    def __init__(self, cfg: NMFkConfig, device="cuda"):
        if cfg.sampling not in ("uniform", "poisson"):
            raise ValueError(f"unknown sampling method {cfg.sampling!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.results_path = os.path.join(cfg.results_path, cfg.fname)
        self.checkpoint = Checkpoint(self.results_path,
                                     enabled=cfg.checkpoint)
        self.per_k_stats = {}
        self._ell = None      # the dual ELL of a sparse A and its perms

    def fit(self, A) -> int:
        """Run the sweep; returns the estimated k (reference PyNMFk.fit,
        pyDNMFk.py:168-215)."""
        cfg = self.cfg
        if not cfg.nmf.a_dtype.is_floating_point:
            raise ValueError(
                "quantized (uint8) A storage is an NMF-level option: the NMFk "
                "ensemble perturbs A multiplicatively and would re-round every "
                "member; use a_precision='bfloat16' for the ensemble "
                "(nmfk.py:647-652)")
        check_device(self.device)
        os.makedirs(self.results_path, exist_ok=True)
        A = self._prepare(A)
        start_k = self.checkpoint.resume_k(cfg.start_k, cfg.step_k)
        for k in range(start_k, cfg.end_k + 1, cfg.step_k):
            self.pynmfk_per_k(A, k)
        return self.pvalue_analysis()

    def _prepare(self, A):
        """A on the device at the factor dtype (nmfk.py:653-703). A sparse A
        must be a SparseTriplet: the CPU keeps it; on the card the format
        policy picks the dual ELL, kept with its slot -> nnz perms in
        ``self._ell`` while A stays the triplet whose values the members
        perturb, or a dense A (kept at bf16 where the policy narrowed it)."""
        self._ell = None
        if not linalg.is_sparse(A):
            return torch.as_tensor(A).to(self.device,
                                         self.cfg.nmf.dtype).contiguous()
        if not isinstance(A, sparse.SparseTriplet):
            raise TypeError("NMFk takes a sparse A as a SparseTriplet (its "
                            f"members perturb the flat values), got "
                            f"{type(A).__name__}")
        A = A.to(self.device).astype(self.cfg.nmf.dtype)
        with timing.timed("sparse_format"):
            fmt = sparse.densify_for_backend(A, k_hint=self.cfg.end_k,
                                             return_perms=True)
        if isinstance(fmt, tuple):
            self._ell = fmt
            return A
        if linalg.is_sparse(fmt) or fmt.dtype == torch.bfloat16:
            return fmt
        return fmt.to(self.cfg.nmf.dtype)

    def _members(self, A, data):
        """The member stack of a sparse A for perturbed values ``data``
        ((b, nnz)): the dual ELL through its perms, or the triplet."""
        if self._ell is not None:
            return ell.ell_with_data(*self._ell, data)
        return A.with_data(data)

    def _ensemble_batch_size(self, A, k) -> int:
        """Members per batched solve: ``ensemble_batch``, or on CUDA as many
        as fit in half of the free device memory; on the CPU all of them.
        A dense member costs its copy of A at the storage dtype and an f32
        slab of the same size for working products (the plain path widens a
        bf16 A). A sparse member (utils/memory.py:67-87) costs its f32 noise
        draw and data copy, the ELL value arrays of both orientations, and
        its factors' working set."""
        cfg = self.cfg
        a_item = torch.empty((), dtype=cfg.nmf.a_dtype).element_size()
        if cfg.ensemble_batch:
            batch = cfg.ensemble_batch
        elif A.device.type == "cuda":
            m, n = A.shape
            if self._ell is not None:
                E = self._ell[0]
                slots = sum(x.numel() for x in (E.rvals, E.rtail_d, E.cvals,
                                                E.ctail_d))
                per_member = (A.nse * (a_item + 4) + slots * a_item
                              + (m + n) * k * 4 * F_WORK)
            else:
                per_member = m * n * (a_item + 4)
            free, _ = torch.cuda.mem_get_info(A.device)
            batch = (free // 2) // per_member
        else:
            batch = cfg.perturbations
        return max(1, min(int(batch), cfg.perturbations))

    def _solve_ensemble(self, A, k, members=None):
        """Sample and factorize all perturbations; returns (W_all (p,m,k),
        H_all (p,k,n), errs (p,)).

        ``members=(A_ens, W0, H0)`` supplies the perturbed copies and init
        factors instead of drawing them (parity tests feed the JAX draws)."""
        cfg = self.cfg
        ncfg = cfg.nmf.replace(k=k)
        sparse_A = linalg.is_sparse(A)
        if members is not None:
            A_ens, W0, H0 = (torch.as_tensor(x).to(self.device, dt).contiguous()
                             for x, dt in zip(members, (ncfg.a_dtype,
                                                        ncfg.dtype, ncfg.dtype)))
            if sparse_A:
                A_ens = self._members(A, A_ens)
            return nmf_mod.solve(A_ens, W0, H0, ncfg.eps, ncfg)
        m, n = A.shape
        batch = self._ensemble_batch_size(A, k)
        self.last_batch_size = batch
        W_parts, H_parts, err_parts = [], [], []
        for done in range(0, cfg.perturbations, batch):
            idx = range(done, min(done + batch, cfg.perturbations))
            A_ens = sampler.sample_ensemble(A.data if sparse_A else A,
                                            ncfg.seed, cfg.noise_var, idx,
                                            cfg.sampling, ncfg.a_dtype)
            if sparse_A:
                A_ens = self._members(A, A_ens)
            W0, H0 = sampler.init_ensemble_rand(ncfg.seed, idx, m, n, k,
                                                ncfg.dtype, A.device)
            W, H, errs = nmf_mod.solve(A_ens, W0, H0, ncfg.eps, ncfg)
            del A_ens
            W_parts.append(W)
            H_parts.append(H)
            err_parts.append(errs)
            self.checkpoint.save(FLAG_RUNNING, idx.stop, k, ncfg.seed)
        return torch.cat(W_parts), torch.cat(H_parts), torch.cat(err_parts)

    def pynmfk_per_k(self, A, k, ensemble=None):
        """One k: ensemble -> clustering -> regression -> stats (reference
        pynmfk_per_k, pyDNMFk.py:217-258). ``ensemble`` supplies a solved
        (W_all, H_all, errs)."""
        cfg = self.cfg
        k_path = os.path.join(self.results_path, str(k))
        os.makedirs(k_path, exist_ok=True)
        if cfg.nmf.verbose:
            print(f"*************Computing for k={k}************")
        seed = cfg.nmf.seed
        if ensemble is None:
            with timing.timed("ensemble_solve"):
                ensemble = self._solve_ensemble(A, k)
        W_all, H_all, recon_errs = ensemble
        recon_errs = recon_errs.cpu().numpy()
        self.checkpoint.save(FLAG_PERTS_DONE, cfg.perturbations, k, seed)

        with timing.timed("clustering"):
            (centroids, _cent_std, H_all_c, cluster_sils, avg_sil,
             _sils) = cluster_ensemble(W_all, H_all, cfg.nmf.eps)
        self.checkpoint.save(FLAG_CLUSTERED, cfg.perturbations, k, seed)

        # regression re-fit of H with W frozen (pyDNMFk.py:245-248)
        with timing.timed("regression"):
            AvgH = median0(H_all_c)
            reg = NMF(cfg.nmf.replace(k=k, W_update=False), self.device)
            # a sparse A refits on the ELL format the sweep packed, if any
            A_reg = A if self._ell is None else self._ell[0]
            AvgW, AvgH, L_errDist = reg.fit(A_reg, factors=(centroids, AvgH))
            col_err = reg.column_err()
        m0, n0 = A.shape
        avg_err = float(np.mean(recon_errs))
        aic = 2 * k + m0 * n0 * float(np.log(avg_err / (m0 * n0)))
        stats = {
            "clusterSilhouetteCoefficients": cluster_sils.cpu().numpy(),
            "avgSilhouetteCoefficients": float(avg_sil),
            "L_errDist": L_errDist,
            "L_err": col_err,
            "avgErr": avg_err,
            "recon_err": recon_errs,
            "AIC": aic,
        }
        writer = DataWriter(k_path)
        writer.save_factors(AvgW, AvgH, reg=True)
        run_cfg = {**dataclasses.asdict(cfg.nmf), "k": k,
                   "perturbations": cfg.perturbations,
                   "noise_var": cfg.noise_var, "sampling": cfg.sampling}
        writer.save_cluster_results(stats, config=run_cfg)
        self.per_k_stats[k] = stats
        self.checkpoint.save(FLAG_SAVED, cfg.perturbations, k, seed)
        return stats

    def pvalue_analysis(self) -> int:
        """Wilcoxon walk over the recorded per-k column-error distributions
        (reference pvalueAnalysis, pyDNMFk.py:260-300), re-reading the
        per-k results so it works after a restart."""
        from scipy.stats import wilcoxon

        ks = list(self.cfg.k_range)
        sill_min, err_dists = [], []
        for k in ks:
            res = read_cluster_results(os.path.join(self.results_path, str(k)))
            err_dists.append(res["L_err"])
            sill_min.append(round(float(
                np.min(res["clusterSilhouetteCoefficients"])), 2))

        pvalue = np.ones(len(ks))
        best_err = err_dists[0]
        nopt = 1
        for i in range(1, len(ks)):
            if sill_min[i - 1] > self.cfg.sill_thr:
                try:
                    pvalue[i] = wilcoxon(best_err, err_dists[i])[1]
                except ValueError:
                    # identical distributions (all-zero differences): no
                    # evidence of change (nmfk.py:1347-1352)
                    pvalue[i] = 1.0
                if pvalue[i] < 0.05:
                    nopt = i
                    best_err = np.copy(err_dists[i])
        self.pvalues = pvalue
        return ks[nopt - 1]
