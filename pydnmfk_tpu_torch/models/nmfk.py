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

With ``prune`` a dense A loses its all-zero rows and columns once, before
sampling (nmfk.py:705-716); the AIC keeps the unpruned dims, pruned columns
carry zero error and the saved factors come back at the full shape. With
``init="nnsvd"`` every member starts from the NNDSVD of its own perturbed
copy, one batched ``eigh`` per batch of members (nmfk.py:81-83).

On a p_r x p_c grid (``grid``) each rank holds its block of a dense A and
draws its block of every member (``models/sampler.py``); the batch is the
least any rank's memory takes; the solves, the clustering and the W-frozen
refit run on the blocks with the grid's collectives, and the ensemble is
never gathered. Rank 0 alone writes the per-k results, the factors (in the
grid's chunk layout), ``checkpoint.json`` and the plots, runs the p-value
walk and hands its k to every rank; a barrier after each k orders its
writes before any read. Each rank saves its own ensemble parts, and a
resume replays the members that every rank has.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import torch

from ..config import SPARSE_GRID, NMFkConfig, NotPortedError, check_device
from ..ops import ell, ell_gather, linalg, sparse
from ..parallel.mesh import is_proc0, sync_processes
from ..utils import timing
from ..utils.checkpoint import (Checkpoint, FLAG_CLUSTERED, FLAG_PERTS_DONE,
                                FLAG_RUNNING, FLAG_SAVED)
from ..utils.convert import as_tensor
from ..utils.io import DataWriter, read_cluster_results, to_numpy
from ..utils.pruning import prune_A, unprune_columns, unprune_factors
from . import nmf as nmf_mod
from . import sampler
from .clustering import cluster_ensemble, median0
from .nmf import NMF
from .svd import nnsvd_factors


# working-set multiple of the factors per ensemble member: W and H, the MU
# numerators and denominators, the init draws (utils/memory.py's F_WORK)
F_WORK = 8
# the share of an explicit memory budget the batch may fill
# (utils/memory.py's HEADROOM)
HEADROOM = 0.85


def _ensemble_cfg_tag(ncfg, cfg, K=None, grid=None) -> str:
    """Everything that shapes a member's result (``nmfk.py:468-478``): a
    saved part replays only under the same tag. Unlike the JAX package's
    it holds ``bcd_obj``, ``hals_block``, ``use_fused``, ``kl_chunk``,
    ``tol_check_every``, the width ``K`` the members are solved at (k
    here; a K-padded sweep would solve at a larger one) and the grid."""
    return repr((ncfg.k, ncfg.itr, ncfg.norm.lower(), ncfg.method.lower(),
                 ncfg.init, ncfg.precision, ncfg.a_precision, ncfg.seed,
                 float(ncfg.tol), int(ncfg.tol_check_every), cfg.noise_var,
                 cfg.sampling, cfg.seed_grid, ncfg.bcd_obj, ncfg.hals_block,
                 ncfg.use_fused, ncfg.kl_chunk, K or ncfg.k,
                 grid.shape if grid is not None else (1, 1)))


def _part_suffix(grid) -> str:
    """A rank's part files are ``part_{offset}_r{rank}.pt`` on a grid."""
    return ".pt" if grid is None else f"_r{grid.rank}.pt"


def _save_ensemble_part(parts_dir, offset, W, H, errs, seed, cfg_tag,
                        grid=None):
    """One solved batch, members ``offset`` on, as ``part_{offset}.pt``
    (``nmfk.py:481-488``; on a grid this rank's blocks, the JAX package's
    per-process shards, :490-544): factors at their own dtype, written
    beside and moved into place."""
    os.makedirs(parts_dir, exist_ok=True)
    path = os.path.join(parts_dir, f"part_{offset:06d}{_part_suffix(grid)}")
    tmp = path + ".tmp"
    torch.save({"W": W.detach().cpu(), "H": H.detach().cpu(),
                "errs": errs.detach().cpu(), "offset": offset, "seed": seed,
                "cfg_tag": cfg_tag}, tmp)
    os.replace(tmp, path)


def _load_ensemble_parts(parts_dir, n_pert, seed, cfg_tag, device,
                         grid=None):
    """The saved batches that cover members 0, 1, ... without a gap
    (``nmfk.py:546-622``): (members covered, W parts, H parts, error
    parts) on ``device``. Parts of another seed or tag, and torn ones, are
    skipped. Members are keyed by their global index, so the replay takes
    parts of any batch size. On a grid this rank's own parts."""
    parts = {}
    names = sorted(os.listdir(parts_dir)) if os.path.isdir(parts_dir) else []
    for name in names:
        if not (name.startswith("part_") and len(name) == 11 + len(
                _part_suffix(grid)) and name.endswith(_part_suffix(grid))):
            continue
        try:
            d = torch.load(os.path.join(parts_dir, name), map_location=device,
                           weights_only=True)
            if d["seed"] == seed and d["cfg_tag"] == cfg_tag:
                parts[int(d["offset"])] = (d["W"], d["H"], d["errs"])
        except Exception:
            continue            # torn write: recompute
    done, W_parts, H_parts, err_parts = 0, [], [], []
    while done < n_pert and done in parts:
        W, H, errs = parts[done]
        W_parts.append(W)
        H_parts.append(H)
        err_parts.append(errs)
        done += W.shape[0]
    return done, W_parts, H_parts, err_parts


def _common_parts(grid, done, *parts):
    """The replay that every rank of a grid has: the fewest members any
    rank's parts cover, this rank's parts cut to them."""
    fewest = -int(grid.max(torch.tensor([-done], dtype=torch.float64,
                                        device=grid.device))[0])
    if fewest == done:
        return (done, *parts)
    return (fewest, *([torch.cat(p)[:fewest]] if fewest else []
                      for p in parts))


class NMFk:
    def __init__(self, cfg: NMFkConfig, device="cuda", grid=None):
        if cfg.sampling not in ("uniform", "poisson"):
            raise ValueError(f"unknown sampling method {cfg.sampling!r}")
        if grid is None and cfg.nmf.grid != (1, 1):
            from ..parallel.mesh import initialize
            grid = initialize(*cfg.nmf.grid, device)
        self.cfg = cfg
        self.grid = grid
        self.device = grid.device if grid is not None else torch.device(device)
        self.results_path = os.path.join(cfg.results_path, cfg.fname)
        self.checkpoint = Checkpoint(self.results_path,
                                     enabled=cfg.checkpoint,
                                     writer=is_proc0(grid))
        self.per_k_stats = {}
        self._ell = None      # the dual ELL of a sparse A and its perms
        self.prune_state = None
        self._orig_shape = None   # A's shape before pruning
        # ((r0, r1, m), (c0, c1, n)): where A (pruned), or this rank's block
        # of it on a grid, lies
        self._spans = None

    def fit(self, A) -> int:
        """Run the sweep; returns the estimated k (reference PyNMFk.fit,
        pyDNMFk.py:168-215). On a grid A is this rank's block of a dense
        matrix, and every rank returns rank 0's k."""
        cfg, grid = self.cfg, self.grid
        if not cfg.nmf.a_dtype.is_floating_point:
            raise ValueError(
                "quantized (uint8) A storage is an NMF-level option: the NMFk "
                "ensemble perturbs A multiplicatively and would re-round every "
                "member; use a_precision='bfloat16' for the ensemble "
                "(nmfk.py:647-652)")
        check_device(self.device)
        if grid is not None and linalg.is_sparse(A):
            raise NotPortedError(SPARSE_GRID, "queue 1 item 15")
        os.makedirs(self.results_path, exist_ok=True)
        A = self._prepare(A)
        start_k = self._rank0(self.checkpoint.resume_k(cfg.start_k,
                                                       cfg.step_k))
        for k in range(start_k, cfg.end_k + 1, cfg.step_k):
            self.pynmfk_per_k(A, k)
        nopt = self._rank0(self.pvalue_analysis() if is_proc0(grid) else 0)
        if is_proc0(grid):
            try:
                from ..utils.plotting import plot_results_fpath
                plot_results_fpath(self.results_path, list(cfg.k_range))
            except Exception as e:       # best-effort, but never silent
                import warnings          # (nmfk.py:788-795)
                warnings.warn(f"k-selection plot failed: {e!r}")
        return nopt

    def _rank0(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of a grid."""
        if self.grid is None:
            return value
        return int(self.grid.broadcast(torch.tensor(
            [value], dtype=torch.float64, device=self.device))[0])

    def _prepare(self, A):
        """A on the device at the factor dtype (nmfk.py:653-716). A sparse A
        must be a SparseTriplet: the CPU keeps it; on the card the format
        policy picks the dual ELL, kept with its slot -> nnz perms in
        ``self._ell`` while A stays the triplet whose values the members
        perturb, or a dense A (kept at bf16 where the policy narrowed it).
        A sparse A that stays sparse refuses prune, nnsvd, BCD and
        ``seed_grid`` with the JAX package's ValueErrors (nmfk.py:677-691).
        A dense A is pruned here, once, under ``prune``."""
        self._ell = None
        A = self._format(A)
        ncfg = self.cfg.nmf
        if linalg.is_sparse(A):
            if ncfg.prune:
                raise ValueError("prune is not supported with sparse A "
                                 "(pruning IS implicit in sparsity)")
            if ncfg.init != "rand":
                raise ValueError("sparse NMFk requires init='rand' (nnsvd "
                                 "needs dense A)")
            if ncfg.method.lower() == "bcd":
                raise ValueError(
                    "sparse A supports MU (fro/kl) and HALS; the BCD "
                    "objective needs the dense residual every inner step")
            if self.cfg.seed_grid not in (None, (1, 1)):
                raise ValueError("seed-grid MPI compat is dense-only")
        grid = self.grid
        spans = lambda X: ((0, X.shape[0], X.shape[0]),
                           (0, X.shape[1], X.shape[1])) if grid is None \
            else (grid.span(X.shape[0], "r"), grid.span(X.shape[1], "c"))
        self._orig_shape = tuple(s[2] for s in spans(A))
        self.prune_state = None
        if ncfg.prune:
            A, self.prune_state = prune_A(A, grid)
        self._spans = spans(A)
        return A

    def _format(self, A):
        if not linalg.is_sparse(A):
            return as_tensor(A).to(self.device,
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
        """Members per batched solve: ``ensemble_batch``, or as many as fit
        the memory budget (``utils/memory.py``): ``hbm_budget``, else the
        ``PYDNMFK_HBM_BUDGET`` environment variable, less the shared A (at
        the work precision) and a 15 % headroom; else, on CUDA, half of the
        free device memory. Without a budget the CPU takes all of them.
        A member's bytes are :meth:`_member_bytes`."""
        cfg = self.cfg
        if cfg.ensemble_batch:
            return max(1, min(int(cfg.ensemble_batch), cfg.perturbations))
        per_member, shared = self._member_bytes(A, k)
        budget = cfg.hbm_budget or int(float(
            os.environ.get("PYDNMFK_HBM_BUDGET") or 0))
        if budget:
            batch = (budget * HEADROOM - shared) // per_member
        elif A.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(A.device)
            batch = (free // 2) // per_member
        else:
            batch = cfg.perturbations
        batch = max(1, min(int(batch), cfg.perturbations))
        if self.grid is not None:       # the least that any rank holds
            batch = -int(self.grid.max(torch.tensor(
                [-batch], dtype=torch.float64, device=A.device))[0])
        return batch

    def _member_bytes(self, A, k) -> tuple:
        """(bytes of one member, bytes the batch shares) of the memory model.
        A dense member costs its copy of A at ``a_dtype``; under KL the
        plain products' f32 ratio slab (``kl_chunk`` rows, else the
        automatic ones, else all m); under nnsvd its Gram, eigenvectors and
        ``eigh``'s workspace (three min(m, n)^2 f32 arrays) and the f32
        copy of a narrower member that the SVD takes; and its factors'
        working set at their byte width. A sparse member
        (utils/memory.py:67-87) costs its f32 noise draw and data copy, the
        ELL value arrays of both orientations (on the card), under KL the
        f32 workspace of K4's ratio where its plan takes more than one slab
        (past k = 256: one (dim, w) array, the wider orientation's of those
        that do, ``ops/ell_gather.py::slab_for``), and its factors'
        working set.
        A dense batch shares A at the work precision, a sparse one its
        values and indices."""
        ncfg = self.cfg.nmf
        a_item = torch.empty((), dtype=ncfg.a_dtype).element_size()
        w_item = torch.empty((), dtype=ncfg.dtype).element_size()
        m, n = A.shape
        factors = (m + n) * k * w_item * F_WORK
        if linalg.is_sparse(A):
            slots = ws = 0
            if self._ell is not None:
                E = self._ell[0]
                slots = sum(x.numel() for x in (E.rvals, E.rtail_d, E.cvals,
                                                E.ctail_d))
                if ncfg.norm.lower() == "kl":
                    ws = max((vals.numel() * 4 for vals, dim_t in
                              ((E.rvals, n), (E.cvals, m))
                              if ell_gather.slab_for(dim_t, k, A.device,
                                                     ratio=True)[1] > 1),
                             default=0)
            per_member = (A.nse * (a_item + 4) + slots * a_item + ws
                          + factors)
            shared = A.nse * (w_item + 8)
        else:
            per_member = m * n * a_item + factors
            if ncfg.norm.lower() == "kl":
                rows = ncfg.kl_chunk or linalg.error_chunk_rows(m, n) or m
                per_member += min(rows, m) * n * 4
            if ncfg.init == "nnsvd":
                per_member += 3 * min(m, n) ** 2 * 4
                if a_item < 4:
                    per_member += m * n * 4
            shared = m * n * w_item
        return per_member, shared

    def _solve_ensemble(self, A, k, members=None):
        """Sample and factorize all perturbations; returns (W_all (p,m,k),
        H_all (p,k,n), errs (p,)).

        ``members=(A_ens, W0, H0)`` supplies the perturbed copies and init
        factors instead of drawing them (parity tests feed the JAX draws);
        under nnsvd, ``members=(A_ens, None, None)`` takes the init from
        the supplied copies. On a grid each of these is this rank's block,
        and so are the returned factors."""
        cfg, grid = self.cfg, self.grid
        ncfg = cfg.nmf.replace(k=k)
        sparse_A = linalg.is_sparse(A)
        spans = self._spans or ((0, A.shape[0], A.shape[0]),
                                (0, A.shape[1], A.shape[1]))
        shape = (spans[0][2], spans[1][2])
        if members is not None:
            A_ens = as_tensor(members[0]).to(self.device, ncfg.a_dtype)
            A_ens = A_ens.contiguous()
            if members[1] is None:
                W0, H0 = self._init_members(ncfg, A_ens, None, shape, None,
                                            grid=grid, spans=self._spans)
            else:
                W0, H0 = (as_tensor(x).to(self.device, ncfg.dtype)
                          .contiguous() for x in members[1:])
            if sparse_A:
                A_ens = self._members(A, A_ens)
            return nmf_mod.solve(A_ens, W0, H0, ncfg.eps, ncfg, grid=grid)
        batch = self._ensemble_batch_size(A, k)
        self.last_batch_size = batch
        n_pert = cfg.perturbations
        tag = _ensemble_cfg_tag(ncfg, cfg, grid=grid)
        parts_dir = os.path.join(self.results_path, str(k), "ensemble_parts")
        done, W_parts, H_parts, err_parts = 0, [], [], []
        if cfg.checkpoint:
            st = self.checkpoint.state or self.checkpoint.load()
            # replay the saved batches at any stage before the k's results
            # were saved: a crash in the clustering or the refit resumes
            # from the parts alone (nmfk.py:898-909)
            if (st is not None and st.k == k and st.seed == ncfg.seed
                    and st.flag < FLAG_SAVED):
                done, W_parts, H_parts, err_parts = _load_ensemble_parts(
                    parts_dir, n_pert, ncfg.seed, tag, self.device, grid)
            if grid is not None:
                done, W_parts, H_parts, err_parts = _common_parts(
                    grid, done, W_parts, H_parts, err_parts)
        # the k is in progress from here on, so that a part saved before the
        # first batch's flag replays too
        self.checkpoint.save(FLAG_RUNNING, done, k, ncfg.seed)
        for done in range(done, n_pert, batch):
            idx = range(done, min(done + batch, n_pert))
            A_ens = sampler.sample_ensemble(A.data if sparse_A else A,
                                            ncfg.seed, cfg.noise_var, idx,
                                            cfg.sampling, ncfg.a_dtype,
                                            tile_grid=cfg.seed_grid,
                                            grid=grid, spans=self._spans)
            with timing.timed("ensemble_init"):
                W0, H0 = self._init_members(ncfg, A_ens, idx, shape,
                                            A.device, cfg.seed_grid, grid,
                                            self._spans)
            if sparse_A:
                A_ens = self._members(A, A_ens)
            W, H, errs = nmf_mod.solve(A_ens, W0, H0, ncfg.eps, ncfg,
                                       grid=grid)
            del A_ens
            W_parts.append(W)
            H_parts.append(H)
            err_parts.append(errs)
            if cfg.checkpoint:
                _save_ensemble_part(parts_dir, idx.start, W, H, errs,
                                    ncfg.seed, tag, grid)
            self.checkpoint.save(FLAG_RUNNING, idx.stop, k, ncfg.seed)
        # replayed parts overshoot where `perturbations` shrank between
        # runs (nmfk.py:1004-1007)
        return (torch.cat(W_parts)[:n_pert], torch.cat(H_parts)[:n_pert],
                torch.cat(err_parts)[:n_pert])

    @staticmethod
    def _init_members(ncfg, A_ens, idx, shape, device, seed_grid=None,
                      grid=None, spans=None):
        """Init factors of the members ``idx`` of shape (m, n)
        (``nmfk.py::_draw_init_factors``): per-member U[0, 1) draws (under
        ``seed_grid`` p-fold tiled, ``sampler.init_ensemble_rand``), or
        the NNDSVD of each member's own dense perturbed copy in A_ens, all
        in one batched solve (``models/svd.py::nnsvd_factors``). On a grid
        A_ens holds this rank's blocks (at ``spans``); the draws are whole
        and each rank keeps its blocks."""
        if ncfg.init == "nnsvd":
            W0, H0 = nnsvd_factors(A_ens, ncfg.k, ncfg.eps, grid=grid)
            return (W0.to(ncfg.dtype).contiguous(),
                    H0.to(ncfg.dtype).contiguous())
        W0, H0 = sampler.init_ensemble_rand(ncfg.seed, idx, *shape, ncfg.k,
                                            ncfg.dtype, device,
                                            tile_grid=seed_grid)
        if spans is None:
            return W0, H0
        (r0, r1, _), (c0, c1, _) = spans
        return W0[:, r0:r1].contiguous(), H0[:, :, c0:c1].contiguous()

    def pynmfk_per_k(self, A, k, ensemble=None):
        """One k: ensemble -> clustering -> regression -> stats (reference
        pynmfk_per_k, pyDNMFk.py:217-258). ``ensemble`` supplies a solved
        (W_all, H_all, errs)."""
        cfg, grid = self.cfg, self.grid
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
             _sils) = cluster_ensemble(W_all, H_all, cfg.nmf.eps, grid)
        self.checkpoint.save(FLAG_CLUSTERED, cfg.perturbations, k, seed)

        # regression re-fit of H with W frozen (pyDNMFk.py:245-248); A is
        # pruned already, so the refit does not prune again. Under BCD the
        # refit moves W too, as JAX's does (ROADMAP queue 3)
        with timing.timed("regression"):
            AvgH = median0(H_all_c)
            reg = NMF(cfg.nmf.replace(k=k, W_update=False, prune=False),
                      self.device, grid)
            # a sparse A refits on the ELL format the sweep packed, if any
            A_reg = A if self._ell is None else self._ell[0]
            AvgW, AvgH, L_errDist = reg.fit(A_reg, factors=(centroids, AvgH))
            col_err = reg.column_err()
        if self.prune_state is not None:
            # pruned (all-zero) columns carry zero error; the factors go
            # back to the full shape (nmfk.py:1277-1287)
            col_err = unprune_columns(col_err, self.prune_state)
            AvgW, AvgH = unprune_factors(AvgW, AvgH, self.prune_state)
        # the reference's AIC takes the unpruned dims (pyDNMF.py:88)
        m0, n0 = self._orig_shape or A.shape
        avg_err = float(np.mean(recon_errs))
        aic = 2 * k + m0 * n0 * float(np.log(avg_err / (m0 * n0)))
        stats = {
            "clusterSilhouetteCoefficients": to_numpy(cluster_sils),
            "avgSilhouetteCoefficients": float(avg_sil),
            "L_errDist": L_errDist,
            "L_err": col_err,
            "avgErr": avg_err,
            "recon_err": recon_errs,
            "AIC": aic,
        }
        if is_proc0(grid):      # the reference's rank-0 writer
            writer = DataWriter(k_path, grid.shape if grid else (1, 1))
            writer.save_factors(AvgW, AvgH, reg=True)
            run_cfg = {**dataclasses.asdict(cfg.nmf), "k": k,
                       "perturbations": cfg.perturbations,
                       "noise_var": cfg.noise_var, "sampling": cfg.sampling}
            writer.save_cluster_results(stats, config=run_cfg)
        self.per_k_stats[k] = stats
        self.checkpoint.save(FLAG_SAVED, cfg.perturbations, k, seed)
        # rank 0's writes come before any rank reads them (nmfk.py:1320)
        sync_processes(grid)
        # this k's results are on disk: its resume parts have served
        # (nmfk.py:1316)
        if is_proc0(grid):
            shutil.rmtree(os.path.join(k_path, "ensemble_parts"),
                          ignore_errors=True)
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
