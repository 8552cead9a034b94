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

On a p_r x p_c grid (``grid``) each rank holds its block of A and draws
its block of every member (``models/sampler.py``): of a dense A by row
panels, of a sparse A by drawing each member's whole flat values, as the
1x1 sweep does, and keeping its block's slots (``nmfk.py:331-465``), so
that a rank's block of a member is bitwise the 1x1 member's; a sparse
block runs in the format that the ranks agree on (the dual ELL, K4 on the
card, or the triplet; ``ops/sparse.py::grid_format``). The batch is the
least any rank's memory takes; the solves, the clustering and the W-frozen
refit run on the blocks with the grid's collectives, and the ensemble is
never gathered. Rank 0 alone writes the per-k results, the factors (in the
grid's chunk layout), ``checkpoint.json`` and the plots, runs the p-value
walk and hands its k to every rank; a barrier after each k orders its
writes before any read. Each rank saves its own ensemble parts, and a
resume replays the members that every rank has.

With p_e ensemble groups of the grid (``parallel/mesh.py``, the JAX
package's mesh axis 'e', nmfk.py:339-346, :410-424) each group solves its
share of every batch on its own p_r x p_c ranks, with no collective
beyond the group, drawing each member by its global index, so that a
member's blocks are bitwise those of the p_e = 1 run (on the CPU). The
batch is a multiple of p_e (nmfk.py:799-828); a batch's members split as
evenly as they can, none padded, and every group runs every batch, a
group without a member in one too. After the last batch the members' W
blocks, H blocks and errors are gathered over 'e' in global member order,
and every group clusters and refits them; every group then takes group
0's refit over 'e', so that all hold the same statistics (a guard from
when a sparse refit's scatter-adds summed with atomics on the card; they
now sum in a fixed order, so the groups' refits agree and the broadcast
can go); rank 0 (of group 0) writes.

With ``k_sweep_batch=True`` the sweep runs K-padded (``nmfk.py:767-786``):
every k's members are drawn at k as in the per-k sweep, zero-padded to
K = max(k_range) columns and solved under a column mask that holds the
others at exact zeros (``models/nmf.py::_solve``), on every format and
grid; the memory model, K4's slab plan and the dispatch of K1-K4 take K.
The factors are sliced back to k before a part is saved, the clustering
runs padded with an ``active`` mask where 1 < k < K, and the refit padded
under the k's mask. With ``k_sweep_merge`` (on by default under
``k_sweep_batch`` when more than one k is swept) members of several ks
share one batched solve (:meth:`NMFk._solve_ensembles_merged`). A member is
keyed by (seed, member) alone, so the K-padded and merged sweeps solve the
per-k sweep's members, to summation order. ``k_sweep_batch=None`` keeps the
per-k path: on the card there is no compile for the padding to share.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.nn.functional as F

from ..config import NMFkConfig, check_device
from ..ops import ell, linalg, sparse
from ..parallel.mesh import WORLD, is_proc0, sync_processes
from ..parallel.partition import block_range
from ..utils import memory, timing
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


def _ensemble_cfg_tag(ncfg, cfg, K=None, grid=None) -> str:
    """Everything that shapes a member's result (``nmfk.py:468-478``): a
    saved part replays only under the same tag. Unlike the JAX package's
    it holds ``bcd_obj``, ``hals_block``, ``use_fused``, ``kl_chunk``,
    ``tol_check_every``, the width ``K`` the members are solved at (k, or
    a K-padded sweep's max(k_range): a part never replays into a sweep of
    the other kind) and the grid with its ensemble groups."""
    return repr((ncfg.k, ncfg.itr, ncfg.norm.lower(), ncfg.method.lower(),
                 ncfg.init, ncfg.precision, ncfg.a_precision, ncfg.seed,
                 float(ncfg.tol), int(ncfg.tol_check_every), cfg.noise_var,
                 cfg.sampling, cfg.seed_grid, ncfg.bcd_obj, ncfg.hals_block,
                 ncfg.use_fused, ncfg.kl_chunk, K or ncfg.k,
                 grid.shape + (grid.p_e,) if grid is not None else (1, 1, 1),
                 ncfg.sparse_grid_format))


def _part_suffix(grid) -> str:
    """A rank's part files are ``part_{offset}_r{rank}.pt`` on a grid."""
    return ".pt" if grid is None else f"_r{grid.rank}.pt"


def _save_ensemble_part(parts_dir, offset, W, H, errs, seed, cfg_tag, grid,
                        stop, members):
    """One solved batch, members ``offset`` to ``stop``, as
    ``part_{offset}.pt`` (``nmfk.py:481-488``; on a grid this rank's
    blocks, the JAX package's per-process shards, :490-544): factors at
    their own dtype, written beside and moved into place. ``members``, a
    range of global indices, are those it holds: all of the batch, or
    under p_e groups the group's share."""
    os.makedirs(parts_dir, exist_ok=True)
    path = os.path.join(parts_dir, f"part_{offset:06d}{_part_suffix(grid)}")
    tmp = path + ".tmp"
    torch.save({"W": W.detach().cpu(), "H": H.detach().cpu(),
                "errs": errs.detach().cpu(), "offset": offset, "stop": stop,
                "members": torch.arange(members.start, members.stop),
                "seed": seed, "cfg_tag": cfg_tag}, tmp)
    os.replace(tmp, path)


def _load_ensemble_parts(parts_dir, n_pert, seed, cfg_tag, device,
                         grid=None):
    """The saved batches that cover members 0, 1, ... without a gap
    (``nmfk.py:546-622``): (members covered, the global indices of the
    members held, W parts, H parts, error parts) on ``device``. Parts of
    another seed or tag, and torn ones, are skipped. Members are keyed by
    their global index, so the replay takes parts of any batch size. On a
    grid this rank's own parts."""
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
                parts[int(d["offset"])] = (int(d["stop"]), d["members"],
                                           d["W"], d["H"], d["errs"])
        except Exception:
            continue            # torn write: recompute
    done, held = 0, ([], [], [], [])
    while done < n_pert and done in parts:
        done, *part = parts[done]
        for got, x in zip(held, part):
            got.append(x)
    return (done, *held)


def _common_parts(grid, done, *parts):
    """The replay that every rank of every ensemble group has: the fewest
    members any rank's parts cover, this rank's parts (member indices
    first) cut to the members below it."""
    fewest = -int(grid.max(torch.tensor([-done], dtype=torch.float64,
                                        device=grid.device), WORLD)[0])
    if fewest == done:
        return (done, *parts)
    if not fewest:
        return (0, *([] for _ in parts))
    keep = torch.cat(parts[0]) < fewest
    return (fewest, *([torch.cat(p)[keep.to(p[0].device)]] for p in parts))


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
        self._K = None        # the K-padded sweep's width, set by fit()
        self._ell = None      # the dual ELL of a sparse A and its perms
        self.prune_state = None
        self._orig_shape = None   # A's shape before pruning
        # ((r0, r1, m), (c0, c1, n)): where A (pruned), or this rank's block
        # of it on a grid, lies
        self._spans = None

    def fit(self, A) -> int:
        """Run the sweep; returns the estimated k (reference PyNMFk.fit,
        pyDNMFk.py:168-215). On a grid A is this rank's block of a dense
        matrix, a whole sparse one (a SparseTriplet, which each rank cuts
        to its block) or this rank's block of one (the reader's
        SparseGridInput), and every rank returns rank 0's k."""
        cfg, grid = self.cfg, self.grid
        if not cfg.nmf.a_dtype.is_floating_point:
            raise ValueError(
                "quantized (uint8) A storage is an NMF-level option: the NMFk "
                "ensemble perturbs A multiplicatively and would re-round every "
                "member; use a_precision='bfloat16' for the ensemble "
                "(nmfk.py:647-652)")
        check_device(self.device)
        os.makedirs(self.results_path, exist_ok=True)
        A = self._prepare(A)
        # the K-padded sweep, and its merged batches where more than one k
        # is left (nmfk.py:767-786); None keeps the per-k path
        self._K = max(cfg.k_range) if cfg.k_sweep_batch and cfg.k_range \
            else None
        start_k = self._rank0(self.checkpoint.resume_k(cfg.start_k,
                                                       cfg.step_k))
        ks = list(range(start_k, cfg.end_k + 1, cfg.step_k))
        if self._K is not None and len(ks) > 1 and (
                cfg.k_sweep_merge is not False):
            for k, ensemble in self._solve_ensembles_merged(A, ks):
                self.pynmfk_per_k(A, k, ensemble=ensemble)
        else:
            for k in ks:
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
        """Rank 0's ``value`` on every rank of a grid, of every group."""
        if self.grid is None:
            return value
        return int(self.grid.broadcast(torch.tensor(
            [value], dtype=torch.float64, device=self.device), WORLD)[0])

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
        if self.grid is not None:
            return self._format_grid(A)
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

    def _format_grid(self, A):
        """This rank's block of a sparse A on the grid, at the factor
        dtype, as a SparseGridInput in the format that the ranks agree on
        (``ops/sparse.py::grid_format``); a dual ELL goes to ``self._ell``
        with its perms."""
        with timing.timed("sparse_format"):
            A = sparse.grid_format(A.to(self.device), self.grid,
                                   self.cfg.nmf.sparse_grid_format)
        A = A.astype(self.cfg.nmf.dtype)
        self._ell = A.ell
        return A

    def _members(self, A, data):
        """The member stack of a sparse A for perturbed values ``data``
        ((b, nnz), on a grid the block's): the dual ELL through its perms,
        or the triplet."""
        if self._ell is not None:
            return ell.ell_with_data(*self._ell, data)
        if isinstance(A, sparse.SparseGridInput):
            A = A.block
        return A.with_data(data)

    def _ensemble_batch_size(self, A, k, cap=None) -> int:
        """Members per batched solve at k columns, of all ensemble groups
        together, at most ``cap`` (default ``perturbations``; the merged
        sweep's is all its members, nmfk.py:1039-1040):
        ``ensemble_batch``, or as many as the memory model
        (``utils/memory.py``) fits in a rank, p_e times over. On a grid the
        least that any rank holds; under p_e groups rounded down to a
        multiple of p_e, and at least p_e (``nmfk.py:799-828``)."""
        cfg, grid = self.cfg, self.grid
        p_e = grid.p_e if grid is not None else 1
        cap = cap or cfg.perturbations
        if cfg.ensemble_batch:
            batch = int(cfg.ensemble_batch)
        else:
            share = memory.members_within(*self._member_bytes(A, k), cap,
                                          cfg.hbm_budget, A.device)
            if grid is not None:        # the least that any rank holds
                share = -int(grid.max(torch.tensor(
                    [-share], dtype=torch.float64, device=A.device),
                    WORLD)[0])
            batch = share * p_e
        return memory.round_to_groups(batch, cap, p_e)

    def _member_bytes(self, A, k) -> tuple:
        """(bytes of one member, bytes the batch shares) of this rank's A
        at k columns (``utils/memory.py``): a dense A's, or a sparse A's on
        the dual ELL it runs on (``self._ell``) or as the triplet."""
        m, n = A.shape
        if not linalg.is_sparse(A):
            return memory.dense_member_bytes(m, n, k, self.cfg.nmf)
        flat = (A.flat.numel() if isinstance(A, sparse.SparseGridInput)
                else 0)
        return memory.sparse_member_bytes(
            m, n, A.nse, k, self.cfg.nmf,
            self._ell[0] if self._ell is not None else None, flat, A.device)

    def _solve_ensemble(self, A, k, members=None):
        """Sample and factorize all perturbations; returns (W_all (p,m,k),
        H_all (p,k,n), errs (p,)); in a K-padded sweep solved at its K
        (:meth:`_solve_members`).

        ``members=(A_ens, W0, H0)`` supplies the perturbed copies and init
        factors of all members instead of drawing them (parity tests feed
        the JAX draws); under nnsvd, ``members=(A_ens, None, None)`` takes
        the init from the supplied copies. On a grid each of these is this
        rank's block, and so are the returned factors. Under p_e groups
        each group solves its share of every batch (of the supplied
        members: one batch) and the members come back gathered, on every
        rank."""
        cfg, grid = self.cfg, self.grid
        ncfg = cfg.nmf.replace(k=k)
        n_pert = cfg.perturbations
        K = self._K or k
        if members is not None:          # one batch of all of them
            A_ens = as_tensor(members[0])
            self.last_batch_size = A_ens.shape[0]
            lo, hi = grid.members(A_ens.shape[0]) if grid is not None \
                else (0, A_ens.shape[0])
            [(W, H, errs)] = self._solve_members(
                A, ncfg, [(k, range(lo, hi))], K, members=tuple(
                    None if x is None else as_tensor(x)[lo:hi]
                    for x in members))
            return self._gather_members(
                torch.arange(lo, hi, device=self.device), W, H, errs,
                A_ens.shape[0])
        batch = self._ensemble_batch_size(A, K)
        self.last_batch_size = batch
        tag = _ensemble_cfg_tag(ncfg, cfg, K, grid)
        parts_dir = os.path.join(self.results_path, str(k), "ensemble_parts")
        done, parts = 0, ([], [], [], [])     # member indices, W, H, errs
        if cfg.checkpoint:
            st = self.checkpoint.state or self.checkpoint.load()
            # replay the saved batches at any stage before the k's results
            # were saved: a crash in the clustering or the refit resumes
            # from the parts alone (nmfk.py:898-909)
            if (st is not None and st.k == k and st.seed == ncfg.seed
                    and st.flag < FLAG_SAVED):
                done, *parts = _load_ensemble_parts(
                    parts_dir, n_pert, ncfg.seed, tag, self.device, grid)
            if grid is not None:
                done, *parts = _common_parts(grid, done, *parts)
        # the k is in progress from here on, so that a part saved before the
        # first batch's flag replays too
        self.checkpoint.save(FLAG_RUNNING, done, k, ncfg.seed)
        for start in range(done, n_pert, batch):
            stop = min(start + batch, n_pert)
            lo, hi = grid.members(stop - start) if grid is not None \
                else (0, stop - start)
            idx = range(start + lo, start + hi)
            # a group without a member in this batch solves nothing (its
            # solve's collectives are its own) and saves an empty part
            [(W, H, errs)] = self._solve_members(A, ncfg, [(k, idx)], K)
            for got, x in zip(parts, (torch.arange(
                    idx.start, idx.stop, device=self.device), W, H, errs)):
                got.append(x)
            if cfg.checkpoint:
                _save_ensemble_part(parts_dir, start, W, H, errs, ncfg.seed,
                                    tag, grid, stop, idx)
            self.checkpoint.save(FLAG_RUNNING, stop, k, ncfg.seed)
        held, W, H, errs = (torch.cat(p) for p in parts)
        return self._gather_members(held, W, H, errs, n_pert)

    def _solve_ensembles_merged(self, A, ks):
        """Yield (k, (W_all, H_all, errs)) for each k of ``ks`` in turn,
        the members of several ks solved together
        (``nmfk.py::_solve_ensembles_merged``, :1010-1193): each k's
        members still to solve are cut into chunks of at most ``batch``
        (the memory model's at K, of at most perturbations x len(ks)
        members), and the chunks packed, in k order, into batches of at
        most ``batch`` members, each solved at K with its own row of the
        column mask. A k is handed on as soon as all its members are
        solved, and its clustering runs before the next batch. A member is
        keyed by (seed, member), so it is the one the per-k K-padded sweep
        solves. Under p_e groups a batch splits over the groups as in
        :meth:`_solve_ensemble` (no padding), and each group saves, for
        every k of the batch, a part of its share with the members' global
        indices. Saved parts of every k replay on a resume.

        FLAG_RUNNING names the smallest k not yet written, with its done
        count: at the start, after every batch and before a k is handed
        on, so that a crash between a k's solve and its results replays
        that k's parts. (JAX's names the next k with members to solve,
        which can be past ks solved but not written, and a resume then
        skips them: ROADMAP queue 3, nmfk.py:1183-1190.)"""
        cfg, grid = self.cfg, self.grid
        K, n_pert, seed = self._K, cfg.perturbations, cfg.nmf.seed
        batch = self._ensemble_batch_size(A, K, cap=n_pert * len(ks))
        self.last_batch_size = batch
        st = (self.checkpoint.state or self.checkpoint.load()) \
            if cfg.checkpoint else None
        state, chunks = {}, []           # chunks: (k, start, stop)
        for k in ks:
            tag = _ensemble_cfg_tag(cfg.nmf.replace(k=k), cfg, K, grid)
            pdir = os.path.join(self.results_path, str(k), "ensemble_parts")
            done, parts = 0, ([], [], [], [])
            if (st is not None and st.seed == seed
                    and (k > st.k or st.flag < FLAG_SAVED)):
                done, *parts = _load_ensemble_parts(pdir, n_pert, seed, tag,
                                                    self.device, grid)
            if cfg.checkpoint and grid is not None:
                done, *parts = _common_parts(grid, done, *parts)
            state[k] = dict(done=done, parts=parts, tag=tag, dir=pdir)
            chunks += [(k, off, min(off + batch, n_pert))
                       for off in range(done, n_pert, batch)]
        batches = []
        for ch in chunks:
            if batches and sum(stop - off for _, off, stop in batches[-1]) \
                    + ch[2] - ch[1] <= batch:
                batches[-1].append(ch)
            else:
                batches.append([ch])
        pending = list(ks)

        def running():
            k = pending[0]
            self.checkpoint.save(FLAG_RUNNING, state[k]["done"], k, seed)

        for sb in [None] + batches:
            if sb is not None:
                b = sum(stop - off for _, off, stop in sb)
                lo, hi = grid.members(b) if grid is not None else (0, b)
                mine, pos = [], 0        # this group's share of each chunk
                for k, off, stop in sb:
                    a, z = max(lo - pos, 0), min(hi - pos, stop - off)
                    mine.append((k, range(off + a, off + max(a, z))))
                    pos += stop - off
                with timing.timed("ensemble_solve"):
                    solved = self._solve_members(A, cfg.nmf, mine, K)
                for (k, off, stop), (_, idx), (W, H, errs) in zip(
                        sb, mine, solved):
                    s = state[k]
                    for got, x in zip(s["parts"], (torch.arange(
                            idx.start, idx.stop, device=self.device),
                            W, H, errs)):
                        got.append(x)
                    if cfg.checkpoint:
                        _save_ensemble_part(s["dir"], off, W, H, errs, seed,
                                            s["tag"], grid, stop, idx)
                    s["done"] = stop
            while pending and state[pending[0]]["done"] >= n_pert:
                running()
                k = pending.pop(0)
                with timing.timed("ensemble_solve"):
                    held, W, H, errs = (torch.cat(p) for p in
                                        state.pop(k)["parts"])
                    ensemble = self._gather_members(held, W, H, errs, n_pert)
                yield k, ensemble
            if pending:
                running()

    def _solve_members(self, A, ncfg, chunks, K, members=None):
        """[(W, H, errs)] of the members of each chunk (k, global indices)
        of ``chunks``, solved together at K columns: drawn, or the supplied
        ``members`` of one chunk (as in :meth:`_solve_ensemble`); on a grid
        this rank's blocks. A member of a k below K starts from its init at
        k zero-padded to K and runs under a row of the column mask that
        holds its k columns active (``nmfk.py:157-163``, :177-182); its
        factors come back sliced to k. A chunk without a member: empty
        tensors of its shapes."""
        cfg, grid = self.cfg, self.grid
        sparse_A = linalg.is_sparse(A)
        # a sparse block's members draw the whole flat values and keep the
        # block's slots
        slots = A.perm if isinstance(A, sparse.SparseGridInput) else None
        spans = self._spans or ((0, A.shape[0], A.shape[0]),
                                (0, A.shape[1], A.shape[1]))
        shape = (spans[0][2], spans[1][2])
        idx = [i for _, r in chunks for i in r]
        if not idx:
            m, n = A.shape
            return [(torch.empty((0, m, k), dtype=ncfg.dtype,
                                 device=self.device),
                     torch.empty((0, k, n), dtype=ncfg.dtype,
                                 device=self.device),
                     torch.empty((0,), dtype=linalg.acc_dtype(ncfg.a_dtype),
                                 device=self.device)) for k, _ in chunks]
        inits = []
        if members is not None:
            A_ens = members[0].to(self.device, ncfg.a_dtype).contiguous()
            if members[1] is None:
                inits.append(self._init_members(
                    ncfg.replace(k=chunks[0][0]), A_ens, None, shape, None,
                    grid=grid, spans=self._spans))
            else:
                inits.append(tuple(x.to(self.device, ncfg.dtype).contiguous()
                                   for x in members[1:]))
            if sparse_A and slots is not None:
                A_ens = A_ens[..., slots]
        else:
            source = A if not sparse_A else (A.data if slots is None
                                             else A.flat)
            A_ens = sampler.sample_ensemble(source, ncfg.seed, cfg.noise_var,
                                            idx, cfg.sampling, ncfg.a_dtype,
                                            tile_grid=cfg.seed_grid,
                                            grid=grid, spans=self._spans,
                                            slots=slots)
            with timing.timed("ensemble_init"):
                pos = 0
                for k, r in chunks:
                    if len(r):
                        inits.append(self._init_members(
                            ncfg.replace(k=k), A_ens[pos:pos + len(r)], r,
                            shape, A.device, cfg.seed_grid, grid,
                            self._spans))
                    pos += len(r)
        W0 = torch.cat([F.pad(W, (0, K - W.shape[-1])) for W, _ in inits])
        H0 = torch.cat([F.pad(H, (0, 0, 0, K - H.shape[-2]))
                        for _, H in inits])
        mask = None
        if any(k < K for k, r in chunks if len(r)):
            mask = torch.cat([torch.arange(K, device=self.device).expand(
                len(r), K) < k for k, r in chunks])
        if sparse_A:
            A_ens = self._members(A, A_ens)
        W, H, errs = nmf_mod.solve(A_ens, W0, H0, ncfg.eps, ncfg, grid=grid,
                                   col_mask=mask)
        out, pos = [], 0
        for k, r in chunks:
            sl = slice(pos, pos + len(r))
            out.append((W[sl, :, :k].contiguous(), H[sl, :k].contiguous(),
                        errs[sl]))
            pos += len(r)
        return out

    def _gather_members(self, held, W, H, errs, n_pert):
        """The first ``n_pert`` members, in global order, from this rank's
        (``held``: their global indices; replayed parts overshoot where
        ``perturbations`` shrank between runs, nmfk.py:1004-1007); under
        p_e groups gathered over 'e' first, so that every group holds every
        member's blocks."""
        grid = self.grid
        if grid is not None and grid.p_e > 1:
            with timing.timed("ensemble_gather"):
                held = grid.gather(held, "e", 0)
                W, H, errs = (grid.gather(x.contiguous(), "e", 0)
                              for x in (W, H, errs))
            order = torch.argsort(held)
            W, H, errs = W[order], H[order], errs[order]
        return W[:n_pert], H[:n_pert], errs[:n_pert]

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

        # a K-padded sweep clusters the ensemble padded to K with the k's
        # active mask where 1 < k < K, and refits at K under the k's column
        # mask where k < K (nmfk.py:1227-1275); both sliced back to k
        K = self._K or k
        active = torch.arange(K, device=self.device) < k
        with timing.timed("clustering"):
            if 1 < k < K:
                (centroids, _cent_std, H_all_c, cluster_sils, avg_sil,
                 _sils) = cluster_ensemble(
                    F.pad(W_all, (0, K - k)), F.pad(H_all, (0, 0, 0, K - k)),
                    cfg.nmf.eps, grid, active=active)
                centroids, H_all_c = centroids[:, :k], H_all_c[:, :k]
                cluster_sils = cluster_sils[:k]
            else:
                (centroids, _cent_std, H_all_c, cluster_sils, avg_sil,
                 _sils) = cluster_ensemble(W_all, H_all, cfg.nmf.eps, grid)
        self.checkpoint.save(FLAG_CLUSTERED, cfg.perturbations, k, seed)

        # regression re-fit of H with W frozen (pyDNMFk.py:245-248); A is
        # pruned already, so the refit does not prune again. Under BCD the
        # refit moves W too, as JAX's does (ROADMAP queue 3)
        with timing.timed("regression"):
            AvgW = F.pad(centroids, (0, K - k))
            AvgH = F.pad(median0(H_all_c), (0, 0, 0, K - k))
            reg = NMF(cfg.nmf.replace(k=K, W_update=False, prune=False),
                      self.device, grid)
            # a sparse A refits on the format the sweep chose: the ELL it
            # packed, or on a grid the bundle, which holds the agreed one
            A_reg = A if self._ell is None or grid is not None \
                else self._ell[0]
            AvgW, AvgH, L_errDist = reg.fit(
                A_reg, factors=(AvgW, AvgH),
                col_mask=active if k < K else None)
            AvgW, AvgH = AvgW[:, :k], AvgH[:k]
            col_err = reg.column_err()
            if grid is not None and grid.p_e > 1:
                AvgW, AvgH, col_err, L_errDist = self._from_group0(
                    AvgW, AvgH, col_err, L_errDist)
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

    def _from_group0(self, W, H, col_err, err):
        """Group 0's refit (its factors, column errors and error) on every
        ensemble group: each group refits the same members alike, and
        since the sparse scatter-adds sum in a fixed order
        (``ops/sparse.py::line_plan``) to the same bits; the broadcast is
        a guard that can go (ROADMAP)."""
        grid, dev = self.grid, self.device
        col = grid.broadcast(torch.as_tensor(col_err, device=dev), "e")
        err = grid.broadcast(torch.tensor([err], dtype=torch.float64,
                                          device=dev), "e")
        return (grid.broadcast(W, "e"), grid.broadcast(H, "e"),
                col.cpu().numpy(), float(err[0]))

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
