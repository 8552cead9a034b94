"""Process groups for the grid tests: spawn a few CPU ranks that form a gloo
group through a ``file://`` rendezvous under the test's tmp_path, run one
function on each and collect what each returns.

Every group has a timeout on its collectives, and the parent joins the
ranks with a deadline and kills what is left, so a deadlock fails the test
instead of hanging it. This module imports torch and the port only: the
spawned ranks never import JAX.
"""
from __future__ import annotations

import functools
import multiprocessing
import os
import time
import traceback

import torch

# seconds a collective may wait for the other ranks, and the deadline of a
# whole spawn
COLLECTIVE_TIMEOUT = 60
SPAWN_TIMEOUT = 240


def _entry(fn, rank, world, p_r, p_c, p_e, init, out_dir, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        from pydnmfk_tpu_torch.parallel import mesh
        grid = mesh.initialize(p_r, p_c, "cpu", p_e=p_e, init_method=init,
                               rank=rank, world_size=world,
                               timeout=COLLECTIVE_TIMEOUT)
        out = fn(grid, *args)
        torch.save(out, path + ".pt")
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_grid(fn, grid, tmp_path, *args, tag="g"):
    """``fn(GridContext, *args)`` on every rank of a ``grid`` = (p_r, p_c)
    group of CPU processes, or of p_e such groups where ``grid`` = (p_r,
    p_c, p_e); returns the ranks' results in rank order. ``fn`` must be a
    module-level function of a module that imports no JAX."""
    p_r, p_c, p_e = (*grid, 1)[:3]
    world = p_e * p_r * p_c
    out_dir = os.path.join(str(tmp_path), f"{tag}_{p_r}x{p_c}x{p_e}")
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, p_r, p_c, p_e,
                                              init, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    errors = []
    for r in range(world):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not alive and not errors, (
        f"{len(alive)} rank(s) still running at the deadline; "
        + "\n".join(errors))
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- rank functions ------------------------------------------------------
def _local(grid):
    """This rank's place in its p_r x p_c grid, row-major: its rank in the
    world less its ensemble group's first."""
    return grid.coords[0] * grid.shape[1] + grid.coords[1]


def nmf_cases(grid, A, W0, H0, cases):
    """Each NMF case (NMFConfig keywords by name) fit on this rank's block
    of A from its blocks of (W0, H0), or from nnsvd; per case the gathered
    W and H, the error, the column errors and this rank's own blocks of W
    and H as the solve left them. Also the collectives of one FRO-MU and
    one KL-MU step on the blocks."""
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.models import updates
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    Ab, Wb, Hb = (torch.from_numpy(x.copy())
                  for x in blocks_for_rank(grid.shape, _local(grid), A, W0,
                                           H0))
    out = {"coords": grid.coords, "shape": tuple(Ab.shape)}
    for name, kw in cases.items():
        cfg = NMFConfig(precision="float64", **kw)
        model = NMF(cfg, grid=grid)
        factors = None if cfg.init == "nnsvd" else (Wb, Hb)
        W, H, err = model.fit(Ab, factors=factors)
        out[name] = dict(W=W, H=H, err=err, col=model.column_err(),
                         W_blk=model._W, H_blk=model._H)
    eps = 1e-16
    out["stats"] = {norm: timing.collective_stats(
        functools.partial(step, grid=grid), Ab, Wb, Hb, eps, grid=grid)
        for norm, step in (("fro", updates.mu_fro_step),
                           ("kl", updates.mu_kl_step))}
    timing.enable(True)
    timing.reset()
    est = timing.record_dist_comm(functools.partial(updates.mu_fro_step,
                                                    grid=grid),
                                  Ab, Wb, Hb, eps, grid=grid, iterations=10)
    out["dist_comm"] = (est, dict(timing.TIMINGS),
                        timing.category_breakdown()["dist_comm"])
    timing.enable(False)
    return out


def members(grid, A, seed, noise_var, method, idx, prune, tile_grid=None):
    """This rank's blocks of the members ``idx`` of A (pruned first under
    ``prune``; under ``tile_grid``, the reference's MPI seeding) and where
    they lie in the member (``spans``)."""
    from pydnmfk_tpu_torch.models import sampler
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    from pydnmfk_tpu_torch.utils.pruning import prune_A
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, _local(grid), A)[0]
                          .copy())
    if prune:
        Ab, _ = prune_A(Ab, grid)
    spans = grid.span(Ab.shape[0], "r"), grid.span(Ab.shape[1], "c")
    return spans, sampler.sample_ensemble(Ab, seed, noise_var, idx, method,
                                          tile_grid=tile_grid, grid=grid,
                                          spans=spans)


class _Break(Exception):
    pass


def nmfk_sweeps(grid, A, sweeps):
    """Each sweep (name: (NMFkConfig keywords, NMFConfig keywords)) on this
    rank's block of A: (nopt, per-k statistics) by name. A sweep whose
    keywords hold ``break_after`` parts fails right after saving that many
    ensemble parts and is run again, which resumes from them. The members
    are those ``_solve_ensemble`` returns, or the merged sweep hands to
    ``pynmfk_per_k``."""
    import pydnmfk_tpu_torch.models.nmfk as nmfk_mod
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils import io
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    # a sparse A (COO arrays) goes whole: each rank cuts its block
    Ab = _triplet(A) if isinstance(A, tuple) else torch.from_numpy(
        blocks_for_rank(grid.shape, _local(grid), A)[0].copy())
    out = {"writes": []}
    real_write = io.DataWriter.save_cluster_results

    def write(self, *a, **k):
        out["writes"].append(self.fpath)
        return real_write(self, *a, **k)

    io.DataWriter.save_cluster_results = write
    solved = {}
    real_solve = nmfk_mod.NMFk._solve_ensemble

    def solve_ensemble(self, A, k, members=None):
        got = real_solve(self, A, k, members)
        solved[k] = tuple(x.clone() for x in got)
        return got

    real_per_k = nmfk_mod.NMFk.pynmfk_per_k

    def per_k(self, A, k, ensemble=None):
        if ensemble is not None:        # the merged K-padded sweep's
            solved[k] = tuple(x.clone() for x in ensemble)
        return real_per_k(self, A, k, ensemble)

    nmfk_mod.NMFk._solve_ensemble = solve_ensemble
    nmfk_mod.NMFk.pynmfk_per_k = per_k
    for name, (kw, nmf_kw) in sweeps.items():
        kw = dict(kw)
        break_after = kw.pop("break_after", 0)
        cfg = NMFkConfig(nmf=NMFConfig(precision="float64", **nmf_kw), **kw)
        real = nmfk_mod._save_ensemble_part
        saved = []

        def save(*a, **k):
            real(*a, **k)
            saved.append(1)
            if len(saved) == break_after:
                raise _Break()

        if break_after:
            nmfk_mod._save_ensemble_part = save
            try:
                NMFk(cfg, grid=grid).fit(Ab)
            except _Break:
                pass
            finally:
                nmfk_mod._save_ensemble_part = real
        model = NMFk(cfg, grid=grid)
        solved.clear()
        nopt = model.fit(Ab)
        out[name] = (nopt, model.per_k_stats, len(saved))
        out.setdefault("formats", {})[name] = model._ell is not None
        # this rank's blocks of every member (W, H, error) by k, and the
        # batch, of the last run
        out.setdefault("members", {})[name] = dict(solved)
        out.setdefault("batch", {})[name] = getattr(model, "last_batch_size",
                                                    None)
    io.DataWriter.save_cluster_results = real_write
    nmfk_mod.NMFk._solve_ensemble = real_solve
    nmfk_mod.NMFk.pynmfk_per_k = real_per_k
    return out


def checkpointed_solve(grid, A, results_path):
    """An FRO-MU solve with ``solve_checkpoint_every=10`` over 40
    iterations: unbroken, then failed right after its second save (each
    rank saves its own blocks) and run again: (error unbroken, error
    resumed, iterations run by the resumed fit)."""
    import pydnmfk_tpu_torch.utils.checkpoint as ckpt
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, _local(grid), A)[0]
                          .copy())
    cfg = NMFConfig(k=3, itr=40, norm="fro", precision="float64",
                    solve_checkpoint_every=10, results_path=results_path)
    err = NMF(cfg, grid=grid).fit(Ab)[2]
    real = ckpt.SolveCheckpoint.save
    saves = []

    def save(self, W, H, i):
        real(self, W, H, i)
        saves.append(i)
        if len(saves) == 2:
            raise _Break()

    ckpt.SolveCheckpoint.save = save
    try:
        NMF(cfg, grid=grid).fit(Ab)
    except _Break:
        pass
    finally:
        ckpt.SolveCheckpoint.save = real
    grid.barrier()              # every rank has saved before the listing
    left = sorted(os.listdir(results_path))
    saves.clear()
    ckpt.SolveCheckpoint.save = lambda self, W, H, i: (
        saves.append(i), real(self, W, H, i))
    try:
        resumed = NMF(cfg, grid=grid).fit(Ab)[2]
    finally:
        ckpt.SolveCheckpoint.save = real
    return err, resumed, list(saves), left


def nmfk_checks(grid, A, draws, sweeps, solve_path=None):
    """The member draws ((seed, noise_var, method, idx, prune) by name),
    the sweeps (:func:`nmfk_sweeps`) and, given a ``solve_path``, the
    checkpointed solve, in one group."""
    out = {"draws": {name: members(grid, A, *d) for name, d in draws.items()},
           "sweeps": nmfk_sweeps(grid, A, sweeps)}
    if solve_path:
        out["solve"] = checkpointed_solve(grid, A, solve_path)
    return out


def runner_reads(grid, fpath, results_path, reads):
    """``Runner.run`` on the grid for each (ftype, fname) of ``reads``:
    each rank reads its block (of an .npz its row panel). Also NMF and
    NMFk of a whole sparse triplet, which each rank cuts to its block.
    Returns each run's result."""
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig, Runner
    from pydnmfk_tpu_torch.ops.sparse import from_coo
    triplet = from_coo(torch.tensor([0, 1, 2]), torch.tensor([1, 0, 2]),
                       torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64),
                       (3, 3))
    ncfg = NMFConfig(k=1, itr=10, norm="fro", precision="float64")
    out = {"nmf": NMF(ncfg, grid=grid).fit(triplet),
           "nmfk": NMFk(NMFkConfig(nmf=ncfg, start_k=1, end_k=1,
                                   perturbations=2, checkpoint=False,
                                   results_path=f"{results_path}/nmfk/"),
                        grid=grid).fit(triplet)}
    for ftype, fname in reads:
        runner = Runner(norm="fro", itr=30, precision="float64",
                        device="cpu", save_factors=True)
        out[ftype] = runner.run(grid=grid.shape, fpath=fpath, ftype=ftype,
                                fname=fname, k=3,
                                results_path=f"{results_path}/{ftype}/")
    return out


# -- a sparse A on the grid ----------------------------------------------
def _triplet(coo):
    """The whole canonical triplet of COO arrays (rows, cols, vals,
    shape)."""
    from pydnmfk_tpu_torch.ops.sparse import from_coo
    rows, cols, vals, shape = coo
    return from_coo(torch.from_numpy(rows.copy()),
                    torch.from_numpy(cols.copy()),
                    torch.from_numpy(vals.copy()), shape)


def sparse_grid_cases(grid, coo, W0, H0, cases, empty_coo=None):
    """On this rank's block of the sparse A of ``coo``: its block and perm
    (``shard_sparse_grid``); each NMF case (NMFConfig keywords by name,
    f64) fit from its blocks of (W0, H0), as in :func:`nmf_cases`, with
    the format it ran; the grid products of both formats at f64 (the
    block's A H^T, W^T A, KL U H^T and W^T U, sqnorm, relative and column
    errors); the collectives of one FRO-MU and one KL-MU step in each
    format. ``empty_coo``: the same fits of its matrix (one block of which
    may hold no nonzero)."""
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.models import updates
    from pydnmfk_tpu_torch.ops import linalg, sparse
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    A = _triplet(coo)
    G = sparse.shard_sparse_grid(A, grid)
    _, Wb, Hb = (None if x is None else torch.from_numpy(x.copy())
                 for x in blocks_for_rank(grid.shape, _local(grid), None, W0,
                                          H0))
    out = {"coords": grid.coords,
           "block": (G.block.rows, G.block.cols, G.block.data, G.perm,
                     G.block.shape)}

    def fits(A, tag):
        for name, kw in cases.items():
            model = NMF(NMFConfig(precision="float64", **kw), grid=grid)
            W, H, err = model.fit(A, factors=(Wb, Hb))
            out[tag + name] = dict(W=W, H=H, err=err, col=model.column_err(),
                                   W_blk=model._W, H_blk=model._H,
                                   fmt=type(model._A).__name__)

    fits(A, "")
    if empty_coo is not None:
        fits(_triplet(empty_coo), "empty ")
    eps = 1e-16
    for fmt in ("triplet", "ell"):
        Af = sparse.grid_format(G, grid, fmt).local
        out[fmt] = dict(
            aht=linalg.matmul_AHT(Af, Hb, grid),
            wta=linalg.matmul_WTA(Wb, Af, grid),
            kl=updates._sparse_kl_products(Af, Wb, grid),
            colsq=grid.sum(linalg._sparse_terms(Af, Wb, Hb, -2)[0], "r"),
            sqnorm=linalg.sqnorm(Af, grid),
            err=linalg.relative_error(Af, Wb, Hb, grid=grid),
            col=linalg.column_error(Af, Wb, Hb, grid=grid),
            stats={norm: timing.collective_stats(
                functools.partial(step, grid=grid), Af, Wb, Hb, eps,
                grid=grid)
                for norm, step in (("fro", updates.mu_fro_step),
                                   ("kl", updates.mu_kl_step))})
        uht, wtu = out[fmt]["kl"]
        out[fmt]["kl"] = (uht(Af, Wb, Hb, eps), wtu(Af, Wb, Hb, eps))
    return out


def sparse_members(grid, coo, seed, noise_var, method, idx):
    """This rank's block of the members ``idx`` of the sparse A of
    ``coo``: (perm, values), each member drawn whole and cut to the block's
    slots, as NMFk draws them."""
    from pydnmfk_tpu_torch.models import sampler
    from pydnmfk_tpu_torch.ops import sparse
    G = sparse.shard_sparse_grid(_triplet(coo), grid)
    return G.perm, sampler.sample_ensemble(G.flat, seed, noise_var, idx,
                                           method, slots=G.perm)


def sparse_nmfk_checks(grid, coo, draws, sweeps):
    """The sparse member draws ((seed, noise_var, method, idx) by name) and
    the sweeps (:func:`nmfk_sweeps`) of the sparse A of ``coo``, in one
    group."""
    return {"draws": {name: sparse_members(grid, coo, *d)
                      for name, d in draws.items()},
            "sweeps": nmfk_sweeps(grid, coo, sweeps)}


def sparse_refusals(grid, coo, results_path):
    """The ValueErrors that NMF and NMFk raise on this rank for a sparse A
    with BCD, nnsvd, prune, a uint8 a_precision and a forced ``"ell"``,
    by name, and the format that the auto choice ran."""
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig
    A = _triplet(coo)
    out = {}

    def attempt(name, fit):
        try:
            fit()
        except ValueError as e:
            out[name] = str(e)

    for name, kw in (("bcd", dict(norm="fro", method="bcd")),
                     ("nnsvd", dict(norm="fro", init="nnsvd")),
                     ("prune", dict(prune=True)),
                     ("uint8", dict(a_precision="uint8")),
                     ("ell", dict(sparse_grid_format="ell"))):
        attempt(name, lambda: NMF(NMFConfig(k=2, itr=2, **kw),
                                  grid=grid).fit(A))
    cfg = NMFkConfig(nmf=NMFConfig(prune=True, itr=2), start_k=2, end_k=2,
                     perturbations=2, results_path=results_path,
                     checkpoint=False)
    attempt("nmfk prune", lambda: NMFk(cfg, grid=grid).fit(A))
    model = NMF(NMFConfig(k=2, itr=2), grid=grid)
    model.fit(A)
    out["auto"] = type(model._A).__name__
    return out


# -- ensemble groups (p_e) ------------------------------------------------
def context_checks(grid):
    """This rank's context on p_e groups of a grid and the collectives'
    reach: a sum over the group ('rc', and 'r' everywhere), a max over the
    world, a broadcast in the group, over 'e' and in the world, a gather
    over 'e' of blocks of unequal length; and the ValueError of a context
    whose p_e x p_r x p_c is not the world's size."""
    from pydnmfk_tpu_torch.parallel import mesh
    me = torch.tensor([float(grid.rank + 1)], dtype=torch.float64)
    out = {"rank": grid.rank, "coords": grid.coords, "shape": grid.shape,
           "p_e": grid.p_e, "group": grid.group_index,
           "n_ranks": grid.n_ranks, "world": grid.world_size,
           "proc0": grid.is_proc0, "members": grid.members(5),
           "sum rc": float(grid.sum(me.clone(), "rc")[0]),
           "sum r everywhere": float(grid.sum(me.clone(), "r",
                                              everywhere=True)[0]),
           "max world": float(grid.max(me.clone(), mesh.WORLD)[0]),
           "max rc": float(grid.max(me.clone())[0]),
           "broadcast rc": float(grid.broadcast(me.clone())[0]),
           "broadcast world": float(grid.broadcast(me.clone(),
                                                   mesh.WORLD)[0]),
           "broadcast e": float(grid.broadcast(me.clone(), "e")[0]),
           "gather e": grid.gather(torch.full((grid.group_index + 1, 2),
                                              float(grid.rank)), "e", 0)}
    try:
        mesh.GridContext(*grid.shape, "cpu", p_e=grid.p_e + 1)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def ensemble_checks(grid, A, coo, sweeps, sparse_sweeps, budgets, nmf_kw):
    """On p_e groups of a grid (or one): the dense sweeps of A and the
    sparse sweeps of the A of ``coo`` (:func:`nmfk_sweeps`: nopt,
    statistics and every member's blocks by k); the auto batch of a
    20-member FRO sweep at k = 3 under each ``hbm_budget`` of
    ``budgets``; and one NMF fit (``nmf_kw``, f64, rand init) of this
    rank's block of A: its gathered W, H and error."""
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    out = {"context": context_checks(grid),
           "dense": nmfk_sweeps(grid, A, sweeps) if sweeps else None,
           "sparse": (nmfk_sweeps(grid, coo, sparse_sweeps)
                      if sparse_sweeps else None)}
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, _local(grid), A)[0]
                          .copy())
    out["batch"] = [NMFk(NMFkConfig(
        nmf=NMFConfig(precision="float64"), perturbations=20,
        hbm_budget=budget, checkpoint=False,
        results_path="unused/"), grid=grid)._ensemble_batch_size(Ab, 3)
        for budget in budgets]
    if nmf_kw:
        out["nmf"] = NMF(NMFConfig(precision="float64", **nmf_kw),
                         grid=grid).fit(Ab)
    return out


def fed_sweeps(grid, A, coo, cases):
    """Each sweep of ``cases`` (name: (NMFkConfig keywords, NMFConfig
    keywords, sparse, {k: (A_ens, W0, H0)})) fed the given members, whole:
    a dense one on this rank's block of A, whose blocks of the members it
    takes, a sparse one on the A of ``coo``, whose members are the whole
    flat values. Returns (nopt, per-k statistics) by name."""
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    out = {}
    for name, (kw, nmf_kw, sparse_A, members) in cases.items():
        cfg = NMFkConfig(nmf=NMFConfig(precision="float64", **nmf_kw), **kw)
        model = NMFk(cfg, grid=grid)
        os.makedirs(model.results_path, exist_ok=True)
        m, n = coo[3] if sparse_A else A.shape
        (r0, r1), (c0, c1) = grid.rows(m), grid.cols(n)
        X = model._prepare(_triplet(coo) if sparse_A else torch.from_numpy(
            blocks_for_rank(grid.shape, _local(grid), A)[0].copy()))
        for k, (A_ens, W0, H0) in members.items():
            if not sparse_A:
                A_ens = A_ens[:, r0:r1, c0:c1]
            ens = model._solve_ensemble(X, k, members=(
                A_ens, W0[:, r0:r1], H0[:, :, c0:c1]))
            model.pynmfk_per_k(X, k, ensemble=ens)
        out[name] = (model.pvalue_analysis(), model.per_k_stats)
    return out
