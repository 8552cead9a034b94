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


def _entry(fn, rank, world, p_r, p_c, init, out_dir, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        from pydnmfk_tpu_torch.parallel import mesh
        grid = mesh.initialize(p_r, p_c, "cpu", init_method=init, rank=rank,
                               world_size=world, timeout=COLLECTIVE_TIMEOUT)
        out = fn(grid, *args)
        torch.save(out, path + ".pt")
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_grid(fn, grid, tmp_path, *args, tag="g"):
    """``fn(GridContext, *args)`` on every rank of a ``grid`` = (p_r, p_c)
    group of CPU processes; returns the ranks' results in rank order.
    ``fn`` must be a module-level function of a module that imports no
    JAX."""
    p_r, p_c = grid
    world = p_r * p_c
    out_dir = os.path.join(str(tmp_path), f"{tag}_{p_r}x{p_c}")
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, p_r, p_c, init,
                                              out_dir, args))
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
                  for x in blocks_for_rank(grid.shape, grid.rank, A, W0, H0))
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
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, grid.rank, A)[0]
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
    ensemble parts and is run again, which resumes from them."""
    import pydnmfk_tpu_torch.models.nmfk as nmfk_mod
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils import io
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, grid.rank, A)[0]
                          .copy())
    out = {"writes": []}
    real_write = io.DataWriter.save_cluster_results

    def write(self, *a, **k):
        out["writes"].append(self.fpath)
        return real_write(self, *a, **k)

    io.DataWriter.save_cluster_results = write
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
        nopt = model.fit(Ab)
        out[name] = (nopt, model.per_k_stats, len(saved))
    io.DataWriter.save_cluster_results = real_write
    return out


def checkpointed_solve(grid, A, results_path):
    """An FRO-MU solve with ``solve_checkpoint_every=10`` over 40
    iterations: unbroken, then failed right after its second save (each
    rank saves its own blocks) and run again: (error unbroken, error
    resumed, iterations run by the resumed fit)."""
    import pydnmfk_tpu_torch.utils.checkpoint as ckpt
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.utils.convert import blocks_for_rank
    Ab = torch.from_numpy(blocks_for_rank(grid.shape, grid.rank, A)[0]
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
    each rank reads its block. Returns each run's result, or the text of
    the NotPortedError it raised."""
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch import NotPortedError, Runner
    from pydnmfk_tpu_torch.ops.sparse import from_coo
    out = {}
    triplet = from_coo(torch.tensor([0, 1]), torch.tensor([1, 0]),
                       torch.tensor([1.0, 2.0]), (2, 2))
    for name, fit in (("nmf", NMF(NMFConfig(), grid=grid).fit),
                      ("nmfk", NMFk(NMFkConfig(), grid=grid).fit)):
        try:
            fit(triplet)
        except NotPortedError as e:
            out[name] = str(e)
    for ftype, fname in reads:
        runner = Runner(norm="fro", itr=30, precision="float64",
                        device="cpu", save_factors=True)
        try:
            out[ftype] = runner.run(grid=grid.shape, fpath=fpath,
                                    ftype=ftype, fname=fname, k=3,
                                    results_path=f"{results_path}/{ftype}/")
        except NotPortedError as e:
            out[ftype] = str(e)
    return out
