"""High-level object API.

Port of ``pydnmfk_tpu/runner.py`` (reference ``pyDNMFk_Runner``,
pyDNMFk/runner.py:12-176): construct with hyperparameters and a device (the
CUDA card unless ``device="cpu"``), call ``.run(fpath=..., ...)``; returns
``{"nopt": ...}`` for process="pyDNMFk" or ``{"W", "H", "err"}`` for
process="pyDNMF". A ``grid`` other than (1, 1) runs one process per rank,
each calling ``run`` (under torchrun, ``parallel/mesh.py::initialize``):
each reads its block of A, every rank returns the same result, and rank 0
writes the files.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch

from .config import NMFConfig, NMFkConfig, check_device, check_jax_only
from .models.nmf import NMF
from .models.nmfk import NMFk
from .parallel import mesh
from .utils import timing
from .utils.io import DataReader


class Runner:
    def __init__(self, init="rand", itr=5000, norm="kl", method="mu",
                 verbose=False, checkpoint=False, timing_stats=False,
                 precision="float32", perturbations=20, noise_var=0.015,
                 sill_thr=0.6, sampling="uniform", process="pyDNMF",
                 a_precision=None, seed=100, tol=0.0, ensemble_batch=0,
                 save_factors=False, device="cuda", prune=False,
                 hbm_budget=0, kl_chunk=0,
                 seed_grid=None, solve_checkpoint_every=0,
                 matmul_precision=None, bcd_obj=None,
                 sparse_grid_format=None, k_sweep_batch=None,
                 k_sweep_merge=None):
        if process not in ("pyDNMF", "pyDNMFk"):
            raise ValueError("process should be either pyDNMFk or pyDNMF")
        # the JAX Runner's knobs (pydnmfk_tpu/runner.py:22-31) that the
        # port has no counterpart for, taken at the values it runs the same
        # as
        check_jax_only(
            matmul_precision=matmul_precision,
            sparse_grid_format=sparse_grid_format,
            k_sweep_batch=k_sweep_batch, k_sweep_merge=k_sweep_merge)
        self.init = init
        self.itr = itr
        self.norm = norm
        self.method = method
        self.verbose = verbose
        self.checkpoint = checkpoint
        self.timing_stats = timing_stats
        self.precision = precision
        self.perturbations = perturbations
        self.noise_var = noise_var
        self.sill_thr = sill_thr
        self.sampling = sampling
        self.process = process
        self.a_precision = a_precision
        self.seed = seed
        self.tol = tol
        self.ensemble_batch = ensemble_batch
        self.save_factors = save_factors
        self.prune = prune
        self.bcd_obj = bcd_obj
        self.hbm_budget = hbm_budget
        self.kl_chunk = kl_chunk
        self.seed_grid = seed_grid      # reference-MPI seeding (config.py)
        self.solve_checkpoint_every = solve_checkpoint_every
        self.device = torch.device(device)
        timing.enable(timing_stats)

    def run(self, grid: Sequence[int] = (1, 1), fpath="data/", ftype="mat",
            fname="A", results_path="results/", k_range=(1, 10), step_k=1,
            k=4):
        if len(grid) != 2 or len(k_range) != 2:
            raise ValueError("grid and k_range need to be length-2")
        check_device(self.device)
        ctx = (None if tuple(grid) == (1, 1)
               else mesh.initialize(*grid, self.device))
        nmf_cfg = NMFConfig(
            k=k, grid=tuple(grid), init=self.init, itr=self.itr,
            norm=self.norm,
            method=self.method, precision=self.precision,
            verbose=self.verbose, results_path=results_path,
            a_precision=self.a_precision, seed=self.seed, tol=self.tol,
            save_factors=self.save_factors, prune=self.prune,
            bcd_obj=self.bcd_obj, kl_chunk=self.kl_chunk,
            solve_checkpoint_every=self.solve_checkpoint_every)
        with timing.timed("read"):
            A = DataReader(fpath, fname, ftype, precision=self.precision,
                           pgrid=grid).read(ctx)

        results = {}
        if self.process == "pyDNMFk":
            cfg = NMFkConfig(
                nmf=nmf_cfg, start_k=k_range[0], end_k=k_range[1],
                step_k=step_k, perturbations=self.perturbations,
                noise_var=self.noise_var, sampling=self.sampling,
                sill_thr=self.sill_thr, checkpoint=self.checkpoint,
                results_path=results_path, fname=fname,
                ensemble_batch=self.ensemble_batch,
                hbm_budget=self.hbm_budget, seed_grid=self.seed_grid)
            results["nopt"] = NMFk(cfg, self.device, ctx).fit(A)
        else:
            W, H, err = NMF(nmf_cfg, self.device, ctx).fit(A)
            results.update(W=W, H=H, err=err)

        if self.timing_stats and mesh.is_proc0(ctx):
            os.makedirs(results_path, exist_ok=True)
            stats_path = os.path.join(results_path, "Timing_stats.csv")
            timing.save_csv(stats_path)
            try:
                from .utils.plotting import plot_timing_stats
                plot_timing_stats(stats_path, results_path)
            except Exception as e:       # best-effort, but never silent
                import warnings          # (runner.py:108-117)
                warnings.warn(f"timing plot failed: {e!r}")
        return results
