"""High-level object API.

Port of ``pydnmfk_tpu/runner.py`` (reference ``pyDNMFk_Runner``,
pyDNMFk/runner.py:12-176) on one device: construct with hyperparameters and
a device, call ``.run(fpath=..., ...)``; returns ``{"nopt": ...}`` for
process="pyDNMFk" or ``{"W", "H", "err"}`` for process="pyDNMF".
"""
from __future__ import annotations

import os
from typing import Sequence

from .config import NMFConfig, NMFkConfig, NotPortedError
from .models.nmf import NMF
from .models.nmfk import NMFk
from .utils import timing
from .utils.io import DataReader


class Runner:
    def __init__(self, init="rand", itr=5000, norm="kl", method="mu",
                 verbose=False, checkpoint=False, timing_stats=False,
                 precision="float32", perturbations=20, noise_var=0.015,
                 sill_thr=0.6, sampling="uniform", process="pyDNMF",
                 a_precision=None, seed=100, tol=0.0, ensemble_batch=0,
                 save_factors=False, device="cpu"):
        if process not in ("pyDNMF", "pyDNMFk"):
            raise ValueError("process should be either pyDNMFk or pyDNMF")
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
        self.device = device
        timing.enable(timing_stats)

    def run(self, grid: Sequence[int] = (1, 1), fpath="data/", ftype="mat",
            fname="A", results_path="results/", k_range=(1, 10), step_k=1,
            k=4):
        if len(grid) != 2 or len(k_range) != 2:
            raise ValueError("grid and k_range need to be length-2")
        if tuple(grid) != (1, 1):
            raise NotPortedError(f"grid={tuple(grid)} (device meshes)",
                                 "queue 1 item 15")
        nmf_cfg = NMFConfig(
            k=k, init=self.init, itr=self.itr, norm=self.norm,
            method=self.method, precision=self.precision,
            verbose=self.verbose, results_path=results_path,
            a_precision=self.a_precision, seed=self.seed, tol=self.tol,
            save_factors=self.save_factors)
        with timing.timed("read"):
            A = DataReader(fpath, fname, ftype, precision=self.precision).read()

        results = {}
        if self.process == "pyDNMFk":
            cfg = NMFkConfig(
                nmf=nmf_cfg, start_k=k_range[0], end_k=k_range[1],
                step_k=step_k, perturbations=self.perturbations,
                noise_var=self.noise_var, sampling=self.sampling,
                sill_thr=self.sill_thr, checkpoint=self.checkpoint,
                results_path=results_path, fname=fname,
                ensemble_batch=self.ensemble_batch)
            results["nopt"] = NMFk(cfg, self.device).fit(A)
        else:
            W, H, err = NMF(nmf_cfg, self.device).fit(A)
            results.update(W=W, H=H, err=err)

        if self.timing_stats:
            os.makedirs(results_path, exist_ok=True)
            timing.save_csv(os.path.join(results_path, "Timing_stats.csv"))
        return results
