"""Whole NMFk sweeps through ``pydnmfk_tpu_torch.NMFk(cfg).fit``.

A is the planted matrix drawn once from the run's seed; each sweep takes
its own seed, drawn from the run's, so that its members and init factors
are its own. A sweep writes its results into a fresh directory under
``$TMPDIR`` (the program's checkpoint would otherwise resume from the last
sweep's results); the directories go once the run has read what it
checks.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import gen, work
from ..reference import compare, nmf as ref, nmfk as refk


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.ks = list(range(cfg["start_k"], cfg["end_k"] + 1))
        self.sweeps = []     # (seed, results directory, nopt, stats by k)
        self.base = None

    def setup(self):
        import pydnmfk_tpu_torch as port
        from pydnmfk_tpu_torch.utils import timing
        torch.backends.cuda.matmul.allow_tf32 = False
        self.port, self.timing = port, timing
        self.base = tempfile.mkdtemp(prefix="nmf_bench_")
        cfg = self.cfg
        self.A = gen.planted_gauss(cfg["m"], cfg["n"], cfg["planted_k"],
                                   self.seed, self.device)
        # every shape of the sweep, its clustering, refit and writers
        self._sweep(gen.derived_seed(self.seed, "warmup"),
                    itr=self.traffic["warmup_itr"], keep=False)

    def _sweep(self, seed, itr=None, keep=True):
        cfg, t = self.cfg, self.traffic
        port = self.port
        out = tempfile.mkdtemp(dir=self.base)
        ncfg = port.NMFConfig(itr=itr or cfg["itr"], init=cfg["init"],
                              norm=t["norm"], method=t["method"],
                              precision=cfg["precision"], seed=seed)
        kcfg = port.NMFkConfig(
            nmf=ncfg, start_k=cfg["start_k"], end_k=cfg["end_k"],
            perturbations=cfg["perturbations"], noise_var=cfg["noise_var"],
            sampling=cfg["sampling"], sill_thr=cfg["sill_thr"],
            results_path=out + os.sep, fname="A",
            k_sweep_batch=cfg["k_sweep_batch"])
        model = port.NMFk(kcfg, device=self.device)
        nopt = model.fit(self.A)
        if not keep:
            shutil.rmtree(out, ignore_errors=True)
            return
        stats = {k: {"recon_err": np.array(s["recon_err"]),
                     "sils": np.array(s["clusterSilhouetteCoefficients"]),
                     "L_errDist": float(s["L_errDist"]),
                     "L_err": np.array(s["L_err"])}
                 for k, s in model.per_k_stats.items()}
        self.sweeps.append((seed, out, nopt, stats))

    def run(self, seconds: float, tracing: bool = False) -> dict:
        """Sweeps until ``seconds`` have passed; the window ends with the
        last sweep begun before then. In a traced run the program's stage
        timers are on (they synchronize the card) and read per sweep."""
        timing = self.timing
        timing.enable(tracing)
        spans = []
        t0 = time.perf_counter()
        while True:
            timing.reset()
            self._sweep(gen.derived_seed(self.seed, "sweep",
                                         len(self.sweeps)))
            spans.append(dict(timing.TIMINGS))
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        timing.enable(False)
        n, cfg = len(self.sweeps), self.cfg
        rec = {"units": n, "sweeps": n, "window_s": window,
               "least_s": n * work.sweep_s(
                   self.traffic["norm"], cfg["m"], cfg["n"], self.ks,
                   cfg["perturbations"], cfg["itr"], cfg["precision"])}
        if tracing:
            rec["spans"] = {name: sum(s.get(name, 0.0) for s in spans) / n
                            for name in set().union(*spans)}
        return rec

    def release(self):
        """Frees the program's state; reads the checked sweep's saved
        factors and removes every sweep's directory."""
        self.port = None
        rng = np.random.default_rng(gen.derived_seed(self.seed, "sample"))
        self.checked = int(rng.integers(len(self.sweeps)))
        _, out, _, stats = self.sweeps[self.checked]
        for k in self.ks:
            kdir = os.path.join(out, "A", str(k))
            stats[k]["W"] = np.load(os.path.join(kdir, "W_reg_factors",
                                                 "W.npy"))
            stats[k]["H"] = np.load(os.path.join(kdir, "H_reg_factors",
                                                 "H.npy"))
        for _, out, _, _ in self.sweeps:
            shutil.rmtree(out, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm) -> tuple:
        """The reference's statistics of the checked sweep at every k and
        its choice of k."""
        seed = self.sweeps[self.checked][0]
        ref_stats = {k: refk.per_k(self.A, k, self.cfg, seed,
                                   self.traffic["norm"], mm)
                     for k in self.ks}
        nopt = refk.choose_k(self.ks, [ref_stats[k]["L_err"]
                                       for k in self.ks],
                             [ref_stats[k]["sils"] for k in self.ks],
                             self.cfg["sill_thr"])
        return ref_stats, nopt

    def close(self):
        if self.base:
            shutil.rmtree(self.base, ignore_errors=True)
            self.base = None

    def check(self) -> list:
        """The readings of the checked sweep against the reference
        (float32)."""
        _, _, nopt, stats = self.sweeps[self.checked]
        ref_stats, ref_nopt = self.reference(ref.Products(tf32=False))
        out = self._numbers(stats, ref_stats)
        out["k_diff"] = float(abs(nopt - ref_nopt))
        return [out]

    def control(self) -> list:
        """The reference in TF32 against the reference in float32, on the
        checked sweep."""
        got, got_nopt = self.reference(ref.Products(tf32=True))
        want, want_nopt = self.reference(ref.Products(tf32=False))
        out = self._numbers(got, want)
        out["k_diff"] = float(abs(got_nopt - want_nopt))
        return [out]

    def _numbers(self, got, want) -> dict:
        """Each number's worst over the ks, and each number at the sweep's
        first k alone (``first_k.<name>``). At the planted rank and above
        it a member's 400-iteration fit is not converged or not unique:
        rounding alone moves a member's error by some tenths of a percent
        there, so that sound runs' widest gaps at those ks can read as far
        from the reference as the control's; at the first k every fit is
        unique and the gaps are rounding."""
        self.by_k = {k: compare.sweep_numbers(got[k], want[k])
                     for k in self.ks}
        out = compare.worst(self.by_k.values())
        out.update((f"first_k.{name}", v)
                   for name, v in self.by_k[self.ks[0]].items())
        return out
