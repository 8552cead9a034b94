#!/usr/bin/env python3
"""Runs the NMFk sweep with HALS, NNSVD init and pruning on one GPU over
several seeds and ensemble sizes, and prints how stable each k's clusters
were and which k the Wilcoxon walk chose.

    python3 bench_torch/nnsvd_sweep_probe.py [--m M] [--n N] \\
        [--seeds 100 101 ...] [--perturbations 10 20] [--init nnsvd rand] \\
        [--method hals|bcd] [--no-prune]

The input is ``chip_smoke.py``'s prune sweep matrix: the planted rank-4
``generate_data(m, n, 4)`` with every 97th row and every 89th column set
to zero (``--no-prune``: the planted matrix as it is, no pruning). The
sweep runs k = 2..7, 400 iterations of ``--method`` (FRO), through the
library (``NMFk``), with each (init, perturbations, seed). It prints one
JSON line a run: the chosen k, its seconds, the minimum silhouette of
every k and the Wilcoxon p-values. NNSVD init gives the members the same
start up to their perturbation, so the ensemble's spread, which the
silhouettes measure, comes from the noise alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4800)
    p.add_argument("--n", type=int, default=3200)
    p.add_argument("--seeds", type=int, nargs="+", default=[100])
    p.add_argument("--perturbations", type=int, nargs="+", default=[10])
    p.add_argument("--init", nargs="+", default=["nnsvd"])
    p.add_argument("--itr", type=int, default=400)
    p.add_argument("--method", default="hals", choices=("hals", "bcd"))
    p.add_argument("--no-prune", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("nnsvd_sweep_probe: no CUDA device")
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, X = generate_data(args.m, args.n, 4)
    X = X.astype(np.float32)
    if not args.no_prune:
        X[::97] = 0.0
        X[:, ::89] = 0.0
    device = torch.cuda.get_device_name(0)
    for init in args.init:
        for pert in args.perturbations:
            for seed in args.seeds:
                with tempfile.TemporaryDirectory() as tmp:
                    cfg = NMFkConfig(
                        nmf=NMFConfig(norm="fro", method=args.method,
                                      init=init, prune=not args.no_prune,
                                      itr=args.itr, seed=seed),
                        start_k=2, end_k=7, perturbations=pert,
                        results_path=tmp + "/", fname="P", checkpoint=False)
                    model = NMFk(cfg, "cuda")
                    t0 = time.perf_counter()
                    nopt = model.fit(X)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                sil = {k: round(float(np.min(
                    s["clusterSilhouetteCoefficients"])), 3)
                    for k, s in model.per_k_stats.items()}
                print(json.dumps({
                    "shape": [args.m, args.n], "method": args.method,
                    "prune": not args.no_prune, "init": init,
                    "perturbations": pert, "seed": seed, "nopt": nopt,
                    "seconds": round(secs, 3), "min_silhouette": sil,
                    "pvalues": [float(v) for v in model.pvalues],
                    "device": device}), flush=True)


if __name__ == "__main__":
    main()
