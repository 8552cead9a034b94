#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s KL-MU NMFk sweep with ``use_fused=True`` on bf16
members (K3's tensor-core kernel, whose W'^T U' sums are f32 atomics) five
times on one GPU, three per-k runs and two merged K-padded ones, and prints
how far each run's per-k results lie from the first's, by k: the members'
errors (largest relative difference), L_err (largest difference over the
largest value), the silhouettes (absolute) and each run's least silhouette.

    python3 bench_torch/bf16_sweep_spread_probe.py

The input is the smoke's planted rank-4 ``generate_data(14400, 9600, 4)``,
k = 2..7, 10 perturbations, 400 iterations.
"""
import os
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    warnings.simplefilter("ignore")       # no matplotlib for the plots
    sys.path.insert(0, ROOT)
    import pydnmfk_tpu_torch as port
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    from pydnmfk_tpu_torch.utils.io import read_cluster_results
    X = generate_data(14400, 9600, 4)[2].astype(np.float32)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, merged in enumerate((None, None, None, True, True)):
            kw = (dict(k_sweep_batch=True, k_sweep_merge=True) if merged
                  else {})
            cfg = port.NMFkConfig(
                nmf=port.NMFConfig(norm="kl", itr=400, use_fused=True,
                                   a_precision="bfloat16"),
                start_k=2, end_k=7, perturbations=10,
                results_path=os.path.join(tmp, f"r{i}") + "/", fname="X",
                checkpoint=False, **kw)
            t = time.perf_counter()
            n = port.NMFk(cfg, "cuda").fit(X)
            runs.append({k: read_cluster_results(os.path.join(
                cfg.results_path, "X", str(k))) for k in range(2, 8)})
            print(i, "merged" if merged else "per-k", "nopt", n,
                  f"{time.perf_counter() - t:.1f} s", flush=True)
    ref = runs[0]
    for i, r in enumerate(runs[1:], 1):
        for k in range(2, 8):
            a, b = r[k], ref[k]
            mem = float(np.max(np.abs(a["ErrTol"] / b["ErrTol"] - 1)))
            L = float(np.max(np.abs(a["L_err"] - b["L_err"])
                             / np.abs(b["L_err"]).max()))
            sil = float(np.max(np.abs(a["clusterSilhouetteCoefficients"]
                                      - b["clusterSilhouetteCoefficients"])))
            print(f"run {i} vs 0, k={k}: members {mem:.2e}, L_err {L:.2e}, "
                  f"sils {sil:.2e}, least sil "
                  f"{float(np.min(a['clusterSilhouetteCoefficients'])):.3f} /"
                  f" {float(np.min(b['clusterSilhouetteCoefficients'])):.3f}",
                  flush=True)


if __name__ == "__main__":
    main()
