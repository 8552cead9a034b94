#!/usr/bin/env python3
"""Runs the sparse NMFk of ``pydnmfk_tpu_torch/examples/sparse_npz.py``
(KL-MU on its planted 80 x 60, k = 2..5, 6 perturbations, 300 iterations)
on the card over several seeds, then solves each run's members again on
the CPU, and prints which k each chose and every k's least silhouette.

    python3 bench_torch/sparse_npz_seed_probe.py [--seeds 36 37 ...]

Where the card's choice and the CPU's choice on the same members agree,
the choice is the draws' (the card's generator draws other members than
the CPU's for the same seed), not the kernels'.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(range(36, 52)))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import pydnmfk_tpu_torch as port
    from pydnmfk_tpu_torch.examples.sparse_npz import planted_sparse
    from pydnmfk_tpu_torch.models import nmf as nmf_mod
    from pydnmfk_tpu_torch.ops.sparse import from_coo
    warnings.simplefilter("ignore")       # no matplotlib for the plots
    A = planted_sparse()
    r, c = np.nonzero(A)
    T = from_coo(torch.from_numpy(r.astype(np.int32)),
                 torch.from_numpy(c.astype(np.int32)),
                 torch.from_numpy(A[r, c]), A.shape)
    real = nmf_mod.solve

    def least(stats):
        return {k: round(float(np.min(st["clusterSilhouetteCoefficients"])),
                         4) for k, st in sorted(stats.items())}

    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            caught = {}

            def spy(A_ens, W0, H0, *a, **kw):
                if W0.dim() == 3:          # an ensemble's batched solve
                    caught[W0.shape[-1]] = (A_ens.cpu(), W0.cpu(), H0.cpu())
                return real(A_ens, W0, H0, *a, **kw)

            def config(where):
                return port.NMFkConfig(
                    nmf=port.NMFConfig(k=0, norm="kl", method="mu", itr=300,
                                       init="rand", seed=seed),
                    start_k=2, end_k=5, perturbations=6, noise_var=0.03,
                    sill_thr=0.6, results_path=os.path.join(tmp, where),
                    fname="sp", checkpoint=False)

            nmf_mod.solve = spy
            try:
                card = port.NMFk(config("card"), "cuda")
                n_card = card.fit(T)
            finally:
                nmf_mod.solve = real
            cpu = port.NMFk(config("cpu"), "cpu")
            os.makedirs(cpu.results_path, exist_ok=True)
            At = torch.from_numpy(A)
            for k in sorted(caught):
                cpu.pynmfk_per_k(At, k, ensemble=cpu._solve_ensemble(
                    At, k, members=caught[k]))
            print(seed, "card", n_card, least(card.per_k_stats),
                  "| its members on the cpu", cpu.pvalue_analysis(),
                  least(cpu.per_k_stats), flush=True)


if __name__ == "__main__":
    main()
