#!/usr/bin/env python3
"""Which k the 1x1 NMFk sweeps at the settings of ``chip_smoke.py``'s
phases 7-9 choose at a given number of iterations (and members), on one
GPU: the planted rank-4 14400 x 9600 matrix (FRO-MU and KL-MU) and the
planted topic 200000 x 50000 ``.npz`` (FRO-MU and KL-MU), ks 3..5, drawn
as the smoke draws them.

    python3 bench_torch/grid_sweep_itr_probe.py ITR[,MEMBERS] ...

For each ITR[,MEMBERS] (members 10 unless given) it prints one line a
sweep: input, norm, iterations, members, the k chosen and the seconds
(the first sweep's include the kernels' build). The phases' grid sweeps
hold their per-k statistics to a 1x1 sweep at the same settings, so an
iteration count at which these choose 4 on every input is one the phases
can take (on an H100 80GB HBM3 at 700 W: 150 and 200 chose 4 everywhere,
100 and 120 chose 3 on the planted KL-MU sweep, 6 members at 200
iterations 3 on the topic KL-MU sweep).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    if not torch.cuda.is_available():
        sys.exit("grid_sweep_itr_probe: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from scipy import sparse as sp
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_topic_sparse)
    from pydnmfk_tpu_torch.utils.io import DataReader

    settings = [tuple(int(x) for x in arg.split(",")) for arg in sys.argv[1:]]
    dev = torch.device("cuda")
    _, _, X = generate_data(**chip_smoke.PLANTED)
    r, c, v, shape = generate_topic_sparse(**chip_smoke.TOPIC, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        sp.save_npz(os.path.join(tmp, "T.npz"),
                    sp.csr_matrix((v, (r, c)), shape=shape), compressed=False)
        inputs = {"X": DataReader(tmp + "/", "X", "npy").read(),
                  "T": DataReader(tmp + "/", "T", "npz").read()}
        ks = chip_smoke.GRID_SWEEP_KS
        for itr, *rest in settings:
            members = rest[0] if rest else 10
            for fname, norm in (("X", "fro"), ("X", "kl"), ("T", "fro"),
                                ("T", "kl")):
                cfg = NMFkConfig(
                    nmf=NMFConfig(norm=norm, itr=itr), start_k=ks[0],
                    end_k=ks[-1], perturbations=members, checkpoint=False,
                    results_path=os.path.join(
                        tmp, f"{fname}_{norm}_{itr}_{members}") + "/",
                    fname=fname)
                t0 = time.perf_counter()
                nopt = NMFk(cfg, dev).fit(inputs[fname])
                torch.cuda.synchronize()
                print(f"{fname} {norm} itr={itr} members={members}: nopt "
                      f"{nopt}, {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
