"""Synthetic dense 100000 x 1000 at k = 16 on the card, by HALS, BCD and
FRO-MU: the port of ``examples/large_scale.py`` (BASELINE.json config 3).
A = W H is built on the card from Gaussian-bump W columns and a seeded
uniform H; each method must reach a relative error below 0.05 in 200
iterations. The JAX example shards A over a mesh of its local devices;
here it is one card, a 1 x 1 grid.

Run: python -m pydnmfk_tpu_torch.examples.large_scale [m] [n] [k] [--cpu]
"""
import time

import numpy as np
import torch

from pydnmfk_tpu_torch import NMF, NMFConfig
from pydnmfk_tpu_torch.config import check_device
from pydnmfk_tpu_torch.examples import parse
from pydnmfk_tpu_torch.utils.data_generator import gauss_matrix


def main(m=100_000, n=1_000, k=16, device="cuda", itr=200,
         methods=("hals", "bcd", "mu"), max_err=0.05):
    device = check_device(torch.device(device))
    rng = np.random.RandomState(100)
    W_true = torch.from_numpy(gauss_matrix(m, k).astype(np.float32))
    H_true = torch.from_numpy(rng.rand(k, n).astype(np.float32))
    A = W_true.to(device) @ H_true.to(device)    # built on the device
    errs = {}
    for method in methods:
        cfg = NMFConfig(k=k, itr=itr, norm="fro", method=method,
                        precision="float32", seed=100)
        t0 = time.perf_counter()
        _, _, err = NMF(cfg, device).fit(A)
        dt = time.perf_counter() - t0
        print(f"{method:5s} {m}x{n} k={k} on {device}: rel_err={err:.2e} "
              f"({dt:.1f}s)", flush=True)
        if max_err is not None:
            assert err < max_err, f"{method} failed to converge: {err}"
        errs[method] = err
    return errs


if __name__ == "__main__":
    main(**parse(__doc__, ints=("m", "n", "k")))
