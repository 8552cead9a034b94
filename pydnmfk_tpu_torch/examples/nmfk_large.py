"""NMFk at scale on one card, the ensemble batched as the card's memory
allows: the port of ``examples/nmfk_large.py``.

The whole k-selection runs on a synthetic 28800 x 19200 matrix of rank 8
with its members stored in bf16 (``a_precision="bfloat16"``, K1's bf16
kernel): ks 7..9, 10 perturbations, 400 iterations. The batch of members
is sized from the card's memory (``utils/memory.py``); the reference
solves them one by one (pyDNMFk.py:226-231). W has disjoint supports, row
block i loading on feature i only, so that k = 8 is unambiguous.

Run: python -m pydnmfk_tpu_torch.examples.nmfk_large [m] [n] [true_k] [--cpu]
(``--cpu`` takes a sixteenth of each dim, as the JAX example does)
"""
import time

import numpy as np
import torch

from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.config import check_device
from pydnmfk_tpu_torch.examples import parse


def main(m=28_800, n=19_200, true_k=8, device="cuda", itr=400,
         perturbations=10, results_path="results_large/"):
    device = check_device(torch.device(device))
    rng = np.random.RandomState(100)
    W_true = np.zeros((m, true_k), np.float32)
    block = m // true_k
    for j in range(true_k):
        rows = slice(j * block, (j + 1) * block if j < true_k - 1 else m)
        W_true[rows, j] = rng.rand(rows.stop - rows.start)
    H_true = (0.1 + rng.rand(true_k, n)).astype(np.float32)
    A = torch.from_numpy(W_true).to(device) @ torch.from_numpy(H_true).to(
        device)

    cfg = NMFkConfig(
        nmf=NMFConfig(itr=itr, norm="fro", method="mu", init="rand",
                      precision="float32", a_precision="bfloat16"),
        start_k=true_k - 1, end_k=true_k + 1, step_k=1,
        perturbations=perturbations, noise_var=0.02, sill_thr=0.6,
        results_path=results_path, fname="synth", checkpoint=False)
    t0 = time.perf_counter()
    model = NMFk(cfg, device)
    nopt = model.fit(A)
    dt = time.perf_counter() - t0
    print(f"{m}x{n} true_k={true_k}: estimated k = {nopt}  "
          f"(ensemble batch = {model.last_batch_size}/{perturbations}, "
          f"{dt:.1f}s)")
    assert nopt == true_k, f"expected {true_k}, got {nopt}"
    return nopt


if __name__ == "__main__":
    kw = parse(__doc__, ints=("m", "n", "true_k"))
    if kw["device"] == "cpu":
        kw["m"] = kw.get("m", 28_800) // 16
        kw["n"] = kw.get("n", 19_200) // 16
    main(**kw)
