"""uint8 storage of A on the reference's own sample data, on the card: the
port of ``examples/quantized_swim.py``.

swim.mat is uint8 with max 255, so ``a_precision="uint8"`` stores it
exactly (scale s = 1) in a quarter of the f32 bytes, and the solve runs
K1's uint8 kernel; the factorization matches the f32 run's (FRO-MU, k = 4,
200 iterations) to within 0.01 in relative error, and the returned factors
are at A's scale (s folded into H).

Run: python -m pydnmfk_tpu_torch.examples.quantized_swim [--data_path DIR]
     [--cpu]
"""
import os

import numpy as np
from scipy.io import loadmat

from pydnmfk_tpu_torch import NMF, NMFConfig
from pydnmfk_tpu_torch.examples import DATA_PATH, parse
from pydnmfk_tpu_torch.utils.io import to_numpy


def main(data_path=DATA_PATH, device="cuda", itr=200, tol=0.01):
    X = loadmat(os.path.join(data_path, "swim.mat"))["X"].astype(np.float32)
    cfg = NMFConfig(k=4, norm="fro", method="mu", itr=itr, init="rand")
    _, _, e32 = NMF(cfg, device).fit(X)
    W8, H8, e8 = NMF(cfg.replace(a_precision="uint8"), device).fit(X)
    print(f"f32:   err = {e32:.6f}")
    print(f"uint8: err = {e8:.6f}")
    assert abs(e8 - e32) < tol, f"uint8 {e8} against f32 {e32}"
    # the returned factors are at A's scale (s folded into H)
    rel = (np.linalg.norm(to_numpy(W8) @ to_numpy(H8) - X)
           / np.linalg.norm(X))
    assert abs(rel - e8) < tol, f"||X - W8 H8|| / ||X|| = {rel}, err {e8}"
    print("uint8 storage reproduces the f32 factorization; OK")
    return e32, e8


if __name__ == "__main__":
    main(**parse(__doc__, data=True))
