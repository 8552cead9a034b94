"""The sparse-input workflow (beyond the reference, which is dense-only), on
the card: the port of ``examples/sparse_npz.py``.

swim.mat (35 % natural zeros) is saved as a scipy.sparse ``.npz`` and
factorized through the Runner with ``ftype='npz'`` (k = 4, FRO-MU, 200
iterations; the error of the dense golden run, 0.60-0.62), and the sparse
NMFk pipeline (KL-MU) picks the planted k = 3 of an 80 x 60 matrix. The
CPU runs both on the nnz triplet; on the card the format policy
(``ops/sparse.py::densify_for_backend``) picks the triplet's format by
its density and shape. On that matrix the choice depends on the draws
(k = 3's least silhouette lies near the 0.6 gate, in the JAX package
too): ``nmfk_expected`` is the JAX example's answer for its draws.

Run: python -m pydnmfk_tpu_torch.examples.sparse_npz [--data_path DIR] [--cpu]
"""
import os
import tempfile

import numpy as np
import torch
from scipy import sparse as sp
from scipy.io import loadmat

from pydnmfk_tpu_torch import NMFConfig, NMFkConfig
from pydnmfk_tpu_torch.examples import DATA_PATH, parse
from pydnmfk_tpu_torch.models.nmfk import NMFk
from pydnmfk_tpu_torch.ops.sparse import from_coo
from pydnmfk_tpu_torch.runner import Runner


def planted_sparse(m=80, n=60, ktrue=3, seed=7):
    """The planted rank-``ktrue`` m x n matrix (Gaussian-bump W, uniform H
    from 0.1), half its entries set to zero, as a dense numpy array."""
    rng = np.random.default_rng(seed)
    W = np.zeros((m, ktrue))
    for i in range(ktrue):
        c = (i + 0.5) * m / ktrue
        W[:, i] = np.exp(-0.5 * ((np.arange(m) - c) / (0.06 * m)) ** 2)
    A = (W @ (rng.random((ktrue, n)) + 0.1)).astype(np.float32)
    A *= rng.random((m, n)) < 0.5
    return A


def main(data_path=DATA_PATH, device="cuda", itr=200, err_range=(0.60, 0.62),
         nmfk_itr=300, ks=(2, 5), perturbations=6, nmfk_expected=3):
    with tempfile.TemporaryDirectory() as td:
        # --- one sparse NMF of the sample data through the Runner --------
        X = loadmat(os.path.join(data_path, "swim.mat"))["X"].astype(
            np.float32)
        sp.save_npz(os.path.join(td, "swim_sp.npz"), sp.csr_matrix(X))
        r = Runner(itr=itr, norm="fro", method="mu", init="rand",
                   process="pyDNMF", device=device)
        out = r.run(grid=[1, 1], fpath=td + "/", ftype="npz",
                    fname="swim_sp", results_path=os.path.join(td, "res"),
                    k=4)
        print(f"sparse swim k=4 fro/mu: err = {out['err']:.4f}")
        if err_range is not None:      # the dense golden run's error
            assert err_range[0] < out["err"] < err_range[1], out["err"]

        # --- sparse NMFk selects the planted k ---------------------------
        A = planted_sparse()
        rows, cols = np.nonzero(A)
        Asp = from_coo(torch.from_numpy(rows.astype(np.int32)),
                       torch.from_numpy(cols.astype(np.int32)),
                       torch.from_numpy(A[rows, cols]), A.shape)
        cfg = NMFkConfig(nmf=NMFConfig(k=0, norm="kl", method="mu",
                                       itr=nmfk_itr, init="rand", seed=42),
                         start_k=ks[0], end_k=ks[1],
                         perturbations=perturbations, noise_var=0.03,
                         sill_thr=0.6, results_path=os.path.join(td, "nmfk"),
                         fname="sp", checkpoint=False)
        model = NMFk(cfg, device)
        nopt = model.fit(Asp)
        print(f"sparse NMFk (kl/mu) selected k = {nopt}")
        if nmfk_expected is not None:
            assert nopt == nmfk_expected, (f"expected {nmfk_expected}, got "
                                           f"{nopt}")
    return {"err": out["err"], "nopt": nopt,
            "per_k_stats": model.per_k_stats}


if __name__ == "__main__":
    main(**parse(__doc__, data=True))
