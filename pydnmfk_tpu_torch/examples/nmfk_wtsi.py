"""NMFk k-selection on wtsi.mat (96 x 21 uint16) on the card: the port of
``examples/nmfk_wtsi.py``, itself the reference's
examples/dist_pynmfk_1d_wtsi.py (there on a 4 x 1 MPI grid). FRO-MU from
the nnsvd init, k = 1..8, 20 perturbations, 1000 iterations.

Golden answer: nopt == 4.

Run: python -m pydnmfk_tpu_torch.examples.nmfk_wtsi [--data_path DIR] [--cpu]
"""
from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.examples import DATA_PATH, parse
from pydnmfk_tpu_torch.utils.io import DataReader


def main(data_path=DATA_PATH, results_path="results/", device="cuda",
         itr=1000, ks=(1, 8), perturbations=20, expected=4):
    A = DataReader(data_path, "wtsi", "mat", precision="float32").read_global()
    cfg = NMFkConfig(
        nmf=NMFConfig(itr=itr, norm="fro", method="mu", init="nnsvd",
                      precision="float32", verbose=True),
        start_k=ks[0], end_k=ks[1], step_k=1,
        perturbations=perturbations, noise_var=0.015, sampling="uniform",
        sill_thr=0.6, results_path=results_path, fname="wtsi")
    nopt = NMFk(cfg, device).fit(A)
    print("Estimated k =", nopt)
    if expected is not None:
        assert nopt == expected, f"wtsi: got {nopt}, expected {expected}"
    return nopt


if __name__ == "__main__":
    main(**parse(__doc__, data=True))
