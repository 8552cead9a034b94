"""NMFk k-selection on swim.mat (1024 x 256 uint8) on the card: the port of
``examples/nmfk_swim.py``, itself the reference's
examples/dist_pynmfk_2d_Swim.py (there on a 2 x 2 MPI grid: KL-MU, rand
init, 20 perturbations, noise 0.016, 5000 iterations, k = 14..18).

``seed_grid=(2, 2)`` draws each member as the reference's four ranks do,
each with the same numpy seed: the noise tiled 2 x 2 and the rand init
tiled four times (``models/sampler.py``), the regime whose statistics the
reference's answer comes from.

Golden answer: nopt == 16.

Run: python -m pydnmfk_tpu_torch.examples.nmfk_swim [--data_path DIR] [--cpu]
"""
from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.examples import DATA_PATH, parse
from pydnmfk_tpu_torch.utils.io import DataReader


def main(data_path=DATA_PATH, results_path="results/", itr=5000,
         seed_grid=(2, 2), device="cuda", ks=(14, 18), perturbations=20,
         expected=16):
    A = DataReader(data_path, "swim", "mat", precision="float32").read_global()
    cfg = NMFkConfig(
        nmf=NMFConfig(itr=itr, norm="kl", method="mu", init="rand",
                      precision="float32", verbose=True),
        start_k=ks[0], end_k=ks[1], step_k=1,
        perturbations=perturbations, noise_var=0.016, sampling="uniform",
        sill_thr=0.6, results_path=results_path, fname="swim",
        seed_grid=seed_grid)
    nopt = NMFk(cfg, device).fit(A)
    print("Estimated k =", nopt)
    if expected is not None:
        assert nopt == expected, (f"swim k-selection regressed: got {nopt}, "
                                  f"expected {expected}")
    return nopt


if __name__ == "__main__":
    main(**parse(__doc__, data=True))
