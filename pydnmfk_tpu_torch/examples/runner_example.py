"""The Runner on wtsi.mat on the card: the port of
``examples/runner_example.py`` (the reference's examples/runner_example.py).
The Runner owns the hyperparameters; ``run`` reads the data and sweeps
k = 1..8 (FRO-MU from the nnsvd init, 20 perturbations, 1000
iterations).

Golden answer: nopt == 4.

Run: python -m pydnmfk_tpu_torch.examples.runner_example [--data_path DIR]
     [--cpu]
"""
from pydnmfk_tpu_torch import Runner
from pydnmfk_tpu_torch.examples import DATA_PATH, parse


def main(data_path=DATA_PATH, results_path="results/", device="cuda",
         itr=1000, k_range=(1, 8), perturbations=20, expected=4):
    runner = Runner(init="nnsvd", itr=itr, norm="fro", method="mu",
                    verbose=True, perturbations=perturbations,
                    noise_var=0.015, sill_thr=0.6, process="pyDNMFk",
                    device=device)
    results = runner.run(grid=[1, 1], fpath=data_path, ftype="mat",
                         fname="wtsi", results_path=results_path,
                         k_range=list(k_range), step_k=1)
    print(results)
    if expected is not None:
        assert results["nopt"] == expected, (
            f"wtsi: got {results['nopt']}, expected {expected}")
    return results


if __name__ == "__main__":
    main(**parse(__doc__, data=True))
