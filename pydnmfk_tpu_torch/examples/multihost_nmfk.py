"""The whole NMFk pipeline on a grid of processes, the equivalent of the
reference's ``mpirun -n 2 python main.py --process=pyDNMFk ...``
(main.py:45-88): the port of ``examples/multihost_nmfk.py``.

Start one copy per rank, under torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m pydnmfk_tpu_torch.examples.multihost_nmfk [--cpu]

or by hand, one per host or process, with process 0's address:

    python -m pydnmfk_tpu_torch.examples.multihost_nmfk \\
        --coord=10.0.0.1:9999 --nprocs=2 --pid=0      ... --pid=1

Each process is one rank of a p_r x p_c grid (default 2 x 1): it joins
the process group (``parallel/mesh.py::initialize``; NCCL where each rank
has its own card, else gloo), reads only its block of the file
(``DataReader.read(grid)``), and runs NMFk on the blocks with the grid's
collectives; rank 0 writes the results, the factors and the checkpoint
to a shared results directory, and every process returns the same nopt.
The sweep is the wtsi example's: FRO-MU from the nnsvd init, k = 1..8, 20
perturbations, 1000 iterations (nopt = 4 on wtsi.mat); a crash at any
point resumes from the per-k checkpoints.
"""
import argparse

from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig, initialize
from pydnmfk_tpu_torch.examples import DATA_PATH
from pydnmfk_tpu_torch.utils.io import DataReader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--coord", help="process 0's address host:port (not "
                                    "needed under torchrun)")
    ap.add_argument("--nprocs", type=int)
    ap.add_argument("--pid", type=int)
    ap.add_argument("--p_r", type=int, default=2)
    ap.add_argument("--p_c", type=int, default=1)
    ap.add_argument("--fpath", default=DATA_PATH)
    ap.add_argument("--fname", default="wtsi")
    ap.add_argument("--ftype", default="mat")
    ap.add_argument("--results", default="results_mh/")
    ap.add_argument("--itr", type=int, default=1000)
    ap.add_argument("--start_k", type=int, default=1)
    ap.add_argument("--end_k", type=int, default=8)
    ap.add_argument("--perturbations", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo; default: the CUDA card)")
    args = ap.parse_args(argv)

    grid = initialize(args.p_r, args.p_c, "cpu" if args.cpu else "cuda",
                      init_method=(f"tcp://{args.coord}" if args.coord
                                   else None),
                      rank=args.pid, world_size=args.nprocs)
    reader = DataReader(args.fpath, args.fname, args.ftype,
                        precision="float32", pgrid=(args.p_r, args.p_c))
    A = reader.read(grid)            # this rank's block alone
    cfg = NMFkConfig(
        nmf=NMFConfig(grid=(args.p_r, args.p_c), norm="fro", method="mu",
                      init="nnsvd", itr=args.itr),
        start_k=args.start_k, end_k=args.end_k,
        perturbations=args.perturbations, sill_thr=0.6,
        results_path=args.results, fname=args.fname, checkpoint=True)
    nopt = NMFk(cfg, grid=grid).fit(A)
    print(f"[process {grid.rank}] estimated k = {nopt}", flush=True)
    return nopt


if __name__ == "__main__":
    main()
