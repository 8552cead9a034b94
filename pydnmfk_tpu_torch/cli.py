"""Command-line entry point.

Port of ``pydnmfk_tpu/cli.py`` (reference main.py:13-88) with the same
flags: ``python -m pydnmfk_tpu_torch --process=pyDNMFk --p_r=1 --p_c=1 ...``.
It runs on the CUDA card, and raises if there is none; ``--cpu`` runs on the
CPU instead. A p_r x p_c grid runs one process per rank, as the reference
runs under ``mpirun``:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \
        -m pydnmfk_tpu_torch --p_r=2 --p_c=2 ...

(``--nnodes`` and a rendezvous spread the group over nodes: ``--multihost``
is then accepted and changes nothing). On a grid only rank 0 prints, and a
rank that raises prints its traceback and ends its process with exit code
1, which ends the others' collectives. Flags of features not yet ported
raise :class:`~pydnmfk_tpu_torch.config.NotPortedError` naming their
ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

import torch
import torch.distributed as dist

from .config import check_jax_only


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser():
    p = argparse.ArgumentParser(
        description="NMF/NMFk on one NVIDIA GPU "
                    "(python -m pydnmfk_tpu_torch --process=pyDNMFk "
                    "--p_r=1 --p_c=1 ...)")
    p.add_argument("--process", type=str, default="pyDNMF",
                   help="pyDNMF/pyDNMFk")
    # pyNMF block (reference main.py:13-31)
    p.add_argument("--p_r", type=int, required=True,
                   help="grid rows (one process per rank: torchrun)")
    p.add_argument("--p_c", type=int, required=True, help="grid cols")
    p.add_argument("--k", type=int, default=4, help="feature count")
    p.add_argument("--fpath", type=str, default="data/")
    p.add_argument("--ftype", type=str, default="mat",
                   help="mat/npy/csv/txt/npz/folder (folder: chunk files "
                        "{fname}{rank}.npy of the p_r x p_c blocks)")
    p.add_argument("--fname", type=str, default="A_")
    p.add_argument("--init", type=str, default="rand", help="rand/nnsvd")
    p.add_argument("--itr", type=int, default=5000)
    p.add_argument("--norm", type=str, default="kl", help="KL/FRO")
    p.add_argument("--method", type=str, default="mu", help="MU/HALS/BCD")
    p.add_argument("--verbose", type=str2bool, default=False)
    p.add_argument("--results_path", type=str, default="results/")
    p.add_argument("--checkpoint", type=str2bool, default=False)
    p.add_argument("--timing_stats", type=str2bool, default=False)
    p.add_argument("--prune", type=str2bool, default=False)
    p.add_argument("--save_factors", type=str2bool, default=False)
    p.add_argument("--precision", type=str, default="float32",
                   help="factor precision: bfloat16/float16/float32/float64")
    # pyNMFk block (reference main.py:34-42)
    p.add_argument("--perturbations", type=int, default=20)
    p.add_argument("--noise_var", type=float, default=0.015)
    p.add_argument("--start_k", type=int, default=1)
    p.add_argument("--end_k", type=int, default=10)
    p.add_argument("--step_k", type=int, default=1)
    p.add_argument("--sill_thr", type=float, default=0.6)
    p.add_argument("--sampling", type=str, default="uniform",
                   help="uniform/poisson")
    # flags of the JAX package
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="a grid over several nodes (torchrun --nnodes): "
                        "the same process group")
    p.add_argument("--a_precision", type=str, default=None,
                   help="storage dtype for A only (bfloat16, float16, or "
                        "uint8: A quantized to round(A/s), s = max(A)/255, "
                        "the returned H carries s); factors and accumulation "
                        "stay at --precision")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--seed_grid", type=str, default=None,
                   help="p_r,p_c: the reference's MPI seeding on that grid "
                        "(tiled noise and init; dense A)")
    p.add_argument("--seed", type=int, default=100,
                   help="seed of the init and perturbation generators")
    p.add_argument("--tol", type=float, default=0.0,
                   help="early stop when the relative error improves by "
                        "less than this between checks (0 = fixed --itr)")
    p.add_argument("--solve_checkpoint_every", type=int, default=0,
                   help="persist W, H every N iterations (multiple of 10) "
                        "to --results_path; a rerun resumes (pyDNMF)")
    p.add_argument("--ensemble_batch", type=int, default=0,
                   help="NMFk members per batched solve (0 = as many as "
                        "fit the memory budget)")
    p.add_argument("--hbm_budget", type=int, default=0,
                   help="device memory budget in bytes that sizes the NMFk "
                        "batches (0 = PYDNMFK_HBM_BUDGET, else half the "
                        "free device memory)")
    p.add_argument("--kl_chunk", type=int, default=0,
                   help="rows per slab of the plain KL products' ratio "
                        "(0 = automatic)")
    p.add_argument("--matmul_precision", type=str, default=None)
    p.add_argument("--bcd_obj", type=str, default=None,
                   help="BCD objective: gram (default) or residual")
    p.add_argument("--sparse_grid_format", type=str, default=None,
                   help="a sparse A's format on a grid: auto (the dual "
                        "ELL on the card where every block packs, else the "
                        "triplet), ell or triplet")
    p.add_argument("--k_sweep_batch", type=str2bool, default=None,
                   help="true: the NMFk sweep solves every k's members at "
                        "K = end_k columns under a column mask (the per-k "
                        "sweep's results up to summation order); default: "
                        "the per-k sweep")
    p.add_argument("--k_sweep_merge", type=str2bool, default=None,
                   help="under --k_sweep_batch=true: members of several ks "
                        "in one batched solve (default: on when more than "
                        "one k is swept)")
    return p


def _jax_only_knobs(args):
    """The JAX Runner's knobs among the flags that the port has no
    counterpart for (``config.py::JAX_ONLY``), as Runner takes them."""
    return dict(matmul_precision=args.matmul_precision)


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_jax_only(**_jax_only_knobs(args))
    if (args.p_r, args.p_c) == (1, 1):
        return _run(args)
    try:
        return _run(args)
    except BaseException:
        if not dist.is_initialized():
            raise
        # one rank's failure must not leave the others waiting inside a
        # collective: end this process, which ends theirs
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _run(args):
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
        # precision policy: true f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")

    from .runner import Runner
    runner = Runner(
        init=args.init, itr=args.itr, norm=args.norm, method=args.method,
        verbose=args.verbose, checkpoint=args.checkpoint,
        timing_stats=args.timing_stats, precision=args.precision,
        perturbations=args.perturbations, noise_var=args.noise_var,
        sill_thr=args.sill_thr, sampling=args.sampling, process=args.process,
        a_precision=args.a_precision, seed=args.seed, tol=args.tol,
        ensemble_batch=args.ensemble_batch, save_factors=args.save_factors,
        hbm_budget=args.hbm_budget, kl_chunk=args.kl_chunk,
        device=device, prune=args.prune, bcd_obj=args.bcd_obj,
        seed_grid=(tuple(int(x) for x in args.seed_grid.split(","))
                   if args.seed_grid else None),
        solve_checkpoint_every=args.solve_checkpoint_every,
        sparse_grid_format=args.sparse_grid_format,
        k_sweep_batch=args.k_sweep_batch, k_sweep_merge=args.k_sweep_merge,
        **_jax_only_knobs(args))
    results = runner.run(
        grid=[args.p_r, args.p_c], fpath=args.fpath, ftype=args.ftype,
        fname=args.fname, results_path=args.results_path,
        k_range=[args.start_k, args.end_k], step_k=args.step_k, k=args.k)
    grid = (args.p_r, args.p_c) != (1, 1)
    if not grid or dist.get_rank() == 0:
        if "nopt" in results:
            print("Rank estimated by NMFk =", results["nopt"])
        elif "err" in results:
            print("relative error =", results["err"])
    if grid:
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
