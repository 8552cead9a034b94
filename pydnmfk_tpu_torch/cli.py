"""Command-line entry point.

Port of ``pydnmfk_tpu/cli.py`` (reference main.py:13-88) with the same
flags: ``python -m pydnmfk_tpu_torch --process=pyDNMFk --p_r=1 --p_c=1 ...``.
It runs on the CUDA card, and raises if there is none; ``--cpu`` runs on the
CPU instead. Flags of features not yet ported raise
:class:`~pydnmfk_tpu_torch.config.NotPortedError` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .config import NotPortedError


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
    p.add_argument("--p_r", type=int, required=True, help="grid rows (1)")
    p.add_argument("--p_c", type=int, required=True, help="grid cols (1)")
    p.add_argument("--k", type=int, default=4, help="feature count")
    p.add_argument("--fpath", type=str, default="data/")
    p.add_argument("--ftype", type=str, default="mat", help="mat/npy/csv/txt/npz")
    p.add_argument("--fname", type=str, default="A_")
    p.add_argument("--init", type=str, default="rand", help="rand")
    p.add_argument("--itr", type=int, default=5000)
    p.add_argument("--norm", type=str, default="kl", help="KL/FRO")
    p.add_argument("--method", type=str, default="mu", help="MU")
    p.add_argument("--verbose", type=str2bool, default=False)
    p.add_argument("--results_path", type=str, default="results/")
    p.add_argument("--checkpoint", type=str2bool, default=False)
    p.add_argument("--timing_stats", type=str2bool, default=False)
    p.add_argument("--prune", type=str2bool, default=False)
    p.add_argument("--save_factors", type=str2bool, default=False)
    p.add_argument("--precision", type=str, default="float32",
                   help="float32/float64")
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
    p.add_argument("--multihost", type=str2bool, default=False)
    p.add_argument("--a_precision", type=str, default=None,
                   help="storage dtype for A only (bfloat16, or uint8: "
                        "A quantized to round(A/s), s = max(A)/255, the "
                        "returned H carries s); factors and accumulation "
                        "stay at --precision")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--seed_grid", type=str, default=None)
    p.add_argument("--seed", type=int, default=100,
                   help="seed of the init and perturbation generators")
    p.add_argument("--tol", type=float, default=0.0,
                   help="early stop when the relative error improves by "
                        "less than this between checks (0 = fixed --itr)")
    p.add_argument("--solve_checkpoint_every", type=int, default=0)
    p.add_argument("--ensemble_batch", type=int, default=0,
                   help="NMFk members per batched solve (0 = fit half the "
                        "free device memory)")
    p.add_argument("--matmul_precision", type=str, default=None)
    p.add_argument("--bcd_obj", type=str, default=None)
    p.add_argument("--sparse_grid_format", type=str, default=None)
    p.add_argument("--k_sweep_batch", type=str2bool, default=None)
    p.add_argument("--k_sweep_merge", type=str2bool, default=None)
    return p


def _reject_not_ported(args):
    checks = [
        (args.init != "rand", f"--init={args.init}", "queue 1 item 13"),
        (args.method.lower() != "mu", f"--method={args.method}",
         "queue 1 item 12"),
        (args.ftype == "folder", "--ftype=folder", "queue 1 item 9"),
        (args.prune, "--prune", "queue 1 item 8"),
        ((args.p_r, args.p_c) != (1, 1), f"--p_r={args.p_r} --p_c={args.p_c}",
         "queue 1 item 15"),
        (args.multihost, "--multihost", "queue 1 item 15"),
        (args.seed_grid is not None, "--seed_grid", "queue 1 item 6"),
        (args.solve_checkpoint_every > 0, "--solve_checkpoint_every",
         "queue 1 item 13"),
        (args.bcd_obj is not None, "--bcd_obj", "queue 1 item 12"),
        (args.sparse_grid_format not in (None, "auto"),
         "--sparse_grid_format", "queue 1 item 15"),
        (bool(args.k_sweep_batch), "--k_sweep_batch", "queue 1 item 10"),
        (bool(args.k_sweep_merge), "--k_sweep_merge", "queue 1 item 10"),
        (args.matmul_precision not in (None, "highest", "float32"),
         f"--matmul_precision={args.matmul_precision} (the port runs true "
         f"f32 products)", "queue 1 item 1"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotPortedError(what, item)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _reject_not_ported(args)
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
        device=device)
    results = runner.run(
        grid=[args.p_r, args.p_c], fpath=args.fpath, ftype=args.ftype,
        fname=args.fname, results_path=args.results_path,
        k_range=[args.start_k, args.end_k], step_k=args.step_k, k=args.k)
    if "nopt" in results:
        print("Rank estimated by NMFk =", results["nopt"])
    elif "err" in results:
        print("relative error =", results["err"])
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
