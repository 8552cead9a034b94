#!/usr/bin/env python3
"""Smoke run of pydnmfk_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. builds the CUDA kernels from ``pydnmfk_tpu_torch/csrc`` with nvcc;
2. checks each kernel against its plain PyTorch version at the shapes the
   main path gives it (57600 x 38400, k = 32: the reference's
   strong-scaling geometry; and a 10-member 14400 x 9600, k = 8 ensemble),
   times both with CUDA events, and checks NMF.fit on the card against the
   CPU path on a small input;
3. drives the main path with every launch counter at zero: NMF.fit for 10
   FRO-MU and 10 KL-MU iterations at 57600 x 38400, k = 32, then the NMFk
   sweep through the CLI entry point on a planted rank-4 14400 x 9600 matrix
   (k = 2..7, 10 perturbations, 400 iterations), FRO-MU and KL-MU, which
   must choose k = 4;
4. prints the card's name and power limit, one JSON line of kernels, and as
   its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero when there is no CUDA device or no package beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
M, N, K = 57600, 38400, 32               # reference strong-scaling geometry
ENS, EM, EN, EK = 10, 14400, 9600, 8     # ensemble kernel check
PLANTED = dict(m=14400, n=9600, k=4)     # NMFk sweep input
SWEEP = ["--start_k=2", "--end_k=7", "--perturbations=10", "--itr=400"]
# kernel vs plain, max |difference| / max |plain| over all outputs: f32
# sums taken in another order (and, for K1's W'^T A, with atomics in an
# order that changes from run to run); a bf16 A also rounds W' to bf16 where
# kernel and plain W' may differ in the last f32 bit
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def compare(kernel_out, plain_out):
    """(max abs error, max relative error) over matching outputs."""
    if isinstance(kernel_out, torch.Tensor):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    abs_err = rel_err = 0.0
    for a, b in zip(kernel_out, plain_out):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
        d = float((a.double() - b.double()).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.double().abs().max()), 1e-30))
    return abs_err, rel_err


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch import NMF, NMFConfig, cli
    from pydnmfk_tpu_torch.models.nmf import init_factors_rand
    from pydnmfk_tpu_torch.ops import cuda_lib, fused_mu, kl, linalg
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.data_generator import generate_data
    from pydnmfk_tpu_torch.utils.io import RESULT_DATASETS, read_cluster_results

    torch.backends.cuda.matmul.allow_tf32 = False     # true-f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_lib.build_all()
    print(f"[build] {len(libs)} kernel libraries with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(os.path.relpath(p, ROOT) for p in libs), flush=True)

    # -- 2. kernels against their plain versions ------------------------
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    eps = float(torch.finfo(torch.float32).eps)
    rows = {}

    def kernel_case(name, label, kernel, plain, tol):
        k_out, p_out = kernel(), plain()
        abs_err, rel_err = compare(k_out, p_out)
        del k_out, p_out
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        print(f"[kernel] {name} {label}: max rel err {rel_err:.3e} "
              f"(tol {tol:g}), max abs err {abs_err:.3e}, kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        check(rel_err <= tol, f"{name} {label} disagrees with its plain "
                              f"version: {rel_err:.3e} > {tol:g}")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        row.setdefault("ms", ms)              # the first case is the headline
        row.setdefault("plain_ms", plain_ms)

    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)                     # planted rank K
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    HHT = linalg.gram_t(H)
    shape = f"{M}x{N} k={K}"
    kernel_case("K1 fused_mu_fro", f"f32 {shape}",
                lambda: fused_mu.fused_w_pass(A, W, H, HHT, eps),
                lambda: fused_mu.fused_w_pass_plain(A, W, H, HHT, eps),
                TOL[torch.float32])
    A16 = A.to(torch.bfloat16)
    kernel_case("K1 fused_mu_fro", f"bf16-A {shape}",
                lambda: fused_mu.fused_w_pass(A16, W, H, HHT, eps),
                lambda: fused_mu.fused_w_pass_plain(A16, W, H, HHT, eps),
                TOL[torch.bfloat16])
    del A16
    chunk = linalg.error_chunk_rows(M, N)
    kernel_case("K2a kl_uht", f"f32 {shape}",
                lambda: kl.kl_uht(A, W, H, eps),
                lambda: kl.kl_uht_plain(A, W, H, eps, chunk),
                TOL[torch.float32])
    kernel_case("K2b kl_wtu", f"f32 {shape}",
                lambda: kl.kl_wtu(A, W, H, eps),
                lambda: kl.kl_wtu_plain(A, W, H, eps, chunk),
                TOL[torch.float32])
    del W, H, HHT
    torch.cuda.empty_cache()
    Ae = torch.rand((ENS, EM, EN), generator=gen, device=dev)
    We = torch.rand((ENS, EM, EK), generator=gen, device=dev)
    He = torch.rand((ENS, EK, EN), generator=gen, device=dev)
    HHTe = linalg.gram_t(He)
    eshape = f"{ENS} x {EM}x{EN} k={EK}"
    kernel_case("K1 fused_mu_fro", f"f32 {eshape}",
                lambda: fused_mu.fused_w_pass(Ae, We, He, HHTe, eps),
                lambda: fused_mu.fused_w_pass_plain(Ae, We, He, HHTe, eps),
                TOL[torch.float32])
    ech = linalg.error_chunk_rows(EM, EN)
    kernel_case("K2a kl_uht", f"f32 {eshape}",
                lambda: kl.kl_uht(Ae, We, He, eps),
                lambda: kl.kl_uht_plain(Ae, We, He, eps, ech),
                TOL[torch.float32])
    kernel_case("K2b kl_wtu", f"f32 {eshape}",
                lambda: kl.kl_wtu(Ae, We, He, eps),
                lambda: kl.kl_wtu_plain(Ae, We, He, eps, ech),
                TOL[torch.float32])
    del Ae, We, He, HHTe
    torch.cuda.empty_cache()

    # NMF.fit through the kernels against the CPU path, small planted input
    _, _, X = generate_data(m=300, n=200, k=5)
    rng = np.random.default_rng(0)
    W0, H0 = rng.random((300, 5)), rng.random((5, 200))
    for norm in ("fro", "kl"):
        cfg = NMFConfig(k=5, norm=norm, itr=50)
        Wg, Hg, eg = NMF(cfg, dev).fit(X, factors=(W0, H0))
        Wc, Hc, ec = NMF(cfg, "cpu").fit(X, factors=(W0, H0))
        _, rel_err = compare((Wg.cpu(), Hg.cpu()), (Wc, Hc))
        print(f"[check] NMF.fit {norm} 300x200 k=5, 50 iterations, card vs "
              f"CPU: max rel err {rel_err:.3e}, error {eg:.6f} vs {ec:.6f}",
              flush=True)
        check(rel_err < 1e-3 and abs(eg - ec) < 1e-4 * ec,
              f"NMF.fit {norm} on the card disagrees with the CPU path")

    # -- 3. the main path, counters from zero ---------------------------
    counters = (fused_mu.launches, kl.launches)
    for c in counters:
        for key in c:
            c[key] = 0
    timing.enable(True)
    for norm, name in (("fro", "fused_mu_fro"), ("kl", "kl_uht")):
        before = {**fused_mu.launches, **kl.launches}
        cfg = NMFConfig(k=K, norm=norm, itr=10)
        g = torch.Generator(dev)
        g.manual_seed(cfg.seed)
        W0, H0 = init_factors_rand(g, M, N, K, torch.float32, dev)
        init_err = float(linalg.relative_error(A, W0, H0, chunk))
        del W0, H0
        timing.reset()
        t0 = time.perf_counter()
        W, H, err = NMF(cfg, dev).fit(A)          # same seed: same init
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = {**fused_mu.launches, **kl.launches}
        ran = {k: now[k] - before[k] for k in now}
        solve_s = timing.TIMINGS["solve"]
        print(f"[nmf] {norm.upper()}-MU {M}x{N} k={K} f32, 10 iterations: "
              f"fit {secs:.3f} s, solve {solve_s:.3f} s "
              f"({10 / solve_s:.2f} it/s incl. final error), relative "
              f"error {init_err:.6f} (rand init) -> {err:.6f}, launches "
              f"{ran}", flush=True)
        check(np.isfinite(err) and err < init_err,
              f"NMF.fit {norm}: error {err} not below the init's {init_err}")
        check(W.shape == (M, K) and H.shape == (K, N), "factor shapes")
        want = ({"fused_mu_fro": 10, "kl_uht": 0, "kl_wtu": 0} if norm == "fro"
                else {"fused_mu_fro": 0, "kl_uht": 10, "kl_wtu": 10})
        check(ran == want, f"NMF.fit {norm} launches {ran}, expected {want}")
        del W, H
    del A
    torch.cuda.empty_cache()

    _, _, X = generate_data(**PLANTED)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        del X
        for norm in ("fro", "kl"):
            before = {**fused_mu.launches, **kl.launches}
            timing.reset()
            res_path = os.path.join(tmp, f"res_{norm}") + "/"
            t0 = time.perf_counter()
            out = cli.main(["--process=pyDNMFk", "--p_r=1", "--p_c=1",
                            "--ftype=npy", f"--fpath={tmp}/", "--fname=X",
                            f"--norm={norm}", f"--results_path={res_path}",
                            "--timing_stats=true", *SWEEP])
            secs = time.perf_counter() - t0
            now = {**fused_mu.launches, **kl.launches}
            ran = {k: now[k] - before[k] for k in now}
            stages = {s: round(timing.TIMINGS.get(s, 0.0), 3) for s in
                      ("read", "ensemble_solve", "clustering", "regression")}
            print(f"[nmfk] {norm.upper()}-MU planted rank-4 "
                  f"{PLANTED['m']}x{PLANTED['n']} {' '.join(SWEEP)}: "
                  f"nopt {out['nopt']}, {secs:.2f} s, stage seconds "
                  f"{stages}, launches {ran}", flush=True)
            check(out["nopt"] == 4, f"NMFk {norm} chose k={out['nopt']}, not 4")
            for k in range(2, 8):
                res = read_cluster_results(os.path.join(res_path, "X", str(k)))
                check(set(res) == set(RESULT_DATASETS), f"k={k} datasets")
                check(res["clusterSilhouetteCoefficients"].shape == (k,)
                      and res["L_err"].shape == (PLANTED["n"],)
                      and res["ErrTol"].shape == (10,)
                      and all(np.isfinite(v).all() for v in res.values()),
                      f"NMFk {norm} k={k} results")
            key = "fused_mu_fro" if norm == "fro" else "kl_uht"
            check(ran[key] > 0 and (norm == "fro" or ran["kl_wtu"] > 0),
                  f"NMFk {norm} launched no kernel: {ran}")
    launches = {**fused_mu.launches, **kl.launches}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # -- 4. report -------------------------------------------------------
    sources = {"K1 fused_mu_fro": ("fused_mu_fro.cu", "ops/fused_mu.py:50",
                                   "fused_mu_fro"),
               "K2a kl_uht": ("kl_ratio.cu", "ops/pallas_kernels.py:78",
                              "kl_uht"),
               "K2b kl_wtu": ("kl_ratio.cu", "ops/pallas_kernels.py:96",
                              "kl_wtu")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"pydnmfk_tpu_torch/csrc/{src}",
                "replaces": f"pydnmfk_tpu/{tpu}",
                "launches": launches[counter], **rows[name]}
               for name, (src, tpu, counter) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
