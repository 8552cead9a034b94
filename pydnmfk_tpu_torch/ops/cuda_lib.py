"""Builds the hand-written CUDA kernels of ``pydnmfk_tpu_torch/csrc`` and
loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/pydnmfk_tpu_torch/`` at the root of the checkout, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one loads at once. The build
runs at first use, never at import: the CPU tests import every module on
machines without ``nvcc``. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .linalg import HALF

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pydnmfk_tpu_torch"
KERNEL_SOURCES = ("fused_mu_fro", "kl_ratio", "ell_gather", "fused_mu_kl")
# the A dtypes of the dense kernels (K1, K2, K3) and their C-name suffixes
A_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16", torch.uint8: "u8"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "pydnmfk_tpu_torch are built from source at first use")


def library_path(name: str) -> Path:
    # the source, every shared header (csrc/*.cuh) and the flags
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless its library exists; returns it."""
    out = library_path(name)
    if out.exists():
        return out
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent process loads a whole file
    return out


def build_all() -> list:
    """Builds every kernel source at once (one nvcc process each)."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        return list(pool.map(build, KERNEL_SOURCES))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def kernel_types(a_dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """True where the dense kernels take an A of ``a_dtype`` with factors of
    ``w_dtype``: f32 factors with an f32, bf16, f16 or uint8 A; bf16 or f16
    factors with a bf16, f16 or uint8 A (the factors are widened to f32,
    exactly, for the launch, and the products' operands follow A's dtype, as
    the JAX package's fused kernels' ``matmul_compute_dtype`` does). An A
    wider than its factors, and f64 anywhere, take the plain products."""
    if w_dtype == torch.float32:
        return a_dtype in A_SUFFIX
    return w_dtype in HALF and a_dtype in (*HALF, torch.uint8)


def check_operands(kernel: str, A, factors: dict, f32: dict = None) -> None:
    """Raises unless A and the ``factors`` (all of one dtype) pair as
    :func:`kernel_types` says the dense kernels take them, the ``f32``
    tensors are f32, and all lie on A's device, contiguous."""
    f32 = f32 or {}
    if A.dtype not in A_SUFFIX:
        raise TypeError(f"{kernel} takes an f32, bf16, f16 or uint8 A, got "
                        f"{A.dtype}")
    for name, t in factors.items():
        if not kernel_types(A.dtype, t.dtype):
            raise TypeError(f"{kernel} takes f32 factors, or bf16 / f16 ones "
                            f"with a bf16, f16 or uint8 A; got {name} "
                            f"{t.dtype} with A {A.dtype}")
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes an f32 {name}, got {t.dtype}")
    for name, t in (("A", A), *factors.items(), *f32.items()):
        if t.device != A.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, A on "
                             f"{A.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} takes a contiguous {name}")


def check(rc: int, lib: ctypes.CDLL, error_string: str, what: str) -> None:
    """Raises if a launch returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
