"""Typed configuration for the PyTorch/CUDA port.

The dataclasses of ``pydnmfk_tpu/config.py`` without the TPU knobs (the
Pallas switch, matmul precision, the XLA compilation cache, the K-padded
sweep and HBM sizing) and without the features not yet ported, which the
entry points reject with :class:`NotPortedError`.
"""
from __future__ import annotations

import dataclasses

import torch

# Factor precisions the port runs. A may be stored narrower (a_precision):
# in bf16, or quantized to uint8 (ops/linalg.py::quantize_uint8).
_PRECISIONS = {"float32": torch.float32, "float64": torch.float64}
_A_PRECISIONS = {"bfloat16": torch.bfloat16, "uint8": torch.uint8,
                 **_PRECISIONS}


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not run yet."""

    def __init__(self, what: str, item: str):
        super().__init__(f"{what} is not yet ported to pydnmfk_tpu_torch "
                         f"(ROADMAP.md {item})")


def check_device(device: torch.device) -> torch.device:
    """The device of an entry point, which runs on the CUDA card unless the
    caller asks for the CPU; raises where there is no card."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           "to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """One NMF factorization (one k); mirror of ``pydnmfk_tpu.NMFConfig``."""

    k: int = 4
    init: str = "rand"                       # rand (nnsvd: not yet ported)
    itr: int = 5000
    norm: str = "kl"                         # fro | kl
    method: str = "mu"                       # mu (hals, bcd: not yet ported)
    precision: str = "float32"               # float32 | float64
    seed: int = 100
    verbose: bool = False
    save_factors: bool = False
    W_update: bool = True
    results_path: str = "results/"
    # storage dtype of A only ("bfloat16", or "uint8": the solve factorizes
    # Q = round(A / s) and the returned H carries the scale s); W/H and
    # accumulation stay at `precision`. None stores A at `precision`.
    a_precision: str | None = None
    # one-pass kernels (pydnmfk_tpu/config.py:80-84): None = the card's
    # dispatch (K1 for FRO, K2 for KL); True = K1 for FRO and K3 for KL;
    # False = the two-pass FRO step of plain products (KL keeps K2)
    use_fused: bool | None = None
    tol: float = 0.0         # early stop when relative error improves < tol
    tol_check_every: int = 50   # iterations between convergence checks

    def __post_init__(self):
        if self.init != "rand":
            raise NotPortedError(f"init={self.init!r}", "queue 1 item 13")
        if self.method.lower() != "mu":
            raise NotPortedError(f"method={self.method!r}", "queue 1 item 12")
        if self.norm.lower() not in ("fro", "kl"):
            raise ValueError(f"norm must be 'fro' or 'kl', got {self.norm!r}")
        if self.precision not in _PRECISIONS:
            raise NotPortedError(f"precision={self.precision!r}",
                                 "queue 1 item 1")
        if self.a_precision not in (None, *_A_PRECISIONS):
            raise NotPortedError(f"a_precision={self.a_precision!r}",
                                 "queue 1 item 1")

    @property
    def dtype(self) -> torch.dtype:
        return _PRECISIONS[self.precision]

    @property
    def a_dtype(self) -> torch.dtype:
        """Storage dtype of A; defaults to `dtype`."""
        if self.a_precision is None:
            return self.dtype
        return _A_PRECISIONS[self.a_precision]

    @property
    def eps(self) -> float:
        # reference: np.finfo(A.dtype).eps (pyDNMF.py:68-69)
        return float(torch.finfo(self.dtype).eps)

    def replace(self, **kw) -> "NMFConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class NMFkConfig:
    """The NMFk model-selection sweep; mirror of ``pydnmfk_tpu.NMFkConfig``."""

    nmf: NMFConfig = dataclasses.field(default_factory=NMFConfig)
    start_k: int = 1
    end_k: int = 10
    step_k: int = 1
    perturbations: int = 20
    noise_var: float = 0.015
    sampling: str = "uniform"                # uniform | poisson
    sill_thr: float = 0.6
    checkpoint: bool = True
    results_path: str = "results/"
    fname: str = "A"
    # members per batched solve; 0 = as many as fit in half of the
    # device's free memory (all of them on the CPU)
    ensemble_batch: int = 0

    @property
    def k_range(self):
        return range(self.start_k, self.end_k + 1, self.step_k)

    def replace(self, **kw) -> "NMFkConfig":
        return dataclasses.replace(self, **kw)
