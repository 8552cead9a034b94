"""Typed configuration for the PyTorch/CUDA port.

The dataclasses of ``pydnmfk_tpu/config.py`` without the TPU knobs (the
Pallas switch, matmul precision and the XLA compilation cache), which the
entry points reject with :class:`NotPortedError` at any value the port
does not run the same as. The K-padded sweep's ``k_sweep_batch`` and
``k_sweep_merge`` are fields of :class:`NMFkConfig`, with one default that
differs: ``k_sweep_batch=None`` keeps the per-k sweep here (JAX: on), since
on the card there is no compile for the padding to share; True runs it.
The ensemble axis ``p_e`` is no field here, as in the JAX package: it is
the grid's (``parallel/mesh.py::initialize``), handed to ``NMF`` and
``NMFk``.
"""
from __future__ import annotations

import dataclasses

import torch

# Factor precisions (pydnmfk_tpu/config.py:16-27). A may be stored narrower
# (a_precision): in bf16 or f16, or quantized to uint8
# (ops/linalg.py::quantize_uint8).
_PRECISIONS = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32, "float64": torch.float64}
_A_PRECISIONS = {"uint8": torch.uint8, **_PRECISIONS}


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not run yet."""

    def __init__(self, what: str, item: str,
                 why: str = "is not yet ported to pydnmfk_tpu_torch"):
        super().__init__(f"{what} {why} (ROADMAP.md {item})")


# the formats of a sparse A on a grid (``ops/sparse.py::grid_format``):
# None or "auto" = the dual ELL on the card where every rank's block packs,
# else the triplet; "ell" or "triplet" forces one
SPARSE_GRID_FORMATS = (None, "auto", "ell", "triplet")


# Knobs of the JAX package's configs and Runner that the port has no
# counterpart for: the values it runs the same as (the JAX defaults, or
# settings that give the same results) and the ROADMAP item that ports the
# rest. The CLI, Runner and utils/convert.py refuse any other value.
JAX_ONLY = {
    "use_pallas": ((None, False), '"Not to port"'),
    # the port's products run in true f32, which "highest" asks for
    "matmul_precision": ((None, "highest", "float32"), '"Not to port"'),
}


def check_jax_only(**knobs) -> None:
    """Raises NotPortedError for a JAX-only knob (``JAX_ONLY``) set to a
    value the port does not run the same as."""
    for key, val in knobs.items():
        accepted, item = JAX_ONLY[key]
        if (tuple(val) if isinstance(val, list) else val) in accepted:
            continue
        if key == "use_pallas":
            raise NotPortedError(f"{key}={val!r}", item, "is no knob of "
                                 "pydnmfk_tpu_torch: its dispatch picks the "
                                 "kernel")
        if key == "matmul_precision":
            raise NotPortedError(f"{key}={val!r}", item, "is no knob of "
                                 "pydnmfk_tpu_torch: its f32 products run in "
                                 "true f32")
        raise NotPortedError(f"{key}={val!r}", item)


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
    # (p_r, p_c): the process grid, one process per rank
    # (parallel/mesh.py); NMF and NMFk join it where no GridContext is given
    grid: tuple = (1, 1)
    init: str = "rand"                       # rand | nnsvd
    itr: int = 5000
    norm: str = "kl"                         # fro | kl
    method: str = "mu"                       # mu | hals | bcd (hals, bcd: fro)
    # zero-row/column pruning: the fit solves on A without its all-zero
    # rows and columns and returns factors at the full shape
    prune: bool = False
    precision: str = "float32"   # bfloat16 | float16 | float32 | float64
    seed: int = 100
    verbose: bool = False
    save_factors: bool = False
    W_update: bool = True
    results_path: str = "results/"
    # storage dtype of A only ("bfloat16", "float16", or "uint8": the solve
    # factorizes Q = round(A / s) and the returned H carries the scale s);
    # W/H and accumulation stay at `precision`. None stores A at `precision`.
    a_precision: str | None = None
    # one-pass kernels (pydnmfk_tpu/config.py:80-84): None = the card's
    # dispatch (K1 for FRO, K2 for KL); True = K1 for FRO and K3 for KL;
    # False = the two-pass FRO step of plain products (KL keeps K2)
    use_fused: bool | None = None
    tol: float = 0.0         # early stop when relative error improves < tol
    tol_check_every: int = 50   # iterations between convergence checks
    # HALS: None or 0 = the reference's column-by-column sweep; B > 0 = the
    # same Gauss-Seidel sweep by delayed updates in blocks of B columns
    hals_block: int | None = None
    # BCD's objective for its restore-or-extrapolate choice: None or "gram"
    # = the Gram identity (no third pass over A); "residual" = the
    # reference's explicit residual, summed over row slabs
    bcd_obj: str | None = None
    # rows per slab of the plain KL products' m x n ratio; 0 = automatic
    # (ops/linalg.py::error_chunk_rows)
    kl_chunk: int = 0
    # > 0: NMF.fit persists W, H every this many iterations (rounded down
    # to a multiple of 10, at least 10) to results_path and resumes from
    # the last save (pydnmfk_tpu/config.py:118); fixed-iteration MU and
    # HALS only
    solve_checkpoint_every: int = 0
    # the format of each rank's block of a sparse A on a grid
    # (SPARSE_GRID_FORMATS; pydnmfk_tpu/config.py:104)
    sparse_grid_format: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "grid", tuple(int(p) for p in self.grid))
        if len(self.grid) != 2 or min(self.grid) < 1:
            raise ValueError(f"grid must be (p_r, p_c), got {self.grid!r}")
        if self.init not in ("rand", "nnsvd"):
            raise ValueError(f"unknown init {self.init!r}")
        if self.norm.lower() not in ("fro", "kl"):
            raise ValueError(f"norm must be 'fro' or 'kl', got {self.norm!r}")
        method = self.method.lower()
        if method not in ("mu", "hals", "bcd"):
            raise ValueError(f"invalid (norm, method) = ({self.norm!r}, "
                             f"{self.method!r})")
        if method != "mu" and self.norm.lower() != "fro":
            # pydnmfk_tpu/models/nmf.py:81-82
            raise ValueError(f"method {method!r} supports only norm='fro'")
        if self.hals_block is not None and self.hals_block < 0:
            raise ValueError(f"hals_block must be None or >= 0, got "
                             f"{self.hals_block!r}")
        if self.bcd_obj not in (None, "gram", "residual"):
            raise ValueError(f"bcd_obj must be None, 'gram' or 'residual', "
                             f"got {self.bcd_obj!r}")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.a_precision not in (None, *_A_PRECISIONS):
            raise ValueError(f"unknown a_precision {self.a_precision!r}")
        if isinstance(self.sparse_grid_format, str):
            object.__setattr__(self, "sparse_grid_format",
                               self.sparse_grid_format.lower())
        if self.sparse_grid_format not in SPARSE_GRID_FORMATS:
            # pydnmfk_tpu/ops/sparse.py:293-295
            raise ValueError(f"sparse_grid_format must be 'ell' or "
                             f"'triplet', got {self.sparse_grid_format!r}")
        if self.kl_chunk < 0:
            raise ValueError(f"kl_chunk must be >= 0, got {self.kl_chunk!r}")
        half = (torch.bfloat16, torch.float16)
        if self.dtype in half and self.a_dtype in half and (
                self.a_dtype != self.dtype):
            # a bf16 operand against an f16 one takes the first operand's
            # dtype and returns the other's (pydnmfk_tpu/ops/linalg.py:81-
            # 88), so the JAX package's elementwise updates promote the
            # factors to f32 and its solve loop raises a TypeError
            raise ValueError(f"a_precision={self.a_precision!r} under "
                             f"precision={self.precision!r}: one half "
                             f"dtype for A and the other for the factors "
                             f"is not supported; store A at "
                             f"{self.precision!r}, as uint8, or take "
                             f"float32 factors")
        if self.dtype in half and self.a_dtype in (torch.float32,
                                                   torch.float64):
            # an f32 or f64 A promotes the products and the elementwise
            # updates, so the JAX package's solve loop gets wider factors
            # back than it carries and raises a TypeError
            # (pydnmfk_tpu/models/nmf.py:94-103)
            raise ValueError(f"a_precision={self.a_precision!r} under "
                             f"precision={self.precision!r}: an A wider "
                             f"than its half factors is not supported; "
                             f"store A at {self.precision!r} or as uint8, "
                             f"or take factors at {self.a_precision!r}")

    @property
    def p_r(self) -> int:
        return self.grid[0]

    @property
    def p_c(self) -> int:
        return self.grid[1]

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
        # reference: np.finfo(A.dtype).eps (pyDNMF.py:68-69); bf16 takes
        # f32's, since its own (0.0078) is too coarse for the MU
        # denominators (pydnmfk_tpu/config.py:139-146)
        if self.dtype == torch.bfloat16:
            return float(torch.finfo(torch.float32).eps)
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
    # members per batched solve; 0 = as many as fit the memory budget (all
    # of them on the CPU)
    ensemble_batch: int = 0
    # the device memory budget in bytes that sizes the batch; 0 = the
    # PYDNMFK_HBM_BUDGET environment variable, else half of the free memory
    hbm_budget: int = 0
    # (p_r, p_c): the reference's MPI seeding on a p_r x p_c grid, where
    # every rank draws the same noise block and the same local init
    # factors (pydnmfk_tpu/config.py:200-207); dense A only, dims divisible
    # by the grid. None or (1, 1): one stream over the whole member
    seed_grid: tuple | None = None
    # the K-padded sweep (pydnmfk_tpu/config.py:188-201): True solves every
    # k's members at K = max(k_range) columns under a column mask, with the
    # per-k sweep's results up to summation order; None or False keeps the
    # per-k sweep (in the JAX package None means on)
    k_sweep_batch: bool | None = None
    # merged multi-k batches of the K-padded sweep: None = on wherever it
    # runs and more than one k is swept, as in JAX; False = one k a batch
    k_sweep_merge: bool | None = None

    def __post_init__(self):
        if self.seed_grid is not None:
            object.__setattr__(self, "seed_grid",
                               tuple(int(x) for x in self.seed_grid))

    @property
    def k_range(self):
        return range(self.start_k, self.end_k + 1, self.step_k)

    def replace(self, **kw) -> "NMFkConfig":
        return dataclasses.replace(self, **kw)
