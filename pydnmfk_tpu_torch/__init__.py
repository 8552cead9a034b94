"""pydnmfk_tpu_torch — the NMF/NMFk system of ``pydnmfk_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports neither JAX nor
``pydnmfk_tpu``. Entry points: ``python -m pydnmfk_tpu_torch``,
:class:`Runner`, :class:`NMF` and :class:`NMFk`.
"""

from .config import NMFConfig, NMFkConfig, NotPortedError
from .models.nmf import NMF
from .models.nmfk import NMFk
from .runner import Runner

__all__ = ["NMFConfig", "NMFkConfig", "NotPortedError", "NMF", "NMFk",
           "Runner"]
