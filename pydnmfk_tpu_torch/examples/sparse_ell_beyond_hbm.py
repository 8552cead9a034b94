"""Very sparse input through the ELL gather path (K4), on the card: the
port of ``examples/sparse_ell_beyond_hbm.py``.

The format of a sparse A is picked by a cost model of the card
(``ops/sparse.py::densify_for_backend``, ``ops/ell.py::ell_time_model``):
moderate densities densify onto the dense kernels, while very sparse
matrices, those whose dense form cannot fit the card among them, run the
dual-orientation ELL (``ops/ell.py``) in O(nnz) memory. This example asks
the model at 40000 x 40000 and two nnz, then packs a 3000 x 2400 planted
COO at 1 % density into the ELL and runs KL-MU (k = 4, 400 iterations) on
it, then on the same data in a second form: the triplet on the CPU, where
the policy keeps it, and on the card the dense matrix (K2a/K2b), since
the card's policy would pack the triplet into the same ELL; the two
errors agree within 5e-3.

Run: python -m pydnmfk_tpu_torch.examples.sparse_ell_beyond_hbm [--cpu]
"""
import numpy as np
import torch

from pydnmfk_tpu_torch import NMFConfig
from pydnmfk_tpu_torch.config import check_device
from pydnmfk_tpu_torch.examples import parse
from pydnmfk_tpu_torch.models.nmf import NMF
from pydnmfk_tpu_torch.ops import linalg
from pydnmfk_tpu_torch.ops.ell import ell_pack, ell_time_model
from pydnmfk_tpu_torch.ops.sparse import densify_for_backend, from_coo


def planted_sparse_coo(m, n, ktrue, keep=0.02, seed=0):
    """Low-rank structure sampled down to ``keep`` density, built directly
    as COO (the dense matrix is never materialized), as a SparseTriplet on
    the CPU."""
    rng = np.random.default_rng(seed)
    nnz = int(m * n * keep)
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = (flat // n).astype(np.int32), (flat % n).astype(np.int32)
    W = rng.random((m, ktrue)).astype(np.float32)
    H = rng.random((ktrue, n)).astype(np.float32)
    vals = np.einsum("ek,ke->e", W[rows], H[:, cols]).astype(np.float32)
    return from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                    torch.from_numpy(vals), (m, n))


def to_dense(A):
    """The dense matrix of a SparseTriplet, on its device."""
    dense = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    dense[A.rows.long(), A.cols.long()] = A.data
    return dense


def format_name(A) -> str:
    """The format that NMF.fit runs A in on its device."""
    fmt = densify_for_backend(A, k_hint=4)
    if not linalg.is_sparse(fmt):
        return f"dense {fmt.dtype}"
    return "ELL" if fmt is not A else "triplet"


def main(device="cuda", itr=400, shape=(3000, 2400), keep=0.01, tol=5e-3):
    device = check_device(torch.device(device))
    # ------------------------------------------------------------------
    # regime 1: the cost model: when does ELL beat streaming dense A?
    m, n, k = 40_000, 40_000, 8
    for nnz in (300_000, 30_000_000):
        t_ell, t_dense = ell_time_model(m, n, nnz, k)
        pick = "ELL" if t_ell < t_dense else "densify"
        print(f"{m}x{n}, nnz={nnz:.0e}: model picks {pick} "
              f"(ell {t_ell * 1e3:.1f} ms vs dense {t_dense * 1e3:.1f} ms "
              "per product)")

    # ------------------------------------------------------------------
    # regime 2: an explicit ELL solve (a small stand-in for beyond-HBM)
    A = planted_sparse_coo(*shape, ktrue=4, keep=keep).to(device)
    E = ell_pack(A)
    print(f"\nELL pack: shape {E.shape}, nnz {E.nse}, "
          f"row width {E.rvals.shape[1]}, col width {E.cvals.shape[1]}")
    cfg = NMFConfig(k=4, norm="kl", method="mu", itr=itr, seed=7)
    W, H, err = NMF(cfg, device).fit(E)
    print(f"ELL KL solve: rel_err={err:.4f}  W {tuple(W.shape)}  "
          f"H {tuple(H.shape)}")

    # the same data in a second form: the triplet, which the CPU keeps;
    # on the card, whose policy packs it into the same ELL, the dense form
    B = A if device.type == "cpu" else to_dense(A)
    W2, H2, err2 = NMF(cfg, device).fit(B)
    print(f"{'triplet' if B is A else 'dense'} solve ({format_name(B)} on "
          f"{device}): rel_err={err2:.4f} (same data, "
          f"|delta|={abs(err - err2):.2e})")
    assert abs(err - err2) < tol, f"|{err} - {err2}| >= {tol}"
    return err, err2


if __name__ == "__main__":
    main(**parse(__doc__))
