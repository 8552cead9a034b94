"""The faults of a sweep cell. No cell exchanges data between cards."""
import torch

from . import unchanged_step


def altered_k(monkeypatch):
    """The sweep's answer, the chosen k, comes out one higher."""
    from pydnmfk_tpu_torch.models.nmfk import NMFk
    real = NMFk.pvalue_analysis
    monkeypatch.setattr(NMFk, "pvalue_analysis",
                        lambda self: real(self) + 1)


def half_the_members(monkeypatch):
    """Half of the ensemble left out: the members of its second half are
    copies of the first's, so the statistics are taken over the rest."""
    from pydnmfk_tpu_torch.models.nmfk import NMFk
    real = NMFk._solve_ensemble

    def solve(self, *a, **k):
        W, H, errs = real(self, *a, **k)
        keep = torch.arange(W.shape[0]) % ((W.shape[0] + 1) // 2)
        return W[keep], H[keep], errs[keep]
    monkeypatch.setattr(NMFk, "_solve_ensemble", solve)


FAULTS = [unchanged_step, half_the_members, altered_k]
