"""The faults of a fit cell. A fit has no batch to halve, and no cell
exchanges data between cards."""
from . import unchanged_step


def altered_error(monkeypatch):
    """A fit's relative error comes out 1 % high."""
    from pydnmfk_tpu_torch.ops import linalg
    real = linalg.relative_error
    monkeypatch.setattr(linalg, "relative_error",
                        lambda *a, **k: real(*a, **k) * 1.01)


FAULTS = [unchanged_step, altered_error]
