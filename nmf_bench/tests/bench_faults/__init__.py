"""Faults planted in the program for ``test_bench_faults.py``, one module
a driver: ``bench_faults/<driver>.py`` lists in ``FAULTS`` the faults that
a cell of that driver can have. Each fault takes pytest's
``monkeypatch``."""


def unchanged_step(monkeypatch):
    """Every MU step returns its state unchanged."""
    from pydnmfk_tpu_torch.models import nmf
    monkeypatch.setattr(nmf, "step_for",
                        lambda *a, **k: (lambda A, W, H, eps: (W, H)))
