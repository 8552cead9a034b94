"""The numbers that decide ``correct``: how far an answer lies from the
reference's, each a worst case over what a run checks."""
from __future__ import annotations

import numpy as np


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, dtype=np.float64)


def gap(x, ref) -> float:
    """max |x - ref| over max |ref|: how far a factor lies from the
    reference's, against the reference's scale."""
    x, ref = _np(x), _np(ref)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def rel(x, ref) -> float:
    """max |x - ref| / |ref| elementwise, for errors that are never 0."""
    x, ref = _np(x), _np(ref)
    return float((np.abs(x - ref) / np.abs(ref)).max())


def solve_numbers(got, ref) -> dict:
    """A solve's (W, H, error) against the reference's."""
    return {"W_gap": gap(got[0], ref[0]), "H_gap": gap(got[1], ref[1]),
            "err_gap": rel(got[2], ref[2])}


def sweep_numbers(got: dict, ref: dict) -> dict:
    """One k of a sweep: ``got`` and ``ref`` hold the members' errors
    (recon_err), the silhouettes (sils), the refit's error (L_errDist),
    per-column errors (L_err) and factors (W, H)."""
    return {"member_err_gap": rel(got["recon_err"], ref["recon_err"]),
            "sil_gap": float(np.abs(_np(got["sils"])
                                    - _np(ref["sils"])).max()),
            "refit_err_gap": rel(got["L_errDist"], ref["L_errDist"]),
            "col_err_gap": gap(got["L_err"], ref["L_err"]),
            "W_reg_gap": gap(got["W"], ref["W"]),
            "H_reg_gap": gap(got["H"], ref["H"])}


def worst(readings) -> dict:
    """The largest reading of each number over several answers (a NaN
    reads as infinity)."""
    out = {}
    for r in readings:
        for name, v in r.items():
            v = v if np.isfinite(v) else float("inf")
            out[name] = max(out.get(name, 0.0), v)
    return out
