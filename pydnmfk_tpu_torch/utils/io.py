"""Data and results IO on one device.

Port of ``pydnmfk_tpu/utils/io.py`` (reference pyDNMFk/data_io.py) for a 1x1
grid: the reader loads a whole .npy, .mat (variable ``X``) or .csv/.txt
matrix; the writer keeps the reference's layout of factors
(``W_[reg_]factors/W.npy``, ``H_[reg_]factors/H.npy``) and per-k statistics.

The statistics go to ``results.h5`` with the reference's dataset names
(data_io.py:198-209) where ``h5py`` is installed, and otherwise to
``results.npz`` with the same names; :func:`read_cluster_results` reads
whichever exists.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import config

# dataset names of results.h5 (pydnmfk_tpu/utils/io.py:557-565) and the
# stats keys they hold
RESULT_DATASETS = {
    "clusterSilhouetteCoefficients": "clusterSilhouetteCoefficients",
    "avgSilhouetteCoefficients": "avgSilhouetteCoefficients",
    "L_err": "L_err",
    "L_errDist": "L_errDist",
    "avgErr": "avgErr",
    "ErrTol": "recon_err",
    "AIC": "AIC",
}


class DataReader:
    """API mirror of reference ``data_read`` (data_io.py:12-105), whole-file
    reads on one host."""

    def __init__(self, fpath: str, fname: str, ftype: str = "mat",
                 precision: str = "float32"):
        if ftype == "npz":
            raise config.NotPortedError("ftype='npz' (sparse input)",
                                        "queue 1 item 14")
        if ftype == "folder":
            raise config.NotPortedError("ftype='folder'", "queue 1 item 9")
        if ftype not in ("npy", "mat", "csv", "txt"):
            raise ValueError(f"unknown ftype {ftype!r}")
        self.fpath = fpath
        self.fname = fname
        self.ftype = ftype
        self.precision = precision

    def read(self) -> np.ndarray:
        path = os.path.join(self.fpath, self.fname + "." + self.ftype)
        if self.ftype == "npy":
            data = np.load(path)
        elif self.ftype == "mat":
            from scipy.io import loadmat
            data = loadmat(path)["X"]
        else:
            data = np.loadtxt(path, delimiter=",", ndmin=2)
        return np.asarray(data).astype(self.precision)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DataWriter:
    """API mirror of reference ``data_write`` (data_io.py:143-209) for a 1x1
    grid."""

    def __init__(self, results_path: str):
        self.fpath = results_path
        os.makedirs(self.fpath, exist_ok=True)

    def save_factors(self, W, H, reg: bool = False):
        tag = "reg_" if reg else ""
        for name, X in (("W", W), ("H", H)):
            d = os.path.join(self.fpath, f"{name}_{tag}factors")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{name}.npy"), _host(X))

    def save_cluster_results(self, stats: dict, config: dict = None):
        """Per-k statistics under the reference's dataset names, with the
        run configuration as attributes (h5) or a ``config`` entry (npz)."""
        data = {name: _host(stats[key])
                for name, key in RESULT_DATASETS.items()}
        try:
            import h5py
        except ImportError:
            np.savez(os.path.join(self.fpath, "results.npz"),
                     config=np.asarray(repr(config or {})), **data)
            return
        with h5py.File(os.path.join(self.fpath, "results.h5"), "w") as hf:
            for key, val in (config or {}).items():
                try:
                    hf.attrs[key] = val
                except TypeError:
                    hf.attrs[key] = str(val)
            for name, val in data.items():
                hf.create_dataset(name, data=val)


def read_cluster_results(k_path: str) -> dict:
    """The datasets of ``k_path/results.h5``, or of ``results.npz`` where
    the writer had no h5py."""
    h5 = os.path.join(k_path, "results.h5")
    if os.path.exists(h5):
        import h5py
        with h5py.File(h5, "r") as f:
            return {name: np.array(f[name]) for name in RESULT_DATASETS}
    with np.load(os.path.join(k_path, "results.npz")) as f:
        return {name: np.array(f[name]) for name in RESULT_DATASETS}
