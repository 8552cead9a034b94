"""Plots of factors, of the k-selection curves and of the timings.

Port of ``pydnmfk_tpu/utils/plotting.py`` (reference pyDNMFk/plot_results.py)
with its artefacts: per-component factor plots, the
``<fname>_selection_plot.pdf`` k-selection curve (mean L2 %, relative error %
and minimum stability against k, read back from each k's results through
``utils/io.py::read_cluster_results``, so from results.h5 or results.npz),
the column-error box plot and the timing bar chart. matplotlib is imported
at the first plot, with the Agg backend, so that a host without a display
plots and one without matplotlib runs everything else.
"""
from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def plot_err(err: Sequence[float], out: str = "Error_plot.png"):
    """Relative error against iteration (reference plot_err :7-15)."""
    plt = _plt()
    plt.figure()
    plt.plot(np.arange(1, len(err) + 1), err)
    plt.xlabel("Iterations")
    plt.ylabel("Relative error")
    plt.title("Relative error vs Iterations")
    plt.savefig(out)
    plt.close()


def plot_W(W, out: str = "Results_W.png"):
    """One subplot per latent component (reference plot_W :27-62)."""
    plt = _plt()
    W = np.asarray(W)
    m, k = W.shape
    f, axes = plt.subplots(nrows=k, sharex=True,
                           figsize=(12, max(2 * k, 4)), squeeze=False)
    for i in range(k):
        ax = axes[i][0]
        ax.plot(W[:, i], label=f"W[{i}]")
        ax.legend(loc=4)
    axes[-1][0].set_xlabel("Features")
    f.tight_layout()
    f.savefig(out, bbox_inches="tight")
    plt.close(f)


def read_plot_factors(factors_path: str, pgrid=(1, 1)):
    """W.png and H.png of the factors saved under ``factors_path``."""
    from .io import read_factors
    W, H = read_factors(factors_path, pgrid)
    plot_W(W, os.path.join(factors_path, "W.png"))
    plot_W(H.T, os.path.join(factors_path, "H.png"))


def plot_results(ks, RECON, RECON1, SILL_MIN, out_dir: str, name: str):
    """The k-selection plot on twin axes (reference plot_results :65-99)."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(10, 6), dpi=150)
    ax1.set_xlabel("Total Signatures")
    ax1.set_ylabel("Mean L2 %", color="tab:red")
    l1 = ax1.plot(ks, RECON, marker="o", linestyle=":", color="tab:red",
                  label="Mean L2 %")
    l3 = ax1.plot(ks, RECON1, marker="X", linestyle=":", color="tab:green",
                  label="Relative error %")
    ax1.tick_params(axis="y", labelcolor="tab:red")
    ax2 = ax1.twinx()
    ax2.set_ylabel("Minimum Stability", color="tab:blue")
    l2 = ax2.plot(ks, SILL_MIN, marker="s", linestyle="-.",
                  color="tab:blue", label="Minimum Stability")
    ax2.tick_params(axis="y", labelcolor="tab:blue")
    fig.tight_layout()
    lns = l1 + l2 + l3
    ax1.legend(lns, [l.get_label() for l in lns], loc=0)
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, f"{name}_selection_plot.pdf"))
    plt.close(fig)


def plot_results_fpath(results_path: str, ks, name: str = None):
    """The same plot from each k's saved results (reference :102-145)."""
    from .io import read_cluster_results
    RECON, RECON1, SILL = [], [], []
    for k in ks:
        res = read_cluster_results(os.path.join(results_path, str(k)))
        RECON.append(float(np.mean(res["L_err"])))
        RECON1.append(float(res["avgErr"]))
        SILL.append(round(float(np.min(
            res["clusterSilhouetteCoefficients"])), 2))
    plot_results(list(ks), RECON, RECON1, SILL, results_path,
                 name or os.path.basename(results_path.rstrip("/")))


def box_plot(dat, respath: str):
    """Box plot of the column-error distribution, one box per k (reference
    box_plot :147-154), saved as box_plot.png in respath."""
    plt = _plt()
    plt.figure()
    plt.boxplot(dat)
    plt.xlabel("k")
    plt.ylabel("Column relative error")
    os.makedirs(respath, exist_ok=True)
    plt.savefig(os.path.join(respath, "box_plot.png"), bbox_inches="tight")
    plt.close()


def _read_timings(stats_csv: str) -> dict:
    """The seconds of a Timing_stats.csv: a header row of names and a row
    of values, with or without the leading index column that pandas
    writes (the JAX package's CSV)."""
    with open(stats_csv, newline="") as f:
        header, values = list(csv.reader(f))[:2]
    raw = {}
    for name, val in zip(header, values):
        if name in ("", "Unnamed: 0"):
            continue
        try:
            raw[name] = float(val)
        except ValueError:
            continue
    return raw


def timing_stats(stats_csv: str):
    """A Timing_stats.csv as the reference's two breakdowns (reference
    timing_stats :157-201): seconds by category (init, data_io, sampling,
    dist_compute, dist_comm, clustering, other) and by name."""
    from .timing import categorize
    raw = _read_timings(stats_csv)
    return categorize(raw), raw


def plot_timing_stats(stats_csv: str, out_dir: str):
    """Bar chart of the timings by name, timing.png (reference :204-214)."""
    plt = _plt()
    raw = _read_timings(stats_csv)
    plt.figure()
    plt.bar(list(raw), list(raw.values()))
    plt.xticks(rotation=90)
    plt.xlabel("operation")
    plt.ylabel("timing(sec)")
    plt.savefig(os.path.join(out_dir, "timing.png"), bbox_inches="tight")
    plt.close()
