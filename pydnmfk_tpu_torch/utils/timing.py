"""Stage timing.

Port of ``pydnmfk_tpu/utils/timing.py`` (reference comm_timing and the
config.time globals, pyDNMFk/utils.py:539-567): wall seconds accumulate per
name while timing is enabled, the flag is read at call time, and each timed
region waits for the device (``torch.cuda.synchronize``) on entry and exit,
so it measures the work and not its enqueueing.

NMFk stages: ``ensemble_solve`` (sampling and the batched solve; its share
``ensemble_init`` is the members' init draws or nnsvd), ``clustering`` and
``regression`` (the W-frozen refit and per-column errors).

:func:`trace` records a ``torch.profiler`` trace of a region, the card's
kernels with it, as a Chrome trace file (the JAX package's XLA trace).
"""
from __future__ import annotations

import contextlib
import csv
import functools
import os
import time
from typing import Callable, Dict, Optional

import torch

TIMINGS: Dict[str, float] = {}
ENABLED: bool = False

# the reference's category taxonomy (plot_results.timing_stats :157-201;
# pydnmfk_tpu/utils/timing.py:31-41)
CATEGORIES = {
    "init": ["__init__", "init_factors", "compute_global_dim",
             "compute_local_dim"],
    "data_io": ["read", "read_global", "read_chunk", "save_factors",
                "save_cluster_results"],
    "sampling": ["sample_ensemble", "sample_one"],
    "dist_compute": ["solve", "mu_fro_step", "mu_kl_step", "hals_step",
                     "bcd_solve", "svd", "nnsvd"],
    "dist_comm": ["dist_comm_est"],
    "clustering": ["cluster_ensemble", "fit_clustering"],
}


def enable(on: bool = True):
    global ENABLED
    ENABLED = on


def reset():
    TIMINGS.clear()


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str):
    if not ENABLED:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        TIMINGS[name] = TIMINGS.get(name, 0.0) + time.perf_counter() - t0


def timed_fn(fn: Callable) -> Callable:
    """Decorator form of :func:`timed`, under the function's name (the
    reference's comm_timing); the flag is read at each call."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with timed(fn.__name__):
            return fn(*a, **kw)
    return wrapper


def categorize(timings: Dict[str, float]) -> Dict[str, float]:
    """Seconds by the reference's categories, and the rest as "other"."""
    out = {c: 0.0 for c in CATEGORIES}
    other = 0.0
    for name, dt in timings.items():
        for cat, names in CATEGORIES.items():
            if name in names:
                out[cat] += dt
                break
        else:
            other += dt
    out["other"] = other
    return out


def category_breakdown() -> Dict[str, float]:
    """The accumulated timings by the reference's categories."""
    return categorize(TIMINGS)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the region, the CUDA kernels with it
    where a card is present, written to ``logdir/trace.json`` as a Chrome
    trace; no trace when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def save_csv(path: str):
    """One header row of names and one row of seconds (Timing_stats.csv)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(TIMINGS))
        writer.writerow([TIMINGS[k] for k in TIMINGS])
