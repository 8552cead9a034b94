"""Stage timing.

Port of ``pydnmfk_tpu/utils/timing.py`` (reference comm_timing and the
config.time globals, pyDNMFk/utils.py:539-567): wall seconds accumulate per
name while timing is enabled, the flag is read at call time, and each timed
region waits for the device (``torch.cuda.synchronize``) on entry and exit,
so it measures the work and not its enqueueing.

NMFk stages: ``ensemble_solve`` (sampling and the batched solve; its share
``ensemble_init`` is the members' init draws or nnsvd, and under p_e
ensemble groups ``ensemble_gather`` the members' gather over 'e'),
``clustering`` and
``regression`` (the W-frozen refit and per-column errors). On a grid the
collectives add their wall seconds under ``dist_comm`` (each waits for the
device before and after), and :func:`collective_stats` counts the
collectives and bytes that a call issues.

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


def sync():
    """Wait for the device, where one is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def record(name: str, seconds: float):
    """Add ``seconds`` to ``name``."""
    TIMINGS[name] = TIMINGS.get(name, 0.0) + seconds


@contextlib.contextmanager
def timed(name: str):
    if not ENABLED:
        yield
        return
    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        record(name, time.perf_counter() - t0)


def timed_fn(fn: Callable) -> Callable:
    """Decorator form of :func:`timed`, under the function's name (the
    reference's comm_timing); the flag is read at each call."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with timed(fn.__name__):
            return fn(*a, **kw)
    return wrapper


def categorize(timings: Dict[str, float]) -> Dict[str, float]:
    """Seconds by the reference's categories (a name that is a category's
    own, as the grid's measured ``dist_comm``, falls in it), and the rest
    as "other"."""
    out = {c: 0.0 for c in CATEGORIES}
    other = 0.0
    for name, dt in timings.items():
        for cat, names in CATEGORIES.items():
            if name in names or name == cat:
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
        sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def collective_stats(fn, *args, grid, **kwargs) -> Dict[str, object]:
    """The collectives that ``fn(*args, **kwargs)`` issues on ``grid``
    (``pydnmfk_tpu/utils/timing.py:114-148``, which reads them from the
    compiled program; here they are counted as they run):
    ``{"counts": {kind: calls}, "bytes": bytes reduced or gathered}``,
    kinds "all-reduce", "all-gather" and "broadcast"."""
    before = {kind: list(v) for kind, v in grid.stats.items()}
    fn(*args, **kwargs)
    counts, total = {}, 0
    for kind, (calls, nbytes) in grid.stats.items():
        calls0, bytes0 = before.get(kind, (0, 0))
        if calls > calls0:
            counts[kind] = calls - calls0
        total += nbytes - bytes0
    return {"counts": counts, "bytes": total}


def record_dist_comm(fn, *args, grid, link_gbps: float = 45.0,
                     iterations: int = 1, **kwargs) -> Dict[str, object]:
    """:func:`collective_stats` of ``fn`` and the collectives' time
    estimated as bytes over ``link_gbps`` GB/s, times ``iterations``,
    added under ``dist_comm_est`` (``timing.py:151-166``); the measured
    wall seconds are ``dist_comm``'s."""
    stats = collective_stats(fn, *args, grid=grid, **kwargs)
    est = stats["bytes"] * iterations / (link_gbps * 1e9)
    if ENABLED:
        record("dist_comm_est", est)
    stats["est_seconds"] = est
    return stats


def save_csv(path: str):
    """One header row of names and one row of seconds (Timing_stats.csv)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(TIMINGS))
        writer.writerow([TIMINGS[k] for k in TIMINGS])
