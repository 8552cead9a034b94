"""Stage timing.

Port of ``pydnmfk_tpu/utils/timing.py`` (reference comm_timing and the
config.time globals, pyDNMFk/utils.py:539-567): wall seconds accumulate per
name while timing is enabled, the flag is read at call time, and each timed
region waits for the device (``torch.cuda.synchronize``) on entry and exit,
so it measures the work and not its enqueueing.

NMFk stages: ``ensemble_solve`` (sampling and the batched solve; its share
``ensemble_init`` is the members' init draws or nnsvd), ``clustering`` and
``regression`` (the W-frozen refit and per-column errors).
"""
from __future__ import annotations

import contextlib
import csv
import time
from typing import Dict

import torch

TIMINGS: Dict[str, float] = {}
ENABLED: bool = False


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


def save_csv(path: str):
    """One header row of names and one row of seconds (Timing_stats.csv)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(TIMINGS))
        writer.writerow([TIMINGS[k] for k in TIMINGS])
