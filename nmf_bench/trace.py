"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` records the window with the card's kernels; from its
events come the seconds in which an operation ran on the device (the union
of kernel, copy and set intervals), the device operations that took most
time, and the longest idle stretches, by what the host was doing then: the
innermost host operation under way, else the last one that ended before.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

WINDOW = "nmf_bench.window"
TOP = 10
LABELLED_GAPS = 2000      # the longest gaps that get a label
LOOK_BACK = 200           # host events searched for one under way


def _annotation(event) -> bool:
    """A host range mirrored on the device's timeline, which is no
    operation of the device."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    mark = getattr(event, "is_user_annotation", None)
    return event.name() == WINDOW or (mark is not None and mark())


class DeviceTrace:
    def __init__(self):
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.prof = prof

    def reduce(self) -> dict:
        """{"busy_s", "window_s", "device_ops", "idle_gaps"}."""
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        w0 = w1 = None
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() == WINDOW:
                    w0, w1 = start, end
                else:
                    host.append((start, end, e.name()))
            elif not _annotation(e):
                dev.append((start, end, e.name()))
        if w0 is None or not dev:
            return {"busy_s": 0.0, "window_s": (w1 - w0) / 1e9 if w0 else 0.0,
                    "device_ops": [], "idle_gaps": []}
        by_name = defaultdict(int)
        for s, e, name in dev:
            by_name[name] += e - s
        iv = np.array([(max(s, w0), min(e, w1)) for s, e, _ in dev
                       if e > w0 and s < w1], dtype=np.int64)
        iv = iv[np.argsort(iv[:, 0])]
        # union of the intervals: a new run starts where a start passes the
        # furthest end so far
        reach = np.maximum.accumulate(iv[:, 1])
        new = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
        starts = iv[new, 0]
        ends = reach[np.concatenate([np.nonzero(new)[0][1:] - 1,
                                     [len(iv) - 1]])]
        busy = int((ends - starts).sum())
        gaps = np.stack([np.concatenate([[w0], ends]),
                         np.concatenate([starts, [w1]])], 1)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
                "device_ops": [[n, t / 1e9] for n, t in sorted(
                    by_name.items(), key=lambda x: -x[1])[:TOP]],
                "idle_gaps": self._label(gaps, host)}

    @staticmethod
    def _label(gaps, host):
        """Idle seconds by what the host was doing, the largest first."""
        if not len(gaps):
            return []
        host.sort()
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        order = np.argsort(-(gaps[:, 1] - gaps[:, 0]))
        total = defaultdict(int)
        count = defaultdict(int)
        for g in order[:LABELLED_GAPS]:
            g0, g1 = (int(x) for x in gaps[g])
            mid = (g0 + g1) // 2
            last = int(np.searchsorted(hs, mid, side="right")) - 1
            label = "host code"
            if last >= 0:
                label = "host code after " + host[last][2]
            # host events nest, so the latest begun that is still under
            # way is the innermost
            for i in range(last, max(last - LOOK_BACK, -1), -1):
                if he[i] >= mid:
                    label = host[i][2]
                    break
            total[label] += g1 - g0
            count[label] += 1
        rest = gaps[order[LABELLED_GAPS:]]
        if len(rest):
            total["shorter gaps"] += int((rest[:, 1] - rest[:, 0]).sum())
            count["shorter gaps"] += len(rest)
        return [[f"{name} (x{count[name]})", t / 1e9] for name, t in
                sorted(total.items(), key=lambda x: -x[1])[:TOP]]
