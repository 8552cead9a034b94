"""One run of one cell, found by name: the cell in ``BENCHMARK.json``, its
configuration ``configs/<config>.json``, its traffic ``traffic/<traffic>.json``
(which names its driver, ``drivers/<driver>.py``), its limits
``limits/<cell>.json`` and one reader a metric, ``metrics/<metric>.py``.
A cell, a mix or a metric is added by adding files and entries alone.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .reference import compare

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pydnmfk_tpu")


class RunError(RuntimeError):
    """A run that must print no result."""


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def module(kind: str, name: str):
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<base>.py`` for a name
    ``<base>.<suffix>``."""
    file = name if (HERE / "metrics" / f"{name}.py").exists() \
        else name.split(".")[0]
    return module("metrics", file)


def cell(name: str, man: dict | None = None) -> dict:
    for w in (man or manifest())["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in {MANIFEST.name}")


def reported(man: dict, name: str, trace: bool) -> list:
    """The metrics that the cell ``name`` reports: end to end with
    ``--trace 0``, per layer with ``--trace 1``."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moves
                             else [])]


def load_cell(workload: str, seed: int, device: str,
              overrides: dict | None = None, man: dict | None = None):
    """The cell's entry and its driver, given its configuration and
    traffic, each updated by ``overrides["config"]`` and
    ``overrides["traffic"]`` (the tests' small sizes)."""
    w = cell(workload, man)
    cfg = load_json("configs", w["config"])
    traffic = load_json("traffic", w["traffic"])
    cfg.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    driver = module("drivers", traffic["driver"]).Driver(cfg, traffic, seed,
                                                        device)
    return w, driver


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def _no_forbidden():
    found = forbidden_modules()
    if found:
        raise RunError("modules that no run may load are loaded: "
                       + ", ".join(found))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", overrides: dict | None = None
        ) -> tuple:
    """Set-up, the measured window and the check of one run. Returns the
    result's line (a dict) and the checks [(name, value, limit)]."""
    man = manifest()
    w, driver = load_cell(workload, seed, device, overrides, man)
    limits = load_json("limits", w["name"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < w["chips"]):
        raise RunError(f"{workload} needs {w['chips']} CUDA card(s); "
                       f"found {torch.cuda.device_count()}")
    try:
        driver.setup()
        _sync(dev)
        rec = {"setup_s": time.perf_counter() - t_start}
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        tracer = None
        if trace:
            from .trace import DeviceTrace
            tracer = DeviceTrace()
            with tracer.window():
                rec.update(driver.run(seconds, tracing=True))
        else:
            rec.update(driver.run(seconds))
        _sync(dev)
        rec["window_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if cuda else 0)
        _no_forbidden()
        breakdown = None
        if tracer is not None:
            red = tracer.reduce()
            tracer = None
            rec["busy_s"], rec["trace_window_s"] = (red["busy_s"],
                                                    red["window_s"])
            breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
        driver.release()
        readings = driver.check()
    finally:
        driver.close()
    worst = compare.worst(readings)
    checks = [(name, worst.get(name, float("inf")), float(limit))
              for name, limit in limits.items()]
    failed = sum(any(r.get(n, float("inf")) > lim
                     for n, _, lim in checks) for r in readings)
    metrics = {}
    for m in reported(man, workload, trace):
        value = metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": w["chips"],
            "memory_peak_bytes": int(max(setup_peak,
                                         rec["window_peak_bytes"]))}
    if cuda:
        info["power_limit"] = _power_limit()
    if trace:
        info["busy_s"] = rec.get("busy_s", 0.0)
        info["window_s"] = rec.get("trace_window_s", 0.0)
    result = {"correct": failed == 0 and all(v <= lim for _, v, lim in
                                              checks),
              "attempted": rec["units"], "failed": failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    _no_forbidden()
    return result, checks
