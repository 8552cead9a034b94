"""A run whose timed path is broken underneath comes out not correct: the
harness runs on the CPU at a tiny size (skipping its look for a card) with
one fault planted in the program, for each fault that a cell can have. A
cell's faults are its traffic's driver's, ``bench_faults/<driver>.py``."""
import importlib
import time

import pytest

from conftest import tiny
from nmf_bench import harness


def faults(workload):
    traffic = harness.load_json("traffic", harness.cell(workload)["traffic"])
    return importlib.import_module(
        f"bench_faults.{traffic['driver']}").FAULTS


CASES = [(w["name"], f) for w in harness.manifest()["workloads"]
         for f in faults(w["name"])]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res, checks = harness.run(workload, 2 ** 31 + 99, 0.1, False,
                              time.perf_counter(), device="cpu",
                              overrides=tiny(workload))
    assert res["correct"] is False and res["failed"] >= 1
    assert any(v > lim for _, v, lim in checks)
