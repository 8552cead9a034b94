"""Each driver runs a whole cell end to end on the CPU at a tiny size, and
the result has the contract's keys; without a card, run.py prints no
result."""
import json
import subprocess
import sys
import time

import pytest

from conftest import REPO, tiny
from nmf_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_cpu(workload, trace):
    res, checks = harness.run(workload, 2 ** 31 + 7, 0.2, bool(trace),
                              time.perf_counter(), device="cpu",
                              overrides=tiny(workload))
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    man = harness.manifest()
    want = {m["name"] for m in harness.reported(man, workload, bool(trace))}
    # a CPU run has no device trace and no card memory to read
    device_only = {"roofline_pct", "device_idle_pct", "peak_mem_gib"}
    assert {m for m in want if m.split(".")[0] not in device_only} \
        == set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    assert [name for name, _, _ in checks] == list(res["checks"])
    json.dumps(res)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "nmf_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO / "build")})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
