"""On the card (skipped without one): each cell end to end through the
kernels, at its configuration's ``cpu_control`` sizes (those at which the
control comes out not correct, ``test_bench_control.py``), with the device
trace read. Run on the chip machine:

    python -m pytest nmf_bench/tests -q -m gpu
"""
import time

import pytest

from nmf_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    cfg = harness.load_json("configs", harness.cell(workload)["config"])
    res, _ = harness.run(workload, 2 ** 31 + 11, 1.0, True,
                         time.perf_counter(), device=str(card),
                         overrides={"config": cfg["cpu_control"]})
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
    for m in res["metrics"].values():
        assert 0 < m["value"] and (m["unit"] != "%" or m["value"] <= 100)
