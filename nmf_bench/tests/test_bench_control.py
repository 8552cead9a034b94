"""Each cell's control, the plain reference in TF32 (the precision below
the configurations' float32; on the CPU each product's operands rounded to
TF32) put in the program's place, comes out not correct against the cell's
limits, at the configuration's ``cpu_control`` sizes. On the card the
control runs at the cell's own size: ``nmf_bench/control.py``."""
import pytest

from nmf_bench import control, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    cfg = harness.load_json("configs", harness.cell(workload)["config"])
    limits = harness.load_json("limits", workload)
    got = control.readings(workload, 2 ** 31 + 3, 0.0, "cpu",
                           {"config": cfg["cpu_control"]}, sound=False)
    assert any(got["control"][name] > limit
               for name, limit in limits.items()), got["control"]
