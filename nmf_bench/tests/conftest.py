"""The benchmark's own tests: CPU ones at tiny sizes, and those marked
``gpu``, which skip without a CUDA card (decided inside the test).

    python -m pytest nmf_bench/tests -q
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))



def tiny(workload, **traffic):
    """The overrides that shrink a cell to a CPU run: its configuration's
    ``cpu_rehearsal`` sizes."""
    from nmf_bench import harness
    cfg = harness.load_json("configs", harness.cell(workload)["config"])
    return {"config": dict(cfg["cpu_rehearsal"]), "traffic": traffic}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
