"""No module that a run loads is JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the program either."""
import json
import subprocess
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "pydnmfk_tpu"}


def loaded(*modules):
    code = ("import importlib, json, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_path_loads_no_jax():
    import nmf_bench.harness as h
    names = ["nmf_bench.harness", "nmf_bench.trace", "nmf_bench.control",
             "pydnmfk_tpu_torch", "pydnmfk_tpu_torch.utils.timing",
             "pydnmfk_tpu_torch.utils.plotting"]
    man = h.manifest()
    for w in man["workloads"]:
        names.append("nmf_bench.drivers."
                     + h.load_json("traffic", w["traffic"])["driver"])
    for m in man["end_to_end"] + man["per_layer"]:
        names.append(h.metric_reader(m["name"]).__name__)
    got = loaded(*names)
    assert "pydnmfk_tpu_torch" in got and not got & FORBIDDEN


@pytest.mark.parametrize("module", ["nmf_bench.reference.nmf",
                                    "nmf_bench.reference.nmfk",
                                    "nmf_bench.reference.compare"])
def test_the_reference_loads_nothing_of_the_program(module):
    got = loaded(module)
    assert not got & (FORBIDDEN | {"pydnmfk_tpu_torch"})


def test_a_run_refuses_a_loaded_jax_package(monkeypatch):
    from nmf_bench import harness
    monkeypatch.setitem(sys.modules, "pydnmfk_tpu.models", object())
    with pytest.raises(harness.RunError, match="pydnmfk_tpu"):
        harness._no_forbidden()
    monkeypatch.delitem(sys.modules, "pydnmfk_tpu.models")
    monkeypatch.setitem(sys.modules, "pydnmfk_tpu_torch_extra", object())
    harness._no_forbidden()
