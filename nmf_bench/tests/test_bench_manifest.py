"""BENCHMARK.json keeps to the benchmark's contract, and every entry
resolves to its files by name; a new cell and metric need only new files
and entries."""
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import REPO, tiny
from nmf_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_contract_shape():
    man = harness.manifest()
    assert set(man) == TOP_KEYS
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and (REPO / p).is_dir()
    assert 1 <= len(man["command"]) <= 32 and all(map(line, man["command"]))
    assert 1 <= man["run_seconds"] <= 51
    cells = man["workloads"]
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(cells) <= 24
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(man["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert any(w["config"] == c["name"] for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    metrics = man["end_to_end"] + man["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    setup = [m for m in man["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    e2e = {m["name"] for m in man["end_to_end"]}
    layers = {}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        ends = harness.reported(man, w["name"], False)
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        per = harness.reported(man, w["name"], True)
        assert per and {m["moves"] for m in per} <= {m["name"] for m in ends}


def test_entries_resolve_by_name():
    man = harness.manifest()
    for c in man["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert c["file"] == f"nmf_bench/configs/{c['name']}.json"
        assert set(cfg["cpu_rehearsal"]) <= set(cfg)
    for w in man["workloads"]:
        traffic = harness.load_json("traffic", w["traffic"])
        driver = harness.module("drivers", traffic["driver"])
        assert hasattr(driver, "Driver")
        limits = harness.load_json("limits", w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


NEW_METRIC = '''"""Fits completed in the window (an added reader)."""


def read(run):
    return float(run["units"])
'''


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell, its
    limits and a metric by new files and new entries alone, runs them, and
    its fault test takes the new cell in."""
    shutil.copytree(REPO / "nmf_bench", tmp_path / "nmf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "nmf_bench").rglob("*")
              if p.is_file()}
    man = harness.manifest()
    bench = tmp_path / "nmf_bench"
    cfg = json.loads((REPO / man["configs"][0]["file"]).read_text())
    cfg["source"] = "an added configuration"
    (bench / "configs" / "added_config.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": "added_config", "source": cfg["source"],
                           "file": "nmf_bench/configs/added_config.json",
                           "reduced": cfg["reduced"],
                           "why": "an added configuration"})
    man["workloads"].append({"name": "strong_fro_f32_again",
                             "config": "added_config",
                             "traffic": "fro_solves_again", "chips": 1,
                             "why": "an added cell"})
    man["per_layer"].append({"name": "fits_done", "unit": "fits",
                             "better": "higher", "source": "host_clock",
                             "layer": "nmf solve",
                             "moves": "solve_itr_per_s",
                             "workloads": ["strong_fro_f32_again"]})
    man["end_to_end"][0]["workloads"].append("strong_fro_f32_again")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    shutil.copy(bench / "traffic" / "fro_solves.json",
                bench / "traffic" / "fro_solves_again.json")
    shutil.copy(bench / "limits" / "strong_fro_f32.json",
                bench / "limits" / "strong_fro_f32_again.json")
    (bench / "metrics" / "fits_done.py").write_text(NEW_METRIC)
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "from nmf_bench import harness\n"
        "res, _ = harness.run('strong_fro_f32_again', 5, 0.2, True,\n"
        "    time.perf_counter(), device='cpu',\n"
        f"    overrides={tiny('strong_fro_f32')!r})\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["fits_done"]["value"] >= 1
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "nmf_bench/tests/test_bench_faults.py"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "strong_fro_f32_again-unchanged_step" in out.stdout
    assert {p: p.read_bytes() for p in before} == before
