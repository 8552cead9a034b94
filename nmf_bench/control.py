"""The readings that a cell's limits are set from, at the cell's own size:
for each seed, the program against the reference (sound runs) and the
control, the reference in TF32 against the reference in float32.

    python3 nmf_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--sound-only]

One process: each seed sets the cell up anew, runs ``--seconds`` of its
traffic (0: one fit or one sweep) and prints one JSON line of readings;
the last line holds, for each number, the largest sound reading and the
smallest control reading (``--sound-only``: the sound readings alone,
for a lower reading on more seeds). The benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nmf_bench import harness  # noqa: E402
from nmf_bench.reference import compare  # noqa: E402


def readings(workload, seed, seconds, device="cuda", overrides=None,
             sound=True, control=True) -> dict:
    """One seed's readings: unless not ``control`` the control's, and
    unless not ``sound`` the program's; a sweep's also by k."""
    _, driver = harness.load_cell(workload, seed, device, overrides)
    try:
        driver.setup()
        driver.run(seconds)
        driver.release()
        out = {"seed": seed}
        if sound:
            t = time.perf_counter()
            out["sound"] = compare.worst(driver.check())
            out["check_s"] = time.perf_counter() - t
            out["sound_by_k"] = getattr(driver, "by_k", None)
        if control:
            t = time.perf_counter()
            out["control"] = compare.worst(driver.control())
            out["control_s"] = time.perf_counter() - t
            out["control_by_k"] = getattr(driver, "by_k", None)
        return out
    finally:
        driver.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--sound-only", action="store_true")
    a = p.parse_args(argv)
    sound, ctrl = {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        r = readings(a.workload, seed, a.seconds,
                     control=not a.sound_only)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        for name, v in r["sound"].items():
            sound[name] = max(sound.get(name, 0.0), v)
        for name, v in r.get("control", {}).items():
            ctrl[name] = min(ctrl.get(name, float("inf")), v)
    print(json.dumps({"workload": a.workload, "largest_sound": sound,
                      "smallest_control": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
