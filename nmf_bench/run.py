"""Runs one cell of the benchmark of pydnmfk_tpu_torch once, on the CUDA
card of the machine it starts on:

    python3 nmf_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets up (imports, kernel load or build
into build/pydnmfk_tpu_torch/, inputs made on the card from the seed, one
warm-up at the cell's shapes), measures for ``--seconds``, checks a sample
of the answers against the plain reference in nmf_bench/reference/, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics; with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error. Without a
card, or with a JAX module loaded, it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nmf_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result, checks = harness.run(a.workload, a.seed, a.seconds,
                                     bool(a.trace), T_START)
    except harness.RunError as e:
        print(f"nmf_bench: {e}", file=sys.stderr)
        return 2
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
