"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 benchmark/control.py --workload avalanche20k-batch \
        --seconds 5 --seeds 11 12 13

For each seed, in one process: a run of the cell (``run.run_cell``, a
short window), the numbers of the program against the reference, and the
numbers of the control, the reference computed in bfloat16, put in the
program's place on the same kept calls, each with its verdict against
the configuration's limits (``check.verdict``: the control's has to be
false).  One JSON line a seed on standard output.  Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, _, config, _ = run.load_cell(run.ROOT, args.workload)
    for seed in args.seeds:
        result, _ = run.run_cell(run.ROOT, args.workload, seed, args.seconds,
                                 False, control=True)
        control = dict(result["control"], build_gap=0.0)
        control_correct, lines = check.verdict(control, config["limits"])
        for line in lines:
            print(f"# seed {seed} control: {line}", file=sys.stderr)
        print(json.dumps(dict(
            seed=seed, correct=result["correct"],
            program=result["numbers"], control=result["control"],
            control_correct=control_correct, failed=result["failed"],
            attempted=result["attempted"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
