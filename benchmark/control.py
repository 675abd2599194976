"""The control of a cell, run on the card: the cell's jobs at its own
size, judged with the control switched on (``align``: the duplicate
marking left out; ``var``/``somatic``: genotype likelihoods in bfloat16
in the program's place).  It has to come out not correct; the numbers it
prints are the upper readings the limits are set below.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]

Each seed runs one job (a one-second window).  The benchmark's own runs
never run it."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_manifest(), args.workload)
    for seed in args.seed:
        r = harness.run_cell(cell, seed, 1.0, False, "cuda",
                             time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
