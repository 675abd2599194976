"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
the device's busy time and a breakdown.  The last line of standard
output is one JSON object; the numbers the plain reference compared
close standard error and the result line (``checks``).  Exits non-zero
and prints no result without a CUDA card, or when JAX or the JAX
package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel and compile caches live in the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "cache",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.Cell(manifest, args.workload)
    import torch

    want = int(cell.spec["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < want:
        print(f"benchmark: needs {want} CUDA card(s); found {have}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    import speedseq_tpu_torch  # noqa: F401  the system under test
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
