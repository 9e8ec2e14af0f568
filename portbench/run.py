"""The benchmark of tpu_cypher_torch on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line on standard output is the run's JSON result; the last lines
on standard error are the numbers its correctness check compared, each with
its limit. A run without a CUDA card, or with fewer cards than the cell
asks for, exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".portbench_cache" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import Bench, run

    return run(Bench(ROOT), args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
