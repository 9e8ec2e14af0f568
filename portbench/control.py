"""The control of a cell's correctness check, on the cell's own graph.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the run's graph and parameters as a run of the cell
does, works out each query's reference answer and its control answer (the
reference with one of the configuration's guarantees broken: an approximate
DISTINCT or a closing KNOWS matched on 32-bit hashes of their keys, walks
that reuse a relationship; see each query kind's ``control``), and prints,
per seed, the number that the run compares (``wrong_answers``) as it would
read with the control in the program's place over the first ``--queries``
queries of the run's order. The benchmark's runs do not run it; it needs no
program, only the reference's device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(bench, cell_name: str, seed: int, device: str, queries: int) -> dict:
    from portbench.harness import schedule
    from portbench.refctx import Context, seed_rng

    cell = bench.cell(cell_name)
    mix = bench.mix(cell["traffic"])
    kinds = {k["query"]: bench.query(k["query"]) for k in mix["kinds"]}
    ctx = Context.for_run(bench.config(cell["config"]), mix, seed, device=device)
    params = {k: m.params(ctx) for k, m in kinds.items()}
    order = schedule(mix["kinds"], params, seed_rng(seed, 0x0D3E))
    items = [next(order) for _ in range(queries)]
    t = time.perf_counter()
    rows, wrong = [], 0
    for kind, j in items:
        p = params[kind][j]
        ref, ctl = kinds[kind].reference(ctx, p), kinds[kind].control(ctx, p)
        wrong += int(ref != ctl)
        rows.append({"kind": kind, "params": p, "reference": ref, "control": ctl})
    return {"cell": cell_name, "seed": seed, "wrong_answers": wrong, "answers": len(items),
            "seconds": time.perf_counter() - t, "items": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--queries", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import Bench

    bench = Bench(ROOT)
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, args.device, args.queries)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
