"""Readings of the program and of its control, for setting a cell's limits.

    python3 portbench/control.py --workloads <cell>[,<cell>...] --seeds 1,2,3 \
        [--seconds 3] [--out FILE]

For each seed, the cells' graph is generated and loaded once (the cells
must share a configuration), and each cell runs set-up, a short window at
its own load and the check of as many answers as a benchmark run checks.
The control (the reference made to break a guarantee,
``portbench/check.py``) answers the same sources and is judged the same
way. One JSON line a cell and seed:
``{"workload", "seed", "queries", "program": {...}, "control": {...}}``.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(names, seed: int, seconds: float, device="cuda",
             configs: dict | None = None) -> list[dict]:
    """One reading row per cell of ``names`` for ``seed``. ``configs``
    overrides a cell's configuration by cell name (the tests' small
    sizes)."""
    from portbench.cell import Cell

    configs = configs or {}
    rows, first = [], None
    for name in names:
        cell = Cell(name, seed, device, config=configs.get(name))
        cell.setup_graph(shared=first)
        first = first or cell
        cell.setup_entry()
        queries, _, sampler = cell.window(seconds)
        answers = sampler.answers()
        csr = cell.reference()
        row = {"workload": name, "seed": seed, "queries": len(queries),
               "failed": cell.failed,
               "program": cell.verify(answers, csr),
               "control": cell.control(answers, csr)}
        rows.append(row)
        cell.state = None
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workloads", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    names = args.workloads.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            for row in readings(names, seed, args.seconds):
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
