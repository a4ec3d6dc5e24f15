"""Regression battery of the port: every example CLI with ``--validate``
over the vendored graph families, and the recorded invariants of
``datasets/expected.json`` (the port's copy of ``datasets/regression.py``;
role of the reference's regression dataset suite, datasets/Makefile:5-11).

    python -m gunrock_tpu_torch.examples.regression                # the card
    python -m gunrock_tpu_torch.examples.regression --device cpu
    python -m gunrock_tpu_torch.examples.regression --families chesapeake,grid64

The families are the vendored chesapeake and deterministic synthetic
proxies for each structural class. The invariants (BFS depth and reach,
PageRank's top vertex, and on symmetric graphs the MST weight and the
triangle count) are computed with the port and checked with the JAX
battery's rule: exact, floats within 1e-3 * max(1, |v|). It prints one
line per CLI and family, and last one JSON line with each family's
seconds; it exits 1 if a CLI or an invariant fails.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io as _io
import json
import sys
import time
from pathlib import Path

import numpy as np

DATASETS = Path(__file__).resolve().parents[2] / "datasets"
EXPECTED = DATASETS / "expected.json"

# family -> its mtx file in datasets/ (all vendored)
FAMILIES = {
    # real graph (SuiteSparse chesapeake)
    "chesapeake": "chesapeake.mtx",
    # power-law / scale-free (soc-* proxy)
    "rmat12": "rmat12.mtx",
    "rmat12_sym": "rmat12_sym.mtx",
    # planar mesh / road-like (delaunay_n* proxy; long diameter)
    "delaunay2k": "delaunay2k.mtx",
    # community structure (coAuthorsDBLP proxy)
    "sbm2k": "sbm2k.mtx",
    # lattice road network
    "grid64": "grid64.mtx",
    # bipartite web-style (cit-Patents / webbase proxy; directed)
    "bipartite2k": "bipartite2k.mtx",
}
DIRECTED_FAMILIES = ("rmat12", "bipartite2k")

# CLI battery per family: symmetric families run the full set; directed
# families skip the undirected-only algorithms
FULL = [
    ("bfs", ["--src", "0", "--validate"]),
    ("sssp", ["--src", "0", "--validate"]),
    ("pr", ["--validate"]),
    ("bc", ["--src", "0", "--validate"]),
    ("color", ["--validate"]),
    ("color", ["--validate", "--strategy", "greedy"]),
    ("kcore", ["--validate"]),
    ("tc", ["--validate"]),
    ("spmv", ["--validate"]),
    ("hits", ["--validate", "--max_iterations", "20"]),
    ("mst", ["--validate"]),
    ("ppr", ["--src", "0", "--validate"]),
    ("geo", ["--spatial_iterations", "25", "--validate"]),
    ("spgemm", ["--validate"]),
]
DIRECTED = [
    ("bfs", ["--src", "0", "--validate"]),
    ("sssp", ["--src", "0", "--validate"]),
    ("pr", ["--validate"]),
    ("spmv", ["--validate"]),
    ("hits", ["--validate", "--max_iterations", "20"]),
    ("ppr", ["--src", "0"]),
    ("spgemm", ["--validate"]),
    ("tc", ["--validate"]),  # directed input: symmetrized semantics
]


def run_cli(algo: str, argv: list) -> tuple[bool, str]:
    """Drive the port's example ``main()`` in process; it fails on a
    non-zero return or exit, or a 'FAILED' line."""
    mod = importlib.import_module(f"gunrock_tpu_torch.examples.{algo}")
    buf = _io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
    except SystemExit as e:  # argparse errors, sys.exit in a CLI
        rc = e.code
    out = buf.getvalue()
    return not rc and "FAILED" not in out, out


def invariants(path: Path, device) -> dict:
    """Per-graph result fingerprints, computed with the port on
    ``device``."""
    from gunrock_tpu_torch.algorithms import bfs, mst, pr, tc
    from gunrock_tpu_torch.io import load_graph_file
    from gunrock_tpu_torch.utils.limits import UNREACHED

    g, props = load_graph_file(path, device=device)
    inv = {"n_vertices": int(g.n_vertices), "n_edges": int(g.n_edges)}
    d = bfs.run(g, 0, warmup=False, device=device).distances.cpu().numpy()
    reached = d[d != UNREACHED]
    inv["bfs_depth"] = int(reached.max()) if reached.size else 0
    inv["bfs_reached"] = int(reached.size)
    p = pr.run(g, warmup=False, device=device).p.cpu().numpy()
    inv["pr_top_vertex"] = int(np.argmax(p))
    if props.symmetric:
        inv["mst_weight"] = round(
            float(mst.run(g, warmup=False, device=device).mst_weight), 4)
        inv["n_triangles"] = int(
            tc.run(g, warmup=False, device=device).n_triangles)
    return inv


def matches(want, got) -> bool:
    """The JAX battery's rule: exact, floats within 1e-3 * max(1, |v|)."""
    if isinstance(want, float):
        return got is not None and abs(got - want) <= 1e-3 * max(1.0, abs(want))
    return got == want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated subset")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every CLI and invariant (default: "
                    "cuda; fails without a card)")
    ns = ap.parse_args(argv)
    names = [f for f in ns.families.split(",") if f]
    unknown = sorted(set(names) - set(FAMILIES))
    if unknown:
        ap.error(f"unknown families {unknown}")
    want_all = json.loads(EXPECTED.read_text())

    failures, seconds, recorded = [], {}, {}
    for fam in names:
        t_fam = time.perf_counter()
        path = DATASETS / FAMILIES[fam]
        battery = DIRECTED if fam in DIRECTED_FAMILIES else FULL
        for algo, extra in battery:
            t0 = time.perf_counter()
            ok, out = run_cli(algo, ["--market", str(path), "--device",
                                     ns.device] + extra)
            mark = "ok" if ok else "FAIL"
            print(f"[{fam}] {algo} {' '.join(extra)}: {mark} "
                  f"({time.perf_counter() - t0:.1f}s)")
            if not ok:
                failures.append((fam, algo, out[-800:]))
        recorded[fam] = invariants(path, ns.device)
        print(f"[{fam}] invariants: {recorded[fam]}")
        for k, v in want_all.get(fam, {}).items():
            got = recorded[fam].get(k)
            if not matches(v, got):
                failures.append((fam, f"invariant {k}", f"want {v} got {got}"))
                print(f"[{fam}] invariant {k}: FAIL (want {v}, got {got})")
        seconds[fam] = time.perf_counter() - t_fam

    for fam, what, detail in failures:
        print(f"--- {fam} / {what} ---\n{detail}\n")
    print(f"regression suite {'FAILED' if failures else 'PASSED'} "
          f"({len(names)} families, {len(failures)} failures)")
    print(json.dumps({"regression": {
        "device": ns.device, "failures": len(failures), "seconds": seconds,
        "invariants": recorded}}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
