"""CLI parameter system for the examples (the part of
``gunrock_tpu/io/parameters.py`` the port's CLIs use, plus ``--device``).
``extra_args`` adds a CLI's own flags; they land on ``Parameters.extra``.
``--export_metrics`` writes the run's stats JSON (``utils/performance``)
into ``--json_dir``/``--json_file`` with the ``--tag`` tags."""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.ops.configs import (
    AdvanceDirection,
    LoadBalance,
    Options,
    default_options,
)


@dataclasses.dataclass
class Parameters:
    filename: str
    sources: str
    num_runs: int
    validate: bool
    export_metrics: bool
    json_dir: str
    json_file: str
    tags: list
    options: Options
    device: str
    reorder: str
    # the argparse namespace, with each CLI's own flags (extra_args)
    extra: object = None
    # set by examples.runner.load under --reorder degree
    # (graph/reorder.py Reordering)
    reordering: object = None


# algorithms whose CLI takes --src
_SOURCED = {"bfs", "sssp", "ppr", "bc"}


def build_parser(algorithm: str, extra_args=None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"gunrock_tpu_torch {algorithm}",
        description=f"{algorithm} example (PyTorch/CUDA port)",
    )
    p.add_argument("-m", "--market", required=True,
                   help="Matrix file (.mtx/.csr)")
    p.add_argument("--export_metrics", action="store_true",
                   help="export performance analysis metrics")
    p.add_argument("-d", "--json_dir", default=".", help="JSON output directory")
    p.add_argument("-f", "--json_file", default="", help="JSON output file")
    p.add_argument("-t", "--tag", default="",
                   help="comma-separated tags for the JSON output")
    p.add_argument("--device", default=DEFAULT,
                   help="torch device to run on (default: cuda; fails "
                   "without a card rather than falling back to the CPU)")
    p.add_argument("--advance_load_balance", default="default",
                   help="advance strategy (thread_mapped, block_mapped, "
                   "merge_path, xla_segment, pallas_merge_path; 'default' "
                   "picks the bucketed kernels)")
    p.add_argument("--advance_direction", default="default",
                   help="advance direction (forward, optimized; 'default' "
                   "picks optimized)")
    p.add_argument("-n", "--num_runs", type=int, default=1)
    p.add_argument("--reorder", default="none", choices=("none", "degree"),
                   help="vertex relabeling before execution (degree = "
                   "hub-first degree sort); --src ids and printed results "
                   "stay in the input id space")
    p.add_argument("--devices", type=int, default=0,
                   help="multi-device run: not ported yet (the JAX "
                   "package's parallel/ layer); 0/1 = one device")
    if algorithm in _SOURCED:
        p.add_argument("-s", "--src", default="",
                       help="source(s), comma-separated; random if omitted")
    p.add_argument("--validate", action="store_true", help="CPU validation")
    for args, kwargs in (extra_args or []):
        p.add_argument(*args, **kwargs)
    return p


def parse_source_string(source_str: str, n_vertices: int, n_runs: int) -> list[int]:
    """Comma-separated sources; one random source per run when empty."""
    if not source_str:
        rng = np.random.default_rng()
        return [int(rng.integers(0, n_vertices)) for _ in range(n_runs)]
    sources = []
    for tok in source_str.split(","):
        try:
            s = int(tok)
        except ValueError:
            print("Error: Invalid source")
            sys.exit(1)
        if not 0 <= s < n_vertices:
            print("Error: Invalid source")
            sys.exit(1)
        sources.append(s)
    if len(sources) == 1:
        sources = sources * n_runs
    return sources


def parse_tag_string(tag_str: str) -> list[str]:
    return [t for t in tag_str.split(",") if t]


def parse(algorithm: str, argv=None, extra_args=None) -> Parameters:
    parser = build_parser(algorithm, extra_args)
    ns = parser.parse_args(argv)
    if ns.devices > 1:
        parser.error("--devices: the multi-device layer (the JAX package's "
                     "parallel/) is not ported yet; run on one device")
    auto = default_options()
    options = Options(
        load_balance=auto.load_balance
        if ns.advance_load_balance == "default"
        else LoadBalance.parse(ns.advance_load_balance),
        advance_direction=auto.advance_direction
        if ns.advance_direction == "default"
        else AdvanceDirection(ns.advance_direction),
    )
    return Parameters(
        filename=ns.market,
        sources=getattr(ns, "src", ""),
        num_runs=ns.num_runs,
        validate=ns.validate,
        export_metrics=ns.export_metrics,
        json_dir=ns.json_dir,
        json_file=ns.json_file,
        tags=parse_tag_string(ns.tag),
        options=options,
        device=ns.device,
        reorder=ns.reorder,
        extra=ns,
    )
