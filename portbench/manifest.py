"""Finds a cell's files by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json`` and the generator it names
``generators/<generator>.py``; a traffic mix is ``traffic/<traffic>.json``,
the entry point it names ``entries/<entry>.py``, and the kind of answer
that entry gives (its check, control and work) ``kinds/<kind>.py``; a
metric's reader is ``metrics/<metric>.py``, or ``metrics/<stem>.py`` for
a metric named ``<stem>.<anything>``; a cell's limits are
``checks/<cell>.json``. All sit under this directory. Adding a
cell, a mix or a metric is adding such files and entries in
``BENCHMARK.json``; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "checks" / f"{cell}.json")["limits"]


def _module(path: Path, kind: str):
    """The module in ``path``, loaded under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"portbench_{kind}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return _module(HERE / "entries" / f"{name}.py", "entry")


def kind(name: str):
    return _module(HERE / "kinds" / f"{name}.py", "kind")


def generator(name: str):
    return _module(HERE / "generators" / f"{name}.py", "generator")


def reader_path(metric: str) -> Path:
    """The reader of ``metric``: ``metrics/<metric>.py``, else that of the
    part before the first dot (one reader serves ``mteps.<cell>`` for
    every cell)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def reader(metric: str):
    return _module(reader_path(metric), "metric")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it; a metric with a ``workloads``
    key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
