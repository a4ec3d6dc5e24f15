"""Graph-file loader with extension sniffing (copy of
``gunrock_tpu/io/loader.py``): .mtx, .smtx and the binary .csr cache."""

from __future__ import annotations

from pathlib import Path

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.formats import Csr, coo_to_csr
from gunrock_tpu_torch.graph import Graph, build_graph
from gunrock_tpu_torch.graph.properties import GraphProperties


def is_market(path: str | Path) -> bool:
    s = str(path)
    return s.endswith(".mtx") or s.endswith(".mtx.gz") or s.endswith(".mm")


def is_binary_csr(path: str | Path) -> bool:
    return str(path).endswith(".csr")


def is_smtx(path: str | Path) -> bool:
    return str(path).endswith(".smtx")


def extract_filename(path: str | Path) -> str:
    return Path(path).name


def extract_dataset(filename: str) -> str:
    """Dataset name = filename stem (reference util/filepath.hxx)."""
    name = filename
    for suffix in (".gz", ".mtx", ".csr", ".smtx", ".mm"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


def load_graph_file(
    path: str | Path,
    properties: GraphProperties | None = None,
    device=DEFAULT,
) -> tuple[Graph, GraphProperties]:
    """Load a .mtx (.mtx.gz, .mm), .smtx or binary .csr file into a Graph
    on ``device``."""
    device = resolve(device)  # fail before parsing when there is no card
    path = Path(path)
    if is_binary_csr(path):
        props = properties or GraphProperties(directed=True, weighted=True)
        return build_graph(Csr.read_binary(path), props, device), props
    if is_smtx(path):
        from gunrock_tpu_torch.io.smtx import load_smtx

        props = properties or GraphProperties(directed=True, weighted=True)
        return build_graph(load_smtx(path), props, device), props
    if is_market(path):
        from gunrock_tpu_torch.io.matrix_market import load_matrix_market

        props, coo = load_matrix_market(path)
        if properties is not None:
            props = properties
        return build_graph(coo_to_csr(coo), props, device), props
    raise ValueError(f"unrecognized graph file extension: {path}")
