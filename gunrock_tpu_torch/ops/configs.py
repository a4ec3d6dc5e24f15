"""Operator configuration enums (copy of ``gunrock_tpu/ops/configs.py``).

The enum names stay the JAX package's so options read the same in both.
``PALLAS_MERGE_PATH`` names the bucketed-layout kernels, which in the port
are the CUDA kernels of ``ops/kernels`` (their plain PyTorch versions on
the CPU).
"""

from __future__ import annotations

import dataclasses
import enum


class LoadBalance(enum.Enum):
    XLA_SEGMENT = "xla_segment"  # plain tensor ops: gather + segment reduce
    PALLAS_MERGE_PATH = "pallas_merge_path"  # bucketed-layout kernels
    BUCKETING = "bucketing"
    # aliases accepted for CLI parity with the reference flag values
    THREAD_MAPPED = "thread_mapped"
    BLOCK_MAPPED = "block_mapped"
    MERGE_PATH = "merge_path"

    @staticmethod
    def parse(name: str) -> "LoadBalance":
        name = name.strip().lower()
        aliases = {
            "thread_mapped": LoadBalance.XLA_SEGMENT,
            "block_mapped": LoadBalance.XLA_SEGMENT,
            "merge_path": LoadBalance.PALLAS_MERGE_PATH,
            "merge_path_v2": LoadBalance.PALLAS_MERGE_PATH,
            "xla_segment": LoadBalance.XLA_SEGMENT,
            "pallas_merge_path": LoadBalance.PALLAS_MERGE_PATH,
            "bucketing": LoadBalance.BUCKETING,
        }
        if name not in aliases:
            raise ValueError(f"unknown load balance strategy {name!r}")
        return aliases[name]


class AdvanceDirection(enum.Enum):
    """Reference advance_direction_t (configs.hxx:78-82)."""

    FORWARD = "forward"
    BACKWARD = "backward"
    OPTIMIZED = "optimized"  # direction-optimizing (choose per iteration)


class AdvanceIO(enum.Enum):
    """Reference advance_io_type_t (configs.hxx:66-71)."""

    GRAPH = "graph"  # input = all vertices
    VERTICES = "vertices"
    EDGES = "edges"
    NONE = "none"  # no output frontier


class FilterAlgorithm(enum.Enum):
    """Reference filter_algorithm_t (configs.hxx:85-92)."""

    BYPASS = "bypass"  # mark-invalid in place, no compaction
    PREDICATED = "predicated"  # compaction (copy_if analog)
    REMOVE = "remove"  # remove_copy_if analog (same as predicated here)

    @staticmethod
    def parse(name: str) -> "FilterAlgorithm":
        name = name.strip().lower()
        aliases = {
            "bypass": FilterAlgorithm.BYPASS,
            "predicated": FilterAlgorithm.PREDICATED,
            "remove": FilterAlgorithm.REMOVE,
            "compact": FilterAlgorithm.PREDICATED,  # dead in reference too
        }
        if name not in aliases:
            raise ValueError(f"unknown filter algorithm {name!r}")
        return aliases[name]


class UniquifyAlgorithm(enum.Enum):
    """Reference uniquify_algorithm_t (configs.hxx:95-99)."""

    UNIQUE = "unique"  # sort + adjacent dedup (exact)
    UNIQUE_COPY = "unique_copy"
    SCATTER = "scatter"  # first occurrence per vertex, queue order kept


def default_options() -> "Options":
    """The port's main path on every device: the bucketed kernels and
    direction-optimizing traversal. (The JAX package falls back to its XLA
    path on the CPU because Pallas is interpreted there; the port's CPU
    path is the kernels' plain versions, so the CPU tests run the same
    path as the card.)"""
    return Options(
        load_balance=LoadBalance.PALLAS_MERGE_PATH,
        advance_direction=AdvanceDirection.OPTIMIZED,
    )


@dataclasses.dataclass
class Options:
    """Operator-strategy configuration threaded through ``run()``."""

    load_balance: LoadBalance = LoadBalance.XLA_SEGMENT
    advance_direction: AdvanceDirection = AdvanceDirection.FORWARD
    filter_algorithm: FilterAlgorithm = FilterAlgorithm.BYPASS
    uniquify_algorithm: UniquifyAlgorithm = UniquifyAlgorithm.SCATTER
    enable_filter: bool = True
    enable_uniquify: bool = False
    best_effort_uniquify: bool = False
    uniquify_percent: float = 100.0
    max_iterations: int = 0  # 0 = algorithm default
