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
    max_iterations: int = 0  # 0 = algorithm default
