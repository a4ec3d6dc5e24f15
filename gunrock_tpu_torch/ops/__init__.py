"""The operators (port of ``gunrock_tpu/ops``): advance, filter,
parallel_for, uniquify, neighbor_reduce and batch over the frontier
containers of ``framework/frontier.py``, with their strategy enums."""

from gunrock_tpu_torch.ops.configs import (  # noqa: F401
    LoadBalance,
    AdvanceDirection,
    AdvanceIO,
    FilterAlgorithm,
    UniquifyAlgorithm,
)
from gunrock_tpu_torch.ops.advance import advance, edge_map_reduce  # noqa: F401
from gunrock_tpu_torch.ops.filter import filter_mask, filter_queue  # noqa: F401
from gunrock_tpu_torch.ops.parallel_for import for_each_vertex, for_each_edge  # noqa: F401
from gunrock_tpu_torch.ops.uniquify import uniquify  # noqa: F401
from gunrock_tpu_torch.ops.neighbor_reduce import neighbor_reduce  # noqa: F401
from gunrock_tpu_torch.ops.batch import batch  # noqa: F401
