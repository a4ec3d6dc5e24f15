"""Frontier containers and the Enactor/Problem skeleton (port of
``gunrock_tpu/framework``)."""

from gunrock_tpu_torch.framework.frontier import (  # noqa: F401
    DenseFrontier,
    QueueFrontier,
    mask_to_queue,
    queue_to_mask,
)
from gunrock_tpu_torch.framework.enactor import Enactor  # noqa: F401
from gunrock_tpu_torch.framework.problem import Problem  # noqa: F401
