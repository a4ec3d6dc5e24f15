"""Enactor/Problem skeleton (port of ``gunrock_tpu/framework``)."""

from gunrock_tpu_torch.framework.enactor import Enactor  # noqa: F401
from gunrock_tpu_torch.framework.problem import Problem  # noqa: F401
