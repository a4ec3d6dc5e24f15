from gunrock_tpu_torch.utils.limits import (  # noqa: F401
    invalid,
    is_valid,
    INVALID_VERTEX,
    INVALID_EDGE,
)
