from gunrock_tpu_torch.formats.formats import (  # noqa: F401
    Coo,
    Csc,
    Csr,
    coo_to_csr,
    csr_to_csc,
    offsets_to_indices,
)
