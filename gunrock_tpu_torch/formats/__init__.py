from gunrock_tpu_torch.formats.formats import (  # noqa: F401
    Coo,
    Csc,
    Csr,
    coo_to_csc,
    coo_to_csr,
    csr_to_coo,
    csr_to_csc,
    indices_to_offsets,
    offsets_to_indices,
)
