from gunrock_tpu_torch.io.generators import grid2d_graph, rmat_graph  # noqa: F401
from gunrock_tpu_torch.io.loader import load_graph_file  # noqa: F401
from gunrock_tpu_torch.io.matrix_market import load_matrix_market  # noqa: F401
from gunrock_tpu_torch.io.smtx import load_smtx  # noqa: F401
from gunrock_tpu_torch.io import sample  # noqa: F401
