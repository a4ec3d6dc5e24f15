"""The graph primitives of the port, one module each (as
``gunrock_tpu/algorithms``): a ``Result`` and a ``run(graph, ...)`` entry
point returning elapsed milliseconds, beside the kernels they compose."""

from gunrock_tpu_torch.algorithms import bfs  # noqa: F401
from gunrock_tpu_torch.algorithms import sssp  # noqa: F401
from gunrock_tpu_torch.algorithms import pr  # noqa: F401
from gunrock_tpu_torch.algorithms import spmv  # noqa: F401
from gunrock_tpu_torch.algorithms import hits  # noqa: F401
from gunrock_tpu_torch.algorithms import color  # noqa: F401
from gunrock_tpu_torch.algorithms import kcore  # noqa: F401
from gunrock_tpu_torch.algorithms import tc  # noqa: F401
from gunrock_tpu_torch.algorithms import bc  # noqa: F401
from gunrock_tpu_torch.algorithms import ppr  # noqa: F401
from gunrock_tpu_torch.algorithms import mst  # noqa: F401
from gunrock_tpu_torch.algorithms import geo  # noqa: F401
from gunrock_tpu_torch.algorithms import spgemm  # noqa: F401
