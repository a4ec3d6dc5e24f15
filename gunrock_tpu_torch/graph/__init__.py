from gunrock_tpu_torch.graph.build import build_graph  # noqa: F401
from gunrock_tpu_torch.graph.graph import Graph  # noqa: F401
from gunrock_tpu_torch.graph.properties import GraphProperties  # noqa: F401
