from gunrock_tpu_torch.graph.properties import GraphProperties, View  # noqa: F401
from gunrock_tpu_torch.graph.graph import Graph  # noqa: F401
from gunrock_tpu_torch.graph.build import build_graph, build_graph_from_arrays  # noqa: F401
