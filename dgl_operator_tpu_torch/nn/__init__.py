from dgl_operator_tpu_torch.nn.conv import (  # noqa: F401
    FanoutGATConv, FanoutGATv2Conv, FanoutSAGEConv, GATConv, GATv2Conv,
    GraphConv, SAGEConv, WeightedSAGEConv)
from dgl_operator_tpu_torch.nn.predictors import (  # noqa: F401
    DotPredictor, MLPPredictor)
