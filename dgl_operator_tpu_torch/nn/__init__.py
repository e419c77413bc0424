from dgl_operator_tpu_torch.nn.conv import (  # noqa: F401
    FanoutGATConv, FanoutGATv2Conv, FanoutSAGEConv, GATConv, GATv2Conv,
    GraphConv)
