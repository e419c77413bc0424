from dgl_operator_tpu_torch.nn.conv import FanoutSAGEConv  # noqa: F401
