"""Entry points of the port, run as
``python -m dgl_operator_tpu_torch.examples.<name>``."""
