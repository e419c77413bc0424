from dgl_operator_tpu_torch.ops.fanout import (  # noqa: F401
    fanout_agg, fanout_agg_plain, fanout_max, fanout_mean, fanout_sum)
