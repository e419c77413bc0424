from dgl_operator_tpu_torch.ops.fanout import (  # noqa: F401
    fanout_agg, fanout_agg_plain, fanout_max, fanout_mean, fanout_sum)
from dgl_operator_tpu_torch.ops.gather import (  # noqa: F401
    gather_rows, gather_rows_plain)
from dgl_operator_tpu_torch.ops.scatter import (  # noqa: F401
    scatter_add_rows, scatter_add_rows_plain)
from dgl_operator_tpu_torch.ops.spmm import gspmm  # noqa: F401
