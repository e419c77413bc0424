from dgl_operator_tpu_torch.ops.fanout import (  # noqa: F401
    fanout_agg, fanout_agg_plain, fanout_max, fanout_mean, fanout_sum)
from dgl_operator_tpu_torch.ops.gather import (  # noqa: F401
    gather_rows, gather_rows_plain)
from dgl_operator_tpu_torch.ops.scatter import (  # noqa: F401
    scatter_add_rows, scatter_add_rows_plain)
from dgl_operator_tpu_torch.ops.spmm import gspmm  # noqa: F401
from dgl_operator_tpu_torch.ops.sddmm import (  # noqa: F401
    gsddmm, u_add_v, u_dot_v, u_sub_v)
from dgl_operator_tpu_torch.ops.segment import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_softmax, segment_sum)
