from dgl_operator_tpu_torch.models.sage import (  # noqa: F401
    DistSAGE, sage_inference, state_dict_from_flax, state_dict_to_flax)
