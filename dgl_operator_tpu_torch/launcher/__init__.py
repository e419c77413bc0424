"""The launcher's trainer-side pieces: the chaos plan
(:mod:`~dgl_operator_tpu_torch.launcher.chaos`). The launcher itself
(``tpurun``'s five phases, its fabric and retry layer) is not ported
(``ROADMAP.md`` item 7)."""
