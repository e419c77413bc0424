"""The benchmark of the PyTorch and CUDA port (``dgl_operator_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell and prints one JSON result line; see
``README.md``. Everything that belongs to one configuration, traffic
mix, model kind or metric sits in a file of its own that the harness
finds by name.
"""
