"""PyTorch/CUDA port of ``dgl_operator_tpu``.

Subpackages mirror the JAX package module for module (``graph/``,
``ops/``, ``nn/``, ``models/``, ``runtime/``, ``parallel/``,
``serve/``, ``obs/``), so each counterpart is found by path. The port
imports nothing of the JAX package: code it shares with it is kept here
as its own copy. Hand-written CUDA kernels live in ``csrc/`` and are
built with ``nvcc`` at first use (``ops/_build.py``); the host graph
core under the sampler and the partitioner, ``native/graphcore.cc``,
is built there too, with the host C++ compiler.
"""

from dgl_operator_tpu_torch._device import resolve_device  # noqa: F401
