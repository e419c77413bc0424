"""The drivers' console lines, each also an event in the in-memory
``Obs`` (``obs/__init__.py``): the port's counterpart of the JAX event
log's console sink (``events.log``, ``events.console_line``)."""

from __future__ import annotations

from dgl_operator_tpu_torch.obs import get_obs


def log(message: str, event: str = "log", **fields) -> None:
    """Print ``message`` and record it as event ``event``."""
    print(message, flush=True)
    get_obs().emit(event, message=message, **fields)


def line(message: str) -> None:
    """Print a console-only line (separators, timing blocks)."""
    print(message, flush=True)
