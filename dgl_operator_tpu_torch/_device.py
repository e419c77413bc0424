"""Device selection for every entry point of the package.

The port's work runs on a CUDA card. A caller that wants the CPU (the
test suite, a reference run) says so with ``device="cpu"``; nothing
falls back to the CPU on its own, so a run that was meant for the card
can never quietly measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card and raises when there is none. A CUDA device without an index
    gets the current card's, so it compares equal to where tensors
    put on it live."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device
