"""What the two model kinds share about tree-form blocks: each block's
neighbour table (``n + i * F + k``), as the device sampler lays it out."""

from __future__ import annotations

import torch


def positions(mask: torch.Tensor) -> torch.Tensor:
    """The int32 ``[n, F]`` neighbour table of a tree block of
    ``mask``'s shape."""
    n, f = mask.shape
    return (n + torch.arange(n * f, dtype=torch.int32, device=mask.device)
            ).view(n, f)
