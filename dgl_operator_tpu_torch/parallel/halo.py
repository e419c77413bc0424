"""Owner-sharded halo features: the degree-ranked hot-halo cache.

Each partition stores its core feature rows once; a halo row is read
from the part that owns it, unless it is among the hottest halo rows
that every part keeps resident. Exchanging rows between cards over
``torch.distributed`` comes with the distributed trainer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# default fraction of a partition's halo rows kept resident as the hot
# cache: sampling draws a halo node with probability proportional to
# its local edge count, so a small degree-ranked cache absorbs an
# outsized share of halo reads
DEFAULT_HALO_CACHE_FRAC = 0.25


def build_halo_cache(src: np.ndarray, num_nodes: int, num_inner: int,
                     cache_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-ranked hot-halo cache selection for ONE partition
    (hotness = local edge count).

    src       : [num_edges] local src endpoint of every local edge.
    num_nodes : local node count ([core | halo] ordering).
    num_inner : core prefix length; halo rows follow.
    cache_rows: slots to fill.

    Returns ``(cache_idx, slot_of)``: ``cache_idx`` [cache_rows]
    halo-local rows to store, hottest first (a halo shorter than the
    cache repeats its hottest row); ``slot_of`` [num_halo] halo-local
    row -> cache slot, -1 = not cached (on duplicates the first slot
    wins).
    """
    nh = int(num_nodes) - int(num_inner)
    slot_of = np.full(max(nh, 0), -1, np.int32)
    if cache_rows <= 0 or nh <= 0:
        return np.zeros(0, np.int64), slot_of
    deg = np.bincount(np.asarray(src), minlength=num_nodes)[num_inner:]
    idx = np.argsort(-deg, kind="stable")[:cache_rows]
    if len(idx) < cache_rows:   # short halo: repeat hottest row
        idx = np.concatenate(
            [idx, np.repeat(idx[:1], cache_rows - len(idx))])
    slot_of[idx[::-1]] = np.arange(cache_rows - 1, -1, -1)
    return idx.astype(np.int64), slot_of
