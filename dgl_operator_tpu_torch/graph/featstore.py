"""Two-tier host feature store over one partition's ``[core | halo]``
feature plane: the degree-ranked hot halo rows
(``parallel/halo.build_halo_cache``) resident and contiguous, the core
rows read through a view of the backing array (an mmap stays an mmap,
so a file-referenced book pages in only the rows a request samples).

Float storage only; quantized books are not ported yet.
"""

from __future__ import annotations

import numpy as np


class PagedFeatureStore:
    """One partition's feature plane, two-tiered.

    feats     : ``[n_local, D]`` float array, resident or an mmap.
    num_inner : core-prefix length (rows ``>= num_inner`` are halo).
    cache_idx : halo-relative indices of the hot rows to keep resident.
    """

    def __init__(self, feats: np.ndarray, num_inner: int,
                 cache_idx: np.ndarray):
        if np.dtype(feats.dtype).kind != "f":
            raise NotImplementedError(
                f"feature storage dtype {feats.dtype} is not a float "
                "type; quantized feature stores are not ported yet")
        self.num_inner = int(num_inner)
        self._backing = feats
        self.core = feats[: self.num_inner]
        cache_idx = np.asarray(cache_idx)
        rows = (feats[self.num_inner + cache_idx] if len(cache_idx)
                else np.zeros((0, feats.shape[1]), feats.dtype))
        self.cache = np.ascontiguousarray(rows, np.float32)
        self.paged = isinstance(feats, np.memmap)
        self.paged_rows = 0   # cold-tier rows read since load

    def core_rows(self, idx: np.ndarray) -> np.ndarray:
        """Cold-tier read of ``core[idx]`` as float32."""
        self.paged_rows += len(idx)
        return np.asarray(self.core[np.asarray(idx)], np.float32)

    def cache_rows(self, slots: np.ndarray) -> np.ndarray:
        """Hot-tier read: resident float32."""
        return self.cache[np.asarray(slots)]

    @property
    def feat_dim(self) -> int:
        return int(self._backing.shape[1])

    @property
    def resident_bytes(self) -> int:
        """Bytes this store pins in RAM: the hot tier, plus the cold
        tier when it is not demand-paged."""
        n = self.cache.nbytes
        if not self.paged:
            n += self.core.nbytes
        return int(n)

    @property
    def backing_bytes(self) -> int:
        return int(self._backing.nbytes)
