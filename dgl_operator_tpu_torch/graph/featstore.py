"""Two-tier host feature store over one partition's ``[core | halo]``
feature plane: resident float32 hot rows over demand-paged, possibly
quantized backing storage.

- hot tier: the degree-ranked hot halo rows
  (``parallel/halo.py::build_halo_cache``), dequantized to float32 once
  at load, resident and contiguous: they are read all the time;
- cold tier: the core rows through a view of the backing array, float
  values or int8/uint8 codes of a quantized book (``graph/quant.py``);
  an mmap stays an mmap, so a file-referenced book pages in only the
  rows a request samples, and codes are dequantized on the way out.

The store gives the float32 rows a float32 store would, up to the
book's quantization error, which is the trainer's input as well: the
server reads the reconstructed rows the trainer reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dgl_operator_tpu_torch.graph import quant
from dgl_operator_tpu_torch.obs import get_obs


class PagedFeatureStore:
    """One partition's feature plane, two-tiered.

    feats     : ``[n_local, D]`` float values or quantized codes,
                resident or an mmap.
    num_inner : core-prefix length (rows ``>= num_inner`` are halo).
    cache_idx : halo-relative indices of the hot rows to keep resident.
    sidecar   : ``{"scale", "zero", "dtype"}`` when ``feats`` holds
                codes (``GraphPartition.feat_sidecar``), else None.
    """

    def __init__(self, feats: np.ndarray, num_inner: int,
                 cache_idx: np.ndarray, sidecar: Optional[dict] = None):
        self.num_inner = int(num_inner)
        self.quantized = sidecar is not None
        if self.quantized:
            self._scale = np.asarray(sidecar["scale"], np.float32)
            self._zero = np.asarray(sidecar["zero"], np.float32)
        elif np.dtype(feats.dtype).kind != "f":
            raise ValueError(
                f"feature storage dtype {feats.dtype} holds codes: pass "
                "the book's sidecar (GraphPartition.feat_sidecar)")
        self._backing = feats
        self.core = feats[: self.num_inner]
        cache_idx = np.asarray(cache_idx)
        rows = (feats[self.num_inner + cache_idx] if len(cache_idx)
                else np.zeros((0, feats.shape[1]), feats.dtype))
        self.cache = self._to_f32(rows, copy=True)
        self.paged = isinstance(feats, np.memmap)
        self.paged_rows = 0   # cold-tier rows read since load

    def _to_f32(self, rows: np.ndarray, copy: bool = False) -> np.ndarray:
        if self.quantized:
            return quant.dequantize(rows, self._scale, self._zero)
        rows = np.asarray(rows, np.float32)
        return np.ascontiguousarray(rows) if copy else rows

    def core_rows(self, idx: np.ndarray) -> np.ndarray:
        """Cold-tier read of ``core[idx]`` as float32 (codes
        dequantized)."""
        self.paged_rows += len(idx)
        return self._to_f32(self.core[np.asarray(idx)])

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
        """Bytes of the whole ``[core | halo]`` plane in its storage
        dtype."""
        return int(self._backing.nbytes)

    def stats(self) -> dict:
        return {
            "dtype": str(np.dtype(self._backing.dtype)),
            "quantized": self.quantized,
            "paged": self.paged,
            "resident_mib": round(self.resident_bytes / 2**20, 3),
            "backing_mib": round(self.backing_bytes / 2**20, 3),
            "paged_rows": int(self.paged_rows),
        }


def emit_dataplane_gauges(role: str, dtype: str, slot_mib: float,
                          backing_mib: Optional[float] = None,
                          paged_rows: Optional[int] = None) -> None:
    """A plane's feature-storage bill as gauges of the obs registry:
    ``data_feat_mib_per_slot{role,dtype}`` and, when given,
    ``data_feat_backing_mib{role,dtype}`` and
    ``data_feat_paged_rows{role}``."""
    m = get_obs().metrics
    m.gauge("data_feat_mib_per_slot",
            "per-slot feature-store MiB in the active storage dtype",
            labels=("role", "dtype")).set(slot_mib, role=role,
                                          dtype=dtype)
    if backing_mib is not None:
        m.gauge("data_feat_backing_mib",
                "full backing bytes of the feature plane (storage "
                "dtype; mappable for file-referenced partition books)",
                labels=("role", "dtype")).set(backing_mib, role=role,
                                              dtype=dtype)
    if paged_rows is not None:
        m.gauge("data_feat_paged_rows",
                "cold-tier feature rows demand-paged since load",
                labels=("role",)).set(paged_rows, role=role)
