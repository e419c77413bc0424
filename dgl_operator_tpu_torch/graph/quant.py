"""Per-column affine feature quantization: the compact storage of node
features in a partition book and in the trainer's feature store.

Node features are step-invariant inputs, so their storage dtype is a
capacity knob: an int8 store holds 4x fewer bytes than float32 on the
card and sends 4x fewer bytes in the halo exchange (the exchange moves
whatever dtype the store holds, ``parallel/halo.py``). The scheme is
per column:

    q     = clip(round(x / scale + zero), qmin, qmax)
    x_hat = (q - zero) * scale

with ``scale`` and ``zero`` float32 vectors of length D (the sidecar).
Columns are the granularity that suits tabular node features: a row's
own scale could not travel with an exchanged row cheaply, and one
global scale lets one wide column blow up the error of every narrow
one. The reconstruction error is at most ``scale / 2`` a column
(:func:`max_abs_error_bound`).

Two storage dtypes:

- ``int8``: symmetric signed range -127..127 (zero stays exact);
- ``uint8``: unsigned affine with a mid-range zero, the byte shape of
  an fp8 format.

The host never dequantizes a whole table: codes travel through the
store and the exchange as they are, and ``(q - zero) * scale`` is taken
once on the gathered rows (``runtime/forward.py::dequant_rows``), the
same algebra as :func:`dequantize`. The sidecar file
(:func:`save_sidecar`, :func:`load_sidecar`) is part of the partition
book's format, the JAX package's: a quantized book names it under
``feat_quant`` and a reader without it fails (``graph/partition.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# the storage dtypes the feature plane quantizes, with their code
# ranges; float32 and bfloat16 store values
QUANT_RANGES: Dict[str, Tuple[int, int]] = {
    "int8": (-127, 127),       # symmetric: -128 unused, zero exact
    "uint8": (0, 255),         # mid-range zero
}


def is_quantized_dtype(name: str) -> bool:
    return str(name) in QUANT_RANGES


def compute_scale(feats: np.ndarray, dtype: str = "int8",
                  eps: float = 1e-12) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column affine parameters for ``feats`` [N, D]: float32
    ``(scale[D], zero[D])``. int8 is symmetric (zero = 0, scale =
    max|x| / 127), uint8 spans the column (scale = (max - min) / 255,
    zero = -min / scale). A constant-zero column gets scale 1."""
    if dtype not in QUANT_RANGES:
        raise ValueError(f"not a quantized dtype: {dtype!r} "
                         f"(choices: {sorted(QUANT_RANGES)})")
    feats = np.asarray(feats)
    if feats.ndim != 2:
        raise ValueError(f"expected [N, D] features, got {feats.shape}")
    if dtype == "int8":
        amax = np.abs(feats).max(axis=0).astype(np.float64) \
            if len(feats) else np.zeros(feats.shape[1])
        scale = np.where(amax > eps, amax / 127.0, 1.0)
        zero = np.zeros_like(scale)
    else:
        lo = feats.min(axis=0).astype(np.float64) \
            if len(feats) else np.zeros(feats.shape[1])
        hi = feats.max(axis=0).astype(np.float64) \
            if len(feats) else np.zeros(feats.shape[1])
        span = hi - lo
        scale = np.where(span > eps, span / 255.0, 1.0)
        zero = np.where(span > eps, -lo / scale, 0.0)
    return scale.astype(np.float32), zero.astype(np.float32)


def merge_column_stats(stats: list, dtype: str = "int8",
                       eps: float = 1e-12
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One global ``(scale, zero)`` from per-chunk or per-part column
    extrema ``[(min[D], max[D]), ...]``: the chunked and multi-process
    form of :func:`compute_scale`. Scales are global across parts,
    since an exchanged row is dequantized with the receiver's
    sidecar."""
    if not stats:
        raise ValueError("merge_column_stats: empty stats")
    lo = np.min(np.stack([np.asarray(s[0], np.float64) for s in stats]),
                axis=0)
    hi = np.max(np.stack([np.asarray(s[1], np.float64) for s in stats]),
                axis=0)
    if dtype not in QUANT_RANGES:
        raise ValueError(f"not a quantized dtype: {dtype!r}")
    if dtype == "int8":
        amax = np.maximum(np.abs(lo), np.abs(hi))
        scale = np.where(amax > eps, amax / 127.0, 1.0)
        zero = np.zeros_like(scale)
    else:
        span = hi - lo
        scale = np.where(span > eps, span / 255.0, 1.0)
        zero = np.where(span > eps, -lo / scale, 0.0)
    return scale.astype(np.float32), zero.astype(np.float32)


def quantize(feats: np.ndarray, scale: np.ndarray, zero: np.ndarray,
             dtype: str = "int8") -> np.ndarray:
    """``feats`` [N, D] as codes of ``dtype`` with the given per-column
    parameters (float64 intermediates; chunk-safe)."""
    qmin, qmax = QUANT_RANGES[dtype]
    q = np.rint(np.asarray(feats, np.float64) / scale + zero)
    return np.clip(q, qmin, qmax).astype(np.dtype(dtype))


def dequantize(codes: np.ndarray, scale: np.ndarray,
               zero: np.ndarray) -> np.ndarray:
    """``(q - zero) * scale`` in float32: the host form of
    ``runtime/forward.py::dequant_rows``, the same algebra, so both
    give the same bits."""
    return ((codes.astype(np.float32) - np.asarray(zero, np.float32))
            * np.asarray(scale, np.float32))


def max_abs_error_bound(scale: np.ndarray) -> np.ndarray:
    """The reconstruction error bound a column: rounding to the nearest
    code loses at most half a step, ``scale / 2`` (a value outside the
    calibrated range would clip as well; calibration on the whole
    array rules that out)."""
    return np.asarray(scale, np.float32) / 2.0


def save_sidecar(path: str, sidecars: Dict[str, dict]) -> str:
    """Write the sidecar file: ``{key}_scale`` and ``{key}_zero``
    float32 vectors and a ``{key}_dtype`` marker per quantized
    feature key, in one npz."""
    payload = {}
    for key, sc in sidecars.items():
        payload[f"{key}_scale"] = np.asarray(sc["scale"], np.float32)
        payload[f"{key}_zero"] = np.asarray(sc["zero"], np.float32)
        payload[f"{key}_dtype"] = np.array(sc["dtype"])
    np.savez(path, **payload)
    return path


def load_sidecar(path: str) -> Dict[str, dict]:
    """The inverse of :func:`save_sidecar`: ``{key: {"scale", "zero",
    "dtype"}}``."""
    out: Dict[str, dict] = {}
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path) as z:
        for name in z.files:
            if not name.endswith("_scale"):
                continue
            key = name[: -len("_scale")]
            out[key] = {"scale": z[f"{key}_scale"],
                        "zero": z[f"{key}_zero"],
                        "dtype": str(z[f"{key}_dtype"])}
    return out
