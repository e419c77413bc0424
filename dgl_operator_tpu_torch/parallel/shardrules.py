"""Rule-driven parameter and optimizer-state sharding.

The counterpart of the JAX package's ``parallel/shardrules.py``. A list
of ``(regex, spec)`` rules maps every parameter's tree path to a
placement over a :class:`~dgl_operator_tpu_torch.parallel.mesh.SlotMesh`
(``match_partition_rules``), and the optimizer state inherits each
parameter's placement (``opt_state_specs``), so Adam's or Adagrad's
moments land 1/N exactly where their parameter does.

Contract (the JAX module's):

- rules are ``(pattern, spec)`` pairs, first match wins (``re.search``
  over the '/'-joined tree path);
- scalar leaves (ndim 0 or size 1) are always replicated, before any
  rule is consulted, and so is a leaf whose matched spec has more
  entries than the leaf has dims;
- a non-scalar leaf no rule matches raises ``ValueError`` naming the
  path and the three nearest rule patterns;
- a moment leaf inherits the spec of the parameter whose path is the
  longest suffix of its own; a leaf with no parameter ancestry is
  replicated.

A spec is a tuple of entries, one a leaf dim: an axis name, None, or a
tuple of axis names (``("dp",)``, ``(None, "mp")``); ``()`` is
replicated. :func:`to_pspec` coerces ``None``, a string, a list or a
tuple.

A tree is a nested dict (keys sorted, as JAX flattens a dict), list,
tuple or named tuple (fields in order) of leaves: tensors, numpy
arrays, or anything with ``shape`` and ``dtype`` (:class:`ShapeLeaf`).
The port's parameter trees are named by ``models/flax_layout.py``
(:func:`param_tree`), so ``params/FanoutSAGEConv_0/self/kernel``
names the same leaf, with the same (flax) shape, in both packages, and
the byte model gives the JAX numbers for the same shapes and specs.
"""

from __future__ import annotations

import difflib
import re
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dgl_operator_tpu_torch.parallel.mesh import SlotMesh, my_slots


class PSpec(tuple):
    """A spec: a tuple of entries, one a leaf dim (an axis name, None or
    a tuple of names). A leaf of a tree, never a node of one."""

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


class ShapeLeaf(NamedTuple):
    """A leaf by its shape and dtype alone (the accounting's view of a
    storage tensor, ``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: Any = np.float32


def to_pspec(spec) -> PSpec:
    """Coerce a rule's target into a :class:`PSpec`: ``None`` is
    replicated ``()``, a string names one mesh axis, a tuple or list
    names one entry a dim (each an axis name, None, or a tuple of
    names)."""
    if spec is None:
        return PSpec()
    if isinstance(spec, str):
        return PSpec((spec,))
    if isinstance(spec, (tuple, list)):
        return PSpec(tuple(e) if isinstance(e, list) else e for e in spec)
    raise TypeError(f"cannot coerce {spec!r} to a PartitionSpec")


def _is_node(x) -> bool:
    """Dicts, lists, plain tuples and named tuples are nodes; a spec and
    a :class:`ShapeLeaf` are leaves."""
    if isinstance(x, (dict, list)):
        return True
    if type(x) is tuple:
        return True
    return (isinstance(x, tuple) and hasattr(x, "_fields")
            and not isinstance(x, ShapeLeaf))


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    return [(str(i), v) for i, v in enumerate(node)]


def _rebuild(node, values: List):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, sep: str = "/",
                       _prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; ``None``
    is an empty subtree, as in JAX."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(_prefix, tree)
    out = []
    for name, child in _children(tree):
        path = f"{_prefix}{sep}{name}" if _prefix else name
        out.append(tree_map_with_path(fn, child, sep, path))
    return _rebuild(tree, out)


def tree_paths(tree, sep: str = "/") -> List[Tuple[str, Any]]:
    """Flatten ``tree`` into ``(path, leaf)`` pairs with '/'-joined
    string paths, the names the rules match against."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree, sep)
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def _itemsize(leaf) -> int:
    dt = getattr(leaf, "dtype", np.float32)
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return np.dtype(dt).itemsize


def is_scalar_leaf(leaf) -> bool:
    """Replicate-always leaves: ndim 0 or a single element."""
    shape = _shape(leaf)
    return len(shape) == 0 or int(np.prod(shape, dtype=int)) == 1


def spec_axes(spec) -> Tuple[str, ...]:
    """All mesh axis names a spec shards over, flattened positionally
    (``(None, ("dp", "mp"))`` -> ``("dp", "mp")``)."""
    out: List[str] = []
    for entry in to_pspec(spec):
        out.extend((entry,) if isinstance(entry, str) else (entry or ()))
    return tuple(out)


def match_partition_rules(rules: Sequence[Tuple[str, Any]], params,
                          sep: str = "/"):
    """Map ``rules`` (ordered ``(regex, spec)`` pairs, first match wins)
    over ``params``: a tree of specs of the same structure. Scalar
    leaves, and leaves whose matched spec has more entries than dims,
    are replicated; a non-scalar leaf no rule matches raises
    ``ValueError`` naming its path and the three nearest rule patterns
    (add a catch-all ``(".*", None)`` to replicate the rest)."""
    compiled = [(pat, re.compile(pat), to_pspec(spec))
                for pat, spec in rules]

    def spec_of(name: str, leaf):
        if is_scalar_leaf(leaf):
            return PSpec()
        ndim = len(_shape(leaf))
        for _, rx, ps in compiled:
            if rx.search(name) is not None:
                return PSpec() if len(ps) > ndim else ps
        near = difflib.get_close_matches(
            name, [pat for pat, _, _ in compiled], n=3, cutoff=0.0)
        hint = ("; nearest rule patterns: "
                + ", ".join(repr(p) for p in near)) if near else ""
        raise ValueError(
            f"no partition rule matches param {name!r} "
            "(rules are first-match-wins; add a catch-all "
            f"('.*', None) to replicate unmatched leaves{hint})")

    return tree_map_with_path(spec_of, params, sep)


def opt_state_specs(opt_state, params, param_specs, sep: str = "/"):
    """The spec tree of an optimizer state tree, derived from the
    parameters' specs: every leaf inherits the spec of the parameter
    whose path is the longest suffix of its own path, whatever its
    shape (a flat per-slot moment shard, even of one element, keeps its
    parameter's spec); a leaf with no parameter ancestry (Adam's count)
    is replicated."""
    by_path = {path: spec for (path, _), (_, spec) in
               zip(tree_paths(params, sep), tree_paths(param_specs, sep))}

    def inherit(path: str, leaf):
        best = None
        for ppath, spec in by_path.items():
            if path == ppath or path.endswith(sep + ppath):
                if best is None or len(ppath) > len(best[0]):
                    best = (ppath, spec)
        return best[1] if best is not None else PSpec()

    return tree_map_with_path(inherit, opt_state, sep)


def _slot_coords(mesh: SlotMesh, slot: int) -> Dict[str, int]:
    """Slot ``slot``'s coordinate on each axis (row-major)."""
    coords, rest = {}, int(slot)
    for ax in reversed(mesh.axis_names):
        coords[ax] = rest % mesh.shape[ax]
        rest //= mesh.shape[ax]
    return coords


def slot_block(mesh: SlotMesh, arr, spec, slot: int):
    """Slot ``slot``'s block of ``arr`` under ``spec``: each dim whose
    entry names axes is cut into the product of their sizes (which must
    divide it) and the slot's combined coordinate taken."""
    coords = _slot_coords(mesh, slot)
    index = []
    for d, entry in enumerate(to_pspec(spec)):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if not axes:
            index.append(slice(None))
            continue
        n, c = 1, 0
        for ax in axes:
            c = c * mesh.shape[ax] + coords[ax]
            n *= mesh.shape[ax]
        size = arr.shape[d]
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not split over "
                             f"{n} slots ({axes})")
        k = size // n
        index.append(slice(c * k, (c + 1) * k))
    return arr[tuple(index)]


def place_by_specs(mesh: SlotMesh, tree, specs, rank: int = 0,
                   world: int = 1) -> Dict[int, Any]:
    """Every leaf of ``tree`` cut under its spec for each slot process
    ``rank`` of ``world`` holds: ``{slot: tree of that slot's blocks}``
    (views of the leaves). Every process passes the same host value (the
    same seed or checkpoint) and keeps its own slots' blocks, the JAX
    ``place_host_array`` contract."""
    spec_leaves = [s for _, s in tree_paths(specs)]
    out = {}
    for slot in my_slots(mesh, rank, world):
        it = iter(spec_leaves)
        out[slot] = tree_map_with_path(
            lambda _, x: slot_block(mesh, x, next(it), slot), tree)
    return out


# ---------------------------------------------------------------------
# the byte model: per-slot persistent bytes under a placement (the JAX
# model's formulas, so the two packages give the same numbers)
# ---------------------------------------------------------------------
def _leaf_bytes(leaf) -> int:
    return int(np.prod(_shape(leaf), dtype=int)) * _itemsize(leaf)


def bytes_per_slot(tree, specs, axis_sizes: Dict[str, int]) -> int:
    """Per-slot persistent bytes of ``tree`` under ``specs``: each
    leaf's bytes over the product of the sizes of the axes its spec
    shards over, rounded up (padding bills the shard that carries it)."""
    total = 0
    for (_, leaf), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
        n = 1
        for ax in spec_axes(spec):
            n *= int(axis_sizes[ax])
        total += -(-_leaf_bytes(leaf) // n)
    return total


def replicated_bytes(tree) -> int:
    """Per-slot bytes with everything replicated."""
    return sum(_leaf_bytes(leaf) for _, leaf in tree_paths(tree))


def zero3_bytes_per_slot(params, num_parts: int) -> int:
    """Per-slot persistent parameter bytes under the ``zero_stage=3``
    flat storage plan: every leaf flattened, zero-padded to a multiple
    of the dp width and split, ``ceil(size / n)`` elements a slot."""
    n = max(int(num_parts), 1)
    total = 0
    for _, leaf in tree_paths(params):
        size = int(np.prod(_shape(leaf), dtype=int))
        total += -(-size // n) * _itemsize(leaf)
    return total


def sharding_summary(params, opt_state, param_specs, opt_specs,
                     axis_sizes: Dict[str, int]) -> Dict[str, float]:
    """The state-sharding block: MiB a slot of the parameters and the
    optimizer state, replicated and under the placement, and the
    savings ratio (the JAX keys and rounding)."""
    p_rep = replicated_bytes(params)
    o_rep = replicated_bytes(opt_state)
    p_sh = bytes_per_slot(params, param_specs, axis_sizes)
    o_sh = bytes_per_slot(opt_state, opt_specs, axis_sizes)
    mib = 1.0 / 2**20
    return {
        "params_mib_per_slot_replicated": round(p_rep * mib, 3),
        "params_mib_per_slot_sharded": round(p_sh * mib, 3),
        "opt_state_mib_per_slot_replicated": round(o_rep * mib, 3),
        "opt_state_mib_per_slot_sharded": round(o_sh * mib, 3),
        "state_savings_ratio": round(
            (p_sh + o_sh) / max(p_rep + o_rep, 1), 4),
    }


def emit_state_gauges(summary: Dict[str, float], role: str) -> None:
    """Fold a :func:`sharding_summary` into the obs registry as
    ``train_state_mib_per_slot{role,kind,mode}`` and
    ``train_state_savings_ratio{role}``."""
    from dgl_operator_tpu_torch.obs import get_obs
    g = get_obs().metrics.gauge(
        "train_state_mib_per_slot",
        "per-slot params/optimizer-state MiB under the active sharding",
        labels=("role", "kind", "mode"))
    for kind in ("params", "opt_state"):
        for mode in ("replicated", "sharded"):
            g.set(summary[f"{kind}_mib_per_slot_{mode}"],
                  role=role, kind=kind, mode=mode)
    get_obs().metrics.gauge(
        "train_state_savings_ratio",
        "sharded/replicated per-slot state bytes (1.0 = no sharding)",
        labels=("role",)).set(summary["state_savings_ratio"], role=role)


# ---------------------------------------------------------------------
# padded <-> logical: the storage forms (parallel/dp.py) carry padding;
# checkpoints and restores under another mesh go through the logical form
# ---------------------------------------------------------------------
def _pad(arr, widths):
    if isinstance(arr, torch.Tensor):
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(arr, flat)
    return np.pad(arr, widths)


def pad_flat(arr, n: int):
    """Flatten and zero-pad to a multiple of ``n`` elements (the flat
    shard storage form; pad elements carry zero gradients, so an
    elementwise optimizer leaves them at zero). A tensor stays a
    tensor, anything else becomes a numpy array."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    flat = arr.reshape(-1)
    pad = (-flat.shape[0]) % n
    return _pad(flat, [(0, pad)]) if pad else flat


def pad_dims(arr, mults: Sequence[int]):
    """Zero-pad each dim of ``arr`` up to a multiple of the matching
    entry of ``mults`` (1 leaves it), the dim-sharded storage form."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    widths = [(0, (-d) % m) for d, m in zip(arr.shape, mults)]
    if any(w for _, w in widths):
        return _pad(arr, widths)
    return arr


def unpad_leaf(arr, shape: Sequence[int]):
    """The logical leaf of a padded storage form: itself when the shapes
    agree, ``[:size].reshape`` of a flat storage, a slice of each dim of
    a dim-padded one. Raises when ``arr`` cannot hold a ``shape``
    leaf."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    shape = tuple(int(s) for s in shape)
    if tuple(arr.shape) == shape:
        return arr
    size = int(np.prod(shape, dtype=int))
    if arr.ndim == 1 and arr.shape[0] >= size:
        return arr[:size].reshape(shape)
    if arr.ndim == len(shape) and all(
            a >= s for a, s in zip(arr.shape, shape)):
        return arr[tuple(slice(0, s) for s in shape)]
    raise ValueError(
        f"cannot unpad a {tuple(arr.shape)} storage leaf to logical shape "
        f"{shape}")


# ---------------------------------------------------------------------
# the port's parameter trees, named as the flax ones
# ---------------------------------------------------------------------
class ParamLeaf(NamedTuple):
    """One parameter of a model under its flax path: ``shape`` is the
    flax (logical) shape; ``transposed`` when the tensor is the flax
    kernel transposed (a ``Linear`` weight)."""

    path: str
    name: str
    param: torch.nn.Parameter
    shape: Tuple[int, ...]
    transposed: bool


def param_leaves(model: torch.nn.Module) -> List[ParamLeaf]:
    """``model``'s parameters in ``model.parameters()`` order, each
    under its flax params path (``params/<Prefix>_<i>/.../kernel``) and
    flax shape. A model of a flat stack (a string ``flax_prefix``) or a
    nested layout; another model's parameters are named by their state
    dict keys (``a.b`` as ``a/b``), in their own shapes."""
    from dgl_operator_tpu_torch.models.flax_layout import flax_path
    prefix = getattr(model, "flax_prefix", None)
    out = []
    for name, p in model.named_parameters():
        if isinstance(prefix, str):
            fpath = flax_path(name, prefix)
        elif isinstance(prefix, dict) and name.split(".")[0] in prefix:
            child, rest = name.split(".", 1)
            flax_name, sub = prefix[child]
            fpath = (flax_name,) + flax_path(rest, sub)
        else:
            out.append(ParamLeaf(name.replace(".", "/"), name, p,
                                 tuple(int(s) for s in p.shape), False))
            continue
        transposed = fpath[-1] == "kernel" and p.dim() == 2
        shape = tuple(reversed(p.shape)) if transposed else tuple(p.shape)
        out.append(ParamLeaf("/".join(("params",) + fpath), name, p,
                             tuple(int(s) for s in shape), transposed))
    return out


def param_tree(leaves: Sequence[ParamLeaf], leaf_of: Callable = None):
    """The nested params tree of ``leaves`` (``{"params": {...}}``), each
    leaf ``leaf_of(leaf)`` (default: a :class:`ShapeLeaf` of its flax
    shape)."""
    leaf_of = leaf_of or (lambda lf: ShapeLeaf(lf.shape,
                                               lf.param.dtype))
    tree: Dict = {}
    for lf in leaves:
        node = tree
        parts = lf.path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf_of(lf)
    return tree
