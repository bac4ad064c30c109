"""Parameter-tree <-> flat-vector utilities (counterpart of ``repro.utils.tree``).

The server operates on flat ``[D]`` parameter vectors and ``[n, D]`` worker
banks. Model parameters are nested dicts of tensors; the flat layout is the
reference's: leaves in JAX ``tree_leaves`` order, which visits dict keys in
sorted order (so a layer's ``b`` comes before its ``w``), lists and tuples
in position order. ``None`` is an empty subtree, as in JAX (a model's
missing ``tail_blocks``): it has no leaves and maps to ``None``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch

from repro_torch.utils.dtypes import is_float8, to_float8


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    if tree is None:
        return ("none", None, ())
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, len(tree),
                tuple(_flatten(t, leaves) for t in tree))
    leaves.append(tree)
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with leaves in JAX's order."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def _unflatten(treedef: Any, it) -> Any:
    if treedef is None:
        return next(it)
    kind, meta, children = treedef
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(meta, children)}
    out = [_unflatten(c, it) for c in children]
    return tuple(out) if kind == "tuple" else out


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    return _unflatten(treedef, iter(leaves))


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(l) for l in leaves])


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of a parameter tree's flattened layout.

    Attributes:
      treedef: the tree structure.
      shapes: per-leaf shapes, in leaf order.
      dtypes: per-leaf torch dtypes.
      sizes: per-leaf element counts.
      offsets: per-leaf start offsets into the flat vector.
      size: total unpadded size ``D``.
      padded_size: ``D`` rounded up to a multiple of ``pad_to``.
    """

    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    offsets: tuple
    size: int
    padded_size: int

    @property
    def pad(self) -> int:
        return self.padded_size - self.size


def make_flat_spec(tree: Any, pad_to: int = 1) -> FlatSpec:
    """Build a :class:`FlatSpec` for ``tree``."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    size = int(sum(sizes))
    padded = -(-size // pad_to) * pad_to
    return FlatSpec(treedef, shapes, dtypes, sizes, offsets, size, padded)


def tree_ravel(tree: Any, spec: FlatSpec | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flatten ``tree`` into one 1-D vector of ``spec.padded_size``."""
    if spec is None:
        spec = make_flat_spec(tree)
    leaves = tree_leaves(tree)
    parts = [l.reshape(-1).to(dtype) for l in leaves]
    if spec.pad:
        parts.append(parts[0].new_zeros((spec.pad,)))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def tree_ravel_into(tree: Any, out: torch.Tensor, spec: FlatSpec
                    ) -> torch.Tensor:
    """:func:`tree_ravel` into the preallocated 1-D ``out`` of
    ``spec.padded_size`` (a row of a worker bank), each leaf converted to
    ``out``'s dtype on the copy (a bf16 gradient into a float32 row; into a
    float8 row as the reference casts, ``utils.dtypes.to_dtype``), the
    padding zeroed. ``tree`` may be the list of leaves in leaf order."""
    f8 = is_float8(out)
    for leaf, off, size in zip(tree_leaves(tree), spec.offsets, spec.sizes):
        src = leaf.reshape(-1)
        out[off:off + size].copy_(to_float8(src) if f8 else src)
    out[spec.size:].zero_()
    return out


def tree_unravel(flat: torch.Tensor, spec: FlatSpec) -> Any:
    """Inverse of :func:`tree_ravel` (drops padding, restores leaf dtypes).
    Leaves of the same dtype as ``flat`` are views into it."""
    leaves = [flat[off:off + size].reshape(shape).to(dtype)
              for shape, dtype, size, off in zip(spec.shapes, spec.dtypes,
                                                 spec.sizes, spec.offsets)]
    return tree_unflatten(spec.treedef, leaves)


def stacked_ravel(tree: Any, spec: FlatSpec | None = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flatten a tree whose every leaf has a leading stacked axis ``n`` into
    ``[n, padded_size]``. ``spec`` describes the *unstacked* tree."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    if spec is None:
        spec = make_flat_spec(tree_map(lambda l: l[0], tree))
    parts = [l.reshape(n, -1).to(dtype) for l in leaves]
    if spec.pad:
        parts.append(parts[0].new_zeros((n, spec.pad)))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def stacked_unravel(flat: torch.Tensor, spec: FlatSpec) -> Any:
    """Inverse of :func:`stacked_ravel`: ``[n, padded]`` -> stacked tree."""
    n = flat.shape[0]
    leaves = [flat[:, off:off + size].reshape((n,) + shape).to(dtype)
              for shape, dtype, size, off in zip(spec.shapes, spec.dtypes,
                                                 spec.sizes, spec.offsets)]
    return tree_unflatten(spec.treedef, leaves)


def tree_size(tree: Any) -> int:
    """Total number of scalar elements across all leaves."""
    return int(sum(math.prod(l.shape) if hasattr(l, "shape") else 1
                   for l in tree_leaves(tree)))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda l: l.to(dtype), tree)


def tree_add(a: Any, b: Any) -> Any:
    leaves_a, treedef = tree_flatten(a)
    return tree_unflatten(treedef, [x + y for x, y in
                                    zip(leaves_a, tree_leaves(b))])


def tree_scale(a: Any, s) -> Any:
    return tree_map(lambda l: l * s, a)


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt`` of the sum over leaves of each leaf's float32 sum of
    squares, leaf by leaf in leaf order (the reference's Python ``sum``)."""
    total = sum(torch.sum(torch.square(l.to(torch.float32)))
                for l in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def lanes_ravel(tree: Any, spec: FlatSpec, lead: int = 2,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flatten a tree whose leaves carry ``lead`` leading axes (lanes, then
    workers) into ``[*lead_shape, spec.padded_size]``."""
    leaves = tree_leaves(tree)
    shape = tuple(leaves[0].shape[:lead])
    parts = [l.reshape(shape + (-1,)).to(dtype) for l in leaves]
    if spec.pad:
        parts.append(parts[0].new_zeros(shape + (spec.pad,)))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
