"""Parameter tree <-> server bank in the sharded layout (counterpart of
``repro.sharding.flatten``), on one card.

The reference lays the ``[n_workers, D]`` bank out leaf by leaf so that a
mesh can build it with one all-to-all over the data axis: each leaf's
model dim moved to the front, the leaf flattened and padded to ``unit =
n_chips * align``, the leaves concatenated. On one card the all-to-all and
the all-gather of the inverse move nothing, and what stays is that order
of coordinates: a ``[4, 6]`` leaf whose model dim is 1 lands as ``0, 6,
12, 18, 1, 7, ...``, and every leaf starts on a multiple of ``unit``. The
order decides which parameters share a Block-RandK block, so it is a
trajectory of its own, not a relabelling of the naive flatten
(``utils.tree``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.sharding import partitioning as sp
from repro_torch.utils import tree as T
from repro_torch.utils.dtypes import is_float8, to_float8


@dataclasses.dataclass(frozen=True)
class ShardedFlatSpec:
    """Static plan for the bank transforms.

    ``model_dims[i]``: index of leaf i's model-sharded dim (-1 replicated).
    ``chunk_sizes[i]``: leaf i's flat size padded to ``unit``.
    ``padded_size``: total bank coordinate count D (sum of chunks).
    """

    treedef: Any
    shapes: Tuple
    dtypes: Tuple
    model_dims: Tuple
    chunk_sizes: Tuple
    offsets: Tuple
    padded_size: int
    unit: int

    @property
    def size(self) -> int:
        """Parameters in the tree (the bank's columns less the padding)."""
        return sum(math.prod(s) for s in self.shapes)


#: Each leaf's chunk is padded to a multiple of this: the reference's
#: ``unit``, one chip times its ``align`` of 8.
UNIT = 8


def make_sharded_flat_spec(abstract_params: Any) -> ShardedFlatSpec:
    """The plan of ``abstract_params`` (meta tensors will do)."""
    leaves, treedef = T.tree_flatten(abstract_params)
    mdims = sp.param_specs(abstract_params)
    shapes, dtypes, chunks, offsets = [], [], [], []
    off = 0
    for leaf in leaves:
        shape = tuple(leaf.shape)
        padded = -(-math.prod(shape) // UNIT) * UNIT
        shapes.append(shape)
        dtypes.append(leaf.dtype)
        chunks.append(padded)
        offsets.append(off)
        off += padded
    return ShardedFlatSpec(treedef, tuple(shapes), tuple(dtypes), mdims,
                           tuple(chunks), tuple(offsets), off, UNIT)


def _model_major(leaf: torch.Tensor, mdim: int) -> torch.Tensor:
    """The leaf with its model dim moved to the front, flattened."""
    if mdim >= 0:
        leaf = torch.movedim(leaf, mdim, 0)
    return leaf.reshape(-1)


def ravel_into(tree: Any, out: torch.Tensor, spec: ShardedFlatSpec
               ) -> torch.Tensor:
    """One worker's tree into its bank row ``out`` (1-D, at least
    ``spec.padded_size`` long), each leaf model-major and converted to
    ``out``'s dtype on the copy (into a float8 row as the reference casts),
    every pad zeroed. ``tree`` may be the list of leaves in leaf order."""
    f8 = is_float8(out)
    out.zero_()
    for leaf, mdim, off in zip(T.tree_leaves(tree), spec.model_dims,
                               spec.offsets):
        src = _model_major(leaf, mdim)
        if f8:
            to_float8(src, out=out[off:off + src.numel()])
        else:
            out[off:off + src.numel()].copy_(src)
    return out


def flatten_to_bank(tree: Any, spec: ShardedFlatSpec,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stacked gradient tree (leading worker axis n) -> bank ``[n, D]`` in
    the sharded layout."""
    leaves = T.tree_leaves(tree)
    n = leaves[0].shape[0]
    bank = torch.empty((n, spec.padded_size), dtype=dtype,
                       device=leaves[0].device)
    for w in range(n):
        ravel_into([leaf[w] for leaf in leaves], bank[w], spec)
    return bank


def bank_to_param_tree(vec: torch.Tensor, spec: ShardedFlatSpec) -> Any:
    """Aggregated direction ``[D]`` (or longer: columns past
    ``padded_size`` are ignored) in the sharded layout -> parameter tree in
    the leaves' dtypes."""
    leaves = []
    for shape, dtype, mdim, off in zip(spec.shapes, spec.dtypes,
                                       spec.model_dims, spec.offsets):
        flat = vec[off:off + math.prod(shape)]
        if mdim >= 0 and len(shape):
            perm = (shape[mdim],) + tuple(s for i, s in enumerate(shape)
                                          if i != mdim)
            arr = torch.movedim(flat.reshape(perm), 0, mdim)
        else:
            arr = flat.reshape(shape)
        leaves.append(arr.to(dtype))
    return T.tree_unflatten(spec.treedef, leaves)
