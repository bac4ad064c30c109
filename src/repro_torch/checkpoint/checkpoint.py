"""Parameter-tree checkpoints as ``.npz`` + JSON metadata (counterpart of
``repro.checkpoint``), in the reference's format: one array per leaf under
its path (dict keys and list or tuple indices joined by ``/``, in JAX's leaf
order: sorted dict keys), and ``<path>.meta.json`` holding the metadata and
``step``. A checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[str]:
    """Leaf paths in leaf order (the order of ``tree_flatten``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, prefix + (str(i),))]
    return ["/".join(prefix)]


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta(path: str) -> str:
    return path.replace(".npz", "") + ".meta.json"


def save(path: str, tree: Any, metadata: Optional[Dict] = None,
         step: Optional[int] = None) -> str:
    """Save a tree of tensors (or numpy arrays); returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays = {k: (l.detach().cpu().numpy() if isinstance(l, torch.Tensor)
                  else np.asarray(l))
              for k, l in zip(_paths(tree), leaves)}
    np.savez(_npz(path), **arrays)
    meta = dict(metadata or {})
    if step is not None:
        meta["step"] = step
    with open(_meta(path), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def restore(path: str, like: Any) -> Any:
    """The checkpoint in the structure of ``like`` (a tree of tensors or of
    anything with a ``shape``), each leaf a tensor on the device of its
    ``like`` leaf (the CPU for non-tensors)."""
    leaves, treedef = tree_flatten(like)
    out = []
    with np.load(_npz(path)) as f:
        for key, leaf in zip(_paths(like), leaves):
            arr = f[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, expected {tuple(leaf.shape)}")
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(treedef, out)


def latest_step(path: str) -> Optional[int]:
    """The ``step`` saved beside the checkpoint, or ``None``."""
    meta = _meta(path)
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f).get("step")
