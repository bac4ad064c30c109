"""Per-leaf partition rules of the parameter tree (counterpart of
``repro.sharding.partitioning``) on the one-card layout, ``data`` 1 and
``model`` 1.

Rules are matched on the leaf's path (``"blocks/attn/wq/w"``). A rule
names the dim it puts on the ``model`` axis; the reference drops the axis
where the dim does not divide evenly over it (:func:`_fits`), which on one
card leaves only empty dims out. What the bank layout reads from a rule is
that dim, the leaf's model dim: an index, or -1 where the leaf is
replicated. The reference's ``data``-axis (FSDP) placements change no
model dim and are not copied.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple


def n_workers() -> int:
    """The one-card layout's data extent: one data group, one worker."""
    return 1


def _fits(dim: int) -> bool:
    # the reference's divisibility test, on an axis of size 1
    return dim >= 1


def param_spec(path: str, shape: Sequence[int]) -> int:
    """The model dim of one parameter leaf (trailing dims = logical shape;
    extra leading dims are stacked layer or group dims, replicated): the
    reference's rule table, rule for rule, -1 where no rule places
    ``model``."""
    nd = len(shape)

    def on(rule_ndim: int, i: int) -> int:
        # dim i of the rule's trailing dims, as the reference's with_lead
        j = max(nd - rule_ndim, 0) + i
        return j if j < nd and _fits(shape[j]) else -1

    parts = path.split("/")
    name = parts[-1]  # 'w' | 'b' | 'scale' | tensor name
    parent = parts[-2] if "/" in path else ""

    # embeddings / head
    if name == "embed":
        return on(2, 0)
    if name == "lm_head":
        return on(2, 1)

    # MoE expert banks [E, din, dout]
    if parent and parts[-3:-1] and "moe" in parts:
        if name in ("wi", "wg", "wo"):
            return on(3, 0)

    # dense-style projections {w, b}
    if name == "w":
        if parent in ("wq", "wk", "wv", "wi", "wg", "wukv", "in_proj"):
            return on(2, 1)
        if parent in ("wo", "out_proj"):
            return on(2, 0)
        return -1  # wdkv, router, the paper CNN's fc/conv layers
    if name == "b":
        return -1

    # SSM tensors
    if name == "conv_w":
        return on(2, 1)

    # conv_b, A_log, dt_bias, D, norms, gates, everything else
    return -1


def _paths(tree: Any, prefix: Tuple[str, ...], out: List) -> None:
    # the leaf order of utils.tree (JAX's: dict keys sorted, sequences in
    # position order, None an empty subtree), each leaf with its key path
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _paths(t, prefix + (str(i),), out)
    else:
        out.append(("/".join(prefix), tree))


def leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in leaf order, paths as the reference writes
    them (``"blocks/attn/wq/w"``)."""
    out: List[Tuple[str, Any]] = []
    _paths(tree, (), out)
    return out


def param_specs(params: Any) -> Tuple[int, ...]:
    """The model dim of every leaf of ``params`` (tensors, meta tensors or
    anything with a ``shape``), in leaf order."""
    return tuple(param_spec(path, tuple(leaf.shape))
                 for path, leaf in leaves_with_paths(params))


__all__ = ["leaves_with_paths", "n_workers", "param_spec", "param_specs"]
