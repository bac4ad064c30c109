"""Minimal parameter-tree optimizers (counterpart of
``repro.optim.optimizers``).

The RoSDHB *server* update is part of ``repro_torch.core``; these
optimizers serve the substrate roles: reference non-robust training, the
examples' inner loops and fine-tuning demos. The API is the reference's
(optax's): ``init(params) -> state``, ``update(grads, state, params) ->
(updates, state)``, the updates to be *added* to the parameters
(:func:`apply_updates`). Trees are nested dicts, lists and tuples of
tensors (``utils.tree``); every operation is one PyTorch operation in the
reference's order, so each update rounds as the reference's eager one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

Tree = Any


def _map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees of its structure
    in ``rest``, leaf by leaf."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return _map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def heavy_ball(lr: float, beta: float = 0.9) -> Optimizer:
    """Polyak momentum in the paper's normalisation:
    m_t = beta m_{t-1} + (1-beta) g_t;  theta -= lr * m_t."""

    def init(params):
        return _map(torch.zeros_like, params)

    def update(grads, m, params):
        m = _map(lambda mm, g: beta * mm + (1.0 - beta) * g, m, grads)
        return _map(lambda mm: -lr * mm, m), m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = _map(torch.zeros_like, params)
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return AdamState(z, z, torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def update(grads, state, params):
        count = state.count + 1
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                  state.nu, grads)
        # the constants are float32, as the reference's weakly typed ones
        n = count.to(torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=n.device) ** n
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=n.device) ** n

        def upd(m, v, p):
            # the root in float64, rounded once: the correctly rounded
            # float32 root (PyTorch's vectorised float32 root on the CPU
            # is not)
            root = torch.sqrt((v / c2).double()).to(v.dtype)
            step = (m / c1) / (root + eps)
            return -lr * (step + weight_decay * p)

        return _map(upd, mu, nu, params), AdamState(mu, nu, count)

    return Optimizer(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` leaf by leaf, each update cast to its parameter's dtype."""
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; ``lr(step)`` is a float32 scalar tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
