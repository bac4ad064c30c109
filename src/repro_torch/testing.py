"""Random draws and parameter hand-over between the port and the reference.

PyTorch cannot replay JAX's threefry streams, so the port takes every random
draw a round consumes from a *draws provider*:

* :class:`TorchDraws` — a seeded ``torch.Generator`` on the run's device
  (normal use);
* :class:`ReplayDraws` — a queue of pre-computed draws, consumed in order.
  Parity tests fill it with the reference's own draws (computed with JAX by
  the test), so both packages see identical masks.

The reference's key chain per round, for a test that wants to replay it:
``key, mask_key = split(state.key)`` (``simulator.py:142``);
``mask_key, atk_key = split(mask_key)`` (``algorithms.py:819``);
RandK takes ``permutation(mask_key, d)[:k]`` (``compression.py:77``),
Block-RandK ``permutation(mask_key, nb)[:kb]`` of the block ids
(``compression.py:275``) and ``block_hash`` one
``bits(mask_key, (), uint32)`` seed (``compression.py:109``). The LLM train
step splits ``state.key`` into ``(key, round_key)`` first
(``launch/steps.py:131``) and hands ``round_key`` to the server round.

This module never imports JAX: :func:`from_jax_params` takes the reference's
parameters as numpy arrays.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class TorchDraws:
    """Draws from a seeded ``torch.Generator`` living on ``device``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def permutation_prefix(self, d: int, k: int) -> torch.Tensor:
        """``k`` distinct indices in ``[0, d)`` (int64, on the device)."""
        return torch.randperm(d, generator=self.generator,
                              device=self.device)[:k]

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) float32 samples of ``shape``."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def bits_u32(self) -> int:
        """One uniform uint32 (the per-round seed of ``block_hash``)."""
        return int(torch.randint(0, 2 ** 32, (), generator=self.generator,
                                 device=self.device))


class ReplayDraws:
    """Pre-computed draws handed out in order (parity tests).

    ``permutations`` are the index prefixes RandK and Block-RandK consume,
    one per mask draw; ``uniforms`` the U[0, 1) arrays Bernoulli masks
    consume; ``bits`` the uint32 seeds ``block_hash`` consumes. Asking for a
    draw the queue does not hold raises ``LookupError``.
    """

    def __init__(self, device: torch.device,
                 permutations: Iterable[Any] = (),
                 uniforms: Iterable[Any] = (),
                 bits: Iterable[int] = ()):
        self.device = torch.device(device)
        self._perms = deque(np.asarray(p) for p in permutations)
        self._unif = deque(np.asarray(u) for u in uniforms)
        self._bits = deque(int(b) for b in bits)

    def permutation_prefix(self, d: int, k: int) -> torch.Tensor:
        if not self._perms:
            raise LookupError("ReplayDraws: no permutation draw left")
        idx = self._perms.popleft()
        if idx.shape != (k,) or (k and (idx.min() < 0 or idx.max() >= d)):
            raise ValueError(
                f"replayed permutation prefix of shape {idx.shape} does not "
                f"fit d={d}, k={k}")
        return torch.as_tensor(idx.astype(np.int64), device=self.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        if not self._unif:
            raise LookupError("ReplayDraws: no uniform draw left")
        u = self._unif.popleft()
        if u.shape != tuple(shape):
            raise ValueError(f"replayed uniforms of shape {u.shape}, "
                             f"expected {tuple(shape)}")
        return torch.as_tensor(np.array(u, np.float32), device=self.device)

    def bits_u32(self) -> int:
        if not self._bits:
            raise LookupError("ReplayDraws: no uint32 draw left")
        b = self._bits.popleft()
        if not 0 <= b < 2 ** 32:
            raise ValueError(f"replayed uint32 draw {b} is out of range")
        return b

    @property
    def remaining(self) -> int:
        return len(self._perms) + len(self._unif) + len(self._bits)


def from_jax_params(np_tree: Any, device: Optional[torch.device] = None
                    ) -> Any:
    """Carry a reference parameter tree across, given as numpy arrays (the
    caller converts with ``np.asarray``): same nesting, same layouts (HWIO
    convolution kernels, ``[din, dout]`` dense weights), so the flat vector
    is identical. Tensors land on ``device`` (default the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(dev), np_tree)
