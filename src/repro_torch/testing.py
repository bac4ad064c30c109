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

A draw names its *stream*, the part of the round it serves: ``mask`` (the
round's global mask), ``local`` (per-worker masks: RoSDHB-Local and dasha's
independent compressors) or ``attack`` (gauss noise, ipm_greedy's coins).
:class:`TorchDraws` keeps one generator per stream and kind of draw, so what
one part of a round draws never shifts another part's draws: a grid lane that
draws only some of them sees the same values as a lone run of its cell, as a
JAX key chain (``split``) gives the reference. :class:`ReplayDraws` keeps one
queue per kind and hands them out in call order.

The grid (``repro_torch.core.sweep``) runs ``B = n_cells * n_seeds`` lanes;
every lane of one seed reads that seed's draws (:class:`GridDraws`), drawn
once per seed and round, as every lane of a seed shares its key chain in the
reference (``sweep.py:233``).

This module never imports JAX: :func:`from_jax_params` takes the reference's
parameters as numpy arrays.
"""

from __future__ import annotations

from collections import deque
import zlib
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class TorchDraws:
    """Draws from seeded ``torch.Generator`` objects living on ``device``, one per
    stream and kind of draw (see the module docstring). The global mask's
    permutations come from a generator seeded with ``seed`` itself."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gens = {}

    def generator(self, stream: str, kind: str) -> torch.Generator:
        key = (stream, kind)
        gen = self._gens.get(key)
        if gen is None:
            seed = self.seed if key == ("mask", "perm") else (
                (self.seed * 1_000_003 + zlib.crc32(f"{stream}/{kind}".encode()))
                % 2 ** 63)
            gen = self._gens[key] = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        return gen

    def permutation_prefix(self, d: int, k: int, stream: str = "mask"
                           ) -> torch.Tensor:
        """``k`` distinct indices in ``[0, d)`` (int64, on the device)."""
        return torch.randperm(d, generator=self.generator(stream, "perm"),
                              device=self.device)[:k]

    def permutation_prefixes(self, m: int, d: int, k: int,
                             stream: str = "local") -> torch.Tensor:
        """``[m, k]``: the prefixes of ``m`` independent permutations, in
        one draw (the ranks of float64 uniforms; a tie has probability
        ~d^2 2^-54)."""
        u = torch.rand((m, d), generator=self.generator(stream, "perm"),
                       device=self.device, dtype=torch.float64)
        return u.argsort(dim=-1)[:, :k]

    def uniform(self, shape: Sequence[int], stream: str = "mask"
                ) -> torch.Tensor:
        """U[0, 1) float32 samples of ``shape``."""
        return torch.rand(tuple(shape), generator=self.generator(
            stream, "uniform"), device=self.device)

    def normal(self, shape: Sequence[int], stream: str = "attack"
               ) -> torch.Tensor:
        """N(0, 1) float32 samples of ``shape``."""
        return torch.randn(tuple(shape), generator=self.generator(
            stream, "normal"), device=self.device)

    def bits_u32(self, stream: str = "mask") -> int:
        """One uniform uint32 (the per-round seed of ``block_hash``)."""
        return int(torch.randint(0, 2 ** 32, (), generator=self.generator(
            stream, "bits"), device=self.device))


class ReplayDraws:
    """Pre-computed draws handed out in order (parity tests).

    ``permutations`` are the index prefixes RandK and Block-RandK consume,
    one per mask draw (:meth:`permutation_prefixes` takes ``m`` of them);
    ``uniforms`` the U[0, 1) arrays Bernoulli masks and ipm_greedy's coins
    consume; ``normals`` the N(0, 1) arrays of gauss; ``bits`` the uint32
    seeds ``block_hash`` consumes. One queue per kind, whatever the stream.
    Asking for a draw the queue does not hold raises ``LookupError``.
    """

    def __init__(self, device: torch.device,
                 permutations: Iterable[Any] = (),
                 uniforms: Iterable[Any] = (),
                 bits: Iterable[int] = (),
                 normals: Iterable[Any] = ()):
        self.device = torch.device(device)
        self._perms = deque(np.asarray(p) for p in permutations)
        self._unif = deque(np.asarray(u) for u in uniforms)
        self._norm = deque(np.asarray(z) for z in normals)
        self._bits = deque(int(b) for b in bits)

    def permutation_prefix(self, d: int, k: int, stream: str = "mask"
                           ) -> torch.Tensor:
        if not self._perms:
            raise LookupError("ReplayDraws: no permutation draw left")
        idx = self._perms.popleft()
        if idx.shape != (k,) or (k and (idx.min() < 0 or idx.max() >= d)):
            raise ValueError(
                f"replayed permutation prefix of shape {idx.shape} does not "
                f"fit d={d}, k={k}")
        return torch.as_tensor(idx.astype(np.int64), device=self.device)

    def permutation_prefixes(self, m: int, d: int, k: int,
                             stream: str = "local") -> torch.Tensor:
        return torch.stack([self.permutation_prefix(d, k, stream)
                            for _ in range(m)])

    def _pop(self, queue: deque, what: str, shape: Tuple[int, ...]
             ) -> torch.Tensor:
        if not queue:
            raise LookupError(f"ReplayDraws: no {what} draw left")
        a = queue.popleft()
        if a.shape != tuple(shape):
            raise ValueError(f"replayed {what} of shape {a.shape}, "
                             f"expected {tuple(shape)}")
        return torch.as_tensor(np.array(a, np.float32), device=self.device)

    def uniform(self, shape: Sequence[int], stream: str = "mask"
                ) -> torch.Tensor:
        return self._pop(self._unif, "uniform", tuple(shape))

    def normal(self, shape: Sequence[int], stream: str = "attack"
               ) -> torch.Tensor:
        return self._pop(self._norm, "normal", tuple(shape))

    def bits_u32(self, stream: str = "mask") -> int:
        if not self._bits:
            raise LookupError("ReplayDraws: no uint32 draw left")
        b = self._bits.popleft()
        if not 0 <= b < 2 ** 32:
            raise ValueError(f"replayed uint32 draw {b} is out of range")
        return b

    @property
    def remaining(self) -> int:
        return (len(self._perms) + len(self._unif) + len(self._norm)
                + len(self._bits))


class GridDraws:
    """The draws of a lane grid: one provider per seed, and the seed each
    lane reads (lane ``c * n_seeds + s`` is cell ``c``, seed ``s``). A round
    draws each kind it needs once per seed (``n_seeds`` host calls, not one
    per lane) and hands every lane its seed's values."""

    def __init__(self, providers: Sequence[Any], seed_of_lane: Sequence[int]):
        if not providers:
            raise ValueError("GridDraws needs at least one provider")
        self.providers = list(providers)
        self.seed_of_lane = tuple(int(s) for s in seed_of_lane)
        if any(not 0 <= s < len(self.providers) for s in self.seed_of_lane):
            raise ValueError(f"seed_of_lane {self.seed_of_lane} names a "
                             f"provider outside 0..{len(self.providers) - 1}")
        self.device = self.providers[0].device
        self._index = torch.as_tensor(self.seed_of_lane, dtype=torch.long,
                                      device=self.device)

    @property
    def lanes(self) -> int:
        return len(self.seed_of_lane)

    def per_lane(self, draw) -> torch.Tensor:
        """``draw(provider)`` once per seed, stacked and read per lane:
        ``[B, ...]``."""
        per_seed = torch.stack([torch.as_tensor(draw(p), device=self.device)
                                for p in self.providers])
        if len(self.providers) == 1:
            return per_seed.expand((self.lanes,) + per_seed.shape[1:])
        return per_seed.index_select(0, self._index)


def from_jax_params(np_tree: Any, device: Optional[torch.device] = None
                    ) -> Any:
    """Carry a reference parameter tree across, given as numpy arrays (the
    caller converts with ``np.asarray``): same nesting, same layouts (HWIO
    convolution kernels, ``[din, dout]`` dense weights), so the flat vector
    is identical. Tensors land on ``device`` (default the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(dev), np_tree)
