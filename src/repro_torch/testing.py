"""Random draws and parameter hand-over between the port and the reference.

PyTorch cannot replay JAX's threefry streams, so the port takes every random
draw a round consumes from a *draws provider*:

* :class:`TorchDraws` — a seeded ``torch.Generator`` on the run's device
  (normal use);
* :class:`ReplayDraws` — a queue of pre-computed draws, consumed in order.
  Parity tests fill it with the reference's own draws (computed with JAX by
  the test), so both packages see identical masks;
* :class:`SeedWordDraws` — one served round's draws from the seed words of
  its announcement (``repro_torch.serve``);
* :class:`RecordingDraws` — another provider's draws, kept on the host to be
  replayed.

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


def _derive(seed: int, stream: str, kind: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(f"{stream}/{kind}".encode())) \
        % 2 ** 63


def fold_words(words) -> int:
    """Two uint32 seed words as one 64-bit integer, the first word high
    (``repro_torch.serve.protocol.mask_id``; one word is the low half)."""
    raw = np.asarray(words, np.uint32).reshape(-1)
    return ((int(raw[0]) << 32) if raw.size > 1 else 0) | int(raw[-1])


class TorchDraws:
    """Draws from seeded ``torch.Generator`` objects living on ``device``, one per
    stream and kind of draw (see the module docstring). The global mask's
    permutations come from a generator seeded with ``seed`` itself."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gens = {}

    def _seed(self, stream: str, kind: str) -> int:
        if (stream, kind) == ("mask", "perm"):
            return self.seed
        return _derive(self.seed, stream, kind)

    def generator(self, stream: str, kind: str) -> torch.Generator:
        key = (stream, kind)
        gen = self._gens.get(key)
        if gen is None:
            gen = self._gens[key] = torch.Generator(device=self.device)
            gen.manual_seed(self._seed(stream, kind))
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


class SeedWordDraws(TorchDraws):
    """The draws of one round of the streaming parameter server
    (``repro_torch.serve``), from the seed words its announcement carries:
    the ``mask`` and ``local`` streams from the mask words, the ``attack``
    stream from the attack words. Every client re-derives the same draws
    from the same announcement, as the reference's clients re-derive the
    global mask from the broadcast mask key."""

    def __init__(self, mask_words, atk_words, device: torch.device):
        super().__init__(fold_words(mask_words) % 2 ** 63, device)
        self.atk_seed = fold_words(atk_words) % 2 ** 63

    def _seed(self, stream: str, kind: str) -> int:
        if stream == "attack":
            return _derive(self.atk_seed, stream, kind)
        return super()._seed(stream, kind)


class RecordingDraws:
    """A provider that hands out ``inner``'s draws and keeps a host copy of
    each, so :meth:`replay` gives a :class:`ReplayDraws` of the same draws
    in the same order (a served run's draws, replayed into
    ``Simulator.rollout``)."""

    def __init__(self, inner):
        self.inner = inner
        self.device = inner.device
        self.permutations, self.uniforms, self.normals, self.bits = \
            [], [], [], []

    def permutation_prefix(self, d: int, k: int, stream: str = "mask"
                           ) -> torch.Tensor:
        out = self.inner.permutation_prefix(d, k, stream)
        self.permutations.append(out.cpu().numpy())
        return out

    def permutation_prefixes(self, m: int, d: int, k: int,
                             stream: str = "local") -> torch.Tensor:
        out = self.inner.permutation_prefixes(m, d, k, stream)
        self.permutations += list(out.cpu().numpy())
        return out

    def uniform(self, shape: Sequence[int], stream: str = "mask"
                ) -> torch.Tensor:
        out = self.inner.uniform(shape, stream)
        self.uniforms.append(out.cpu().numpy())
        return out

    def normal(self, shape: Sequence[int], stream: str = "attack"
               ) -> torch.Tensor:
        out = self.inner.normal(shape, stream)
        self.normals.append(out.cpu().numpy())
        return out

    def bits_u32(self, stream: str = "mask") -> int:
        out = self.inner.bits_u32(stream)
        self.bits.append(out)
        return out

    def replay(self, device: Optional[torch.device] = None) -> "ReplayDraws":
        return ReplayDraws(self.device if device is None else device,
                           permutations=self.permutations,
                           uniforms=self.uniforms, bits=self.bits,
                           normals=self.normals)


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
