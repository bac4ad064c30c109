"""Streaming batch pipeline: host prefetch thread -> fixed-depth ring buffer
(counterpart of ``repro.data.stream``).

A producer thread calls ``batch_fn(t)`` ahead of the consumer, stacks
``chunk_size`` rounds into one chunk and hands it to the device; a bounded
queue of device chunks decouples the two sides, so host residency is
O(prefetch_depth) chunks whatever the run's length. On the card each chunk
is stacked into pinned host buffers and copied with ``non_blocking=True`` on
a side CUDA stream; the chunk travels with an event recorded after its
copies, and :meth:`ChunkPrefetcher.take` makes the consumer's stream wait on
that event, so the copies overlap the consumer's compute and nothing reads a
chunk before it has arrived. On the CPU the chunk is the stacked host
arrays.

The contract is the reference's: ``take(k)`` returns up to ``k`` chunks in
stream order (``[]`` once exhausted), ``close()`` stops the producer
without deadlock, a producer error is raised from ``take``, and
``high_water_chunks`` / ``high_water_bytes`` record the peak producer-side
residency (queued chunks + the one being built).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["ChunkPrefetcher", "StackedChunkSource", "batch_bytes",
           "stack_chunk", "split_chunks"]


def batch_bytes(batch: Any) -> int:
    """Total leaf bytes of one batch tree (numpy or torch leaves)."""
    return int(sum(l.nbytes for l in tree_leaves(batch)))


def _stack_pinned(xs) -> torch.Tensor:
    """``np.stack(xs)`` written straight into a pinned host tensor."""
    first = np.asarray(xs[0])
    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    buf = torch.empty((len(xs),) + first.shape, dtype=dtype,
                      pin_memory=True)
    np.stack(xs, out=buf.numpy())
    return buf


def stack_chunk(batch_fn: Callable[[int], Any], start: int,
                length: int, pin: bool = False) -> Any:
    """``length`` consecutive batches stacked on a leading round axis: one
    chunk of the stream, host-side numpy (with ``pin``, torch tensors in
    pinned host memory, for a non-blocking copy to the card); torch leaves
    are stacked where they lie."""
    rows = [batch_fn(t) for t in range(start, start + length)]
    cols = zip(*(tree_leaves(r) for r in rows))
    it = iter([torch.stack(xs) if isinstance(xs[0], torch.Tensor)
               else _stack_pinned(xs) if pin else np.stack(xs)
               for xs in cols])
    return tree_map(lambda _: next(it), rows[0])


def split_chunks(batches: Any, chunk_size: int) -> List[Any]:
    """Full ``chunk_size`` chunks of a stacked ``[steps, ...]`` tree (the
    remainder is left to the caller's per-step path)."""
    steps = tree_leaves(batches)[0].shape[0]
    return [tree_map(lambda l: l[c * chunk_size:(c + 1) * chunk_size],
                     batches) for c in range(steps // chunk_size)]


def _to_device(host: Any, device: torch.device,
               non_blocking: bool = False) -> Any:
    """Host tree (numpy or torch leaves) -> tensors on ``device``."""
    def move(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(device, non_blocking=non_blocking)
    return tree_map(move, host)


class StackedChunkSource:
    """Chunks sliced from a stacked ``[steps, ...]`` tree, one per
    ``take`` slot and moved to ``device`` on the caller's stream (no
    thread): the same contract as :class:`ChunkPrefetcher`, for feeding a
    streamed and a materialised run from one array."""

    def __init__(self, batches: Any, steps: int, chunk_size: int,
                 device: DeviceLike = None):
        self.chunk_size = chunk_size
        self.n_chunks = steps // chunk_size
        self.remainder = steps % chunk_size
        self._batches = batches
        self._device = resolve_device(device)
        self._taken = 0
        self.chunk_bytes = 0
        self.high_water_chunks = 0
        self.high_water_bytes = 0

    def take(self, k: int, timeout: float = 0.0) -> List[Any]:
        out: List[Any] = []
        for _ in range(max(0, min(k, self.n_chunks - self._taken))):
            c = self._taken
            rows = slice(c * self.chunk_size, (c + 1) * self.chunk_size)
            host = tree_map(lambda l: l[rows] if isinstance(l, torch.Tensor)
                            else np.asarray(l[rows]), self._batches)
            if not self.chunk_bytes:
                self.chunk_bytes = batch_bytes(host)
            out.append(_to_device(host, self._device))
            self._taken += 1
        self.high_water_chunks = max(self.high_water_chunks, len(out))
        self.high_water_bytes = self.high_water_chunks * self.chunk_bytes
        return out

    def close(self) -> None:
        pass


class ChunkPrefetcher:
    """Host prefetch thread filling a fixed-depth ring buffer of device
    chunks.

    Args:
      batch_fn: ``batch_fn(t) -> tree`` of numpy per-worker batches for
        round t, called strictly in step order on the producer thread.
      steps: total rounds (``start .. start + steps - 1``); full chunks
        only, ``remainder`` rounds are left to the caller.
      chunk_size: rounds per chunk.
      prefetch_depth: ring-buffer depth: at most this many chunks wait
        beyond the one being built.
      start: first round index.
      device: where chunks land (default the card, where the copies run on
        a side stream from pinned buffers; ``"cpu"`` for host tensors).

    Attributes (after the first chunk): ``chunk_bytes``,
    ``high_water_chunks``, ``high_water_bytes``.
    """

    def __init__(self, batch_fn: Callable[[int], Any], steps: int,
                 chunk_size: int, prefetch_depth: int = 4, start: int = 0,
                 device: DeviceLike = None):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        if prefetch_depth <= 0:
            raise ValueError(
                f"prefetch_depth must be positive, got {prefetch_depth}")
        self.chunk_size = chunk_size
        self.prefetch_depth = prefetch_depth
        self.n_chunks = steps // chunk_size
        self.remainder = steps % chunk_size
        self._batch_fn = batch_fn
        self._start = start
        self._device = resolve_device(device)
        self._side = (torch.cuda.Stream(self._device)
                      if self._device.type == "cuda" else None)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.chunk_bytes = 0
        self.high_water_chunks = 0
        self.high_water_bytes = 0
        self._taken = 0
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="repro-torch-chunk-prefetch")
        self._thread.start()

    # producer thread

    def _upload(self, host: Any):
        """``(device chunk, ready event or None)``."""
        if self._side is None:
            return _to_device(host, self._device), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._side):
            chunk = _to_device(host, self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return chunk, ready

    def _produce(self) -> None:
        try:
            for c in range(self.n_chunks):
                if self._stop.is_set():
                    return
                host = stack_chunk(self._batch_fn,
                                   self._start + c * self.chunk_size,
                                   self.chunk_size,
                                   pin=self._side is not None)
                if not self.chunk_bytes:
                    self.chunk_bytes = batch_bytes(host)
                item = self._upload(host)
                del host
                queued = False
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        queued = True
                        break
                    except queue.Full:
                        continue
                if not queued:  # the consumer closed early
                    return
                resident = self._q.qsize() + 1
                self.high_water_chunks = max(self.high_water_chunks, resident)
                self.high_water_bytes = (self.high_water_chunks
                                         * self.chunk_bytes)
        except BaseException as e:  # raised to the consumer in take()
            self._error = e

    # consumer side

    def take(self, k: int, timeout: float = 120.0) -> List[Any]:
        """Up to ``min(k, chunks remaining)`` device chunks in stream order,
        ready for the caller's current stream; ``[]`` once exhausted."""
        out: List[Any] = []
        for _ in range(max(0, min(k, self.n_chunks - self._taken))):
            left = timeout
            while True:
                if self._error is not None:
                    raise RuntimeError("ChunkPrefetcher producer thread "
                                       "failed") from self._error
                try:
                    chunk, ready = self._q.get(timeout=0.05)
                    break
                except queue.Empty:
                    left -= 0.05
                    if left <= 0:
                        raise TimeoutError(
                            f"prefetch thread produced nothing for "
                            f"{timeout}s (chunk {self._taken}/"
                            f"{self.n_chunks})")
            if ready is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(ready)
                for t in tree_leaves(chunk):
                    t.record_stream(stream)
            out.append(chunk)
            self._taken += 1
        return out

    def close(self) -> None:
        """Stop the producer: drain the queue so a blocked ``put`` wakes,
        then join the thread."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
