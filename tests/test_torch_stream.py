"""The streaming pipeline of the port against the reference's
(``repro.data.stream``): the same chunks from the same batch function, the
same stacking helpers, the ring buffer's contract (``close()`` without
deadlock, a producer error raised from ``take``, the high-water mark), and
the streamed launcher run bitwise a per-step run over the same batches."""

import threading
import time

import numpy as np
import pytest
import torch

from repro.data import stream as JS
from repro_torch.data import stream as S
from repro_torch.launch import train as TR
from repro_torch.utils.tree import tree_leaves


def batch_fn(t):
    """A per-step batch tree that is a pure function of t."""
    rng = np.random.default_rng((3, t))
    return {"tokens": rng.integers(0, 100, (4, 2, 8)).astype(np.int32),
            "extra": [rng.normal(size=(4, 3)).astype(np.float32)]}


def _np(tree):
    return [np.asarray(l) for l in tree_leaves(tree)]


def test_helpers_match_the_reference():
    got, want = S.stack_chunk(batch_fn, 2, 3), JS.stack_chunk(batch_fn, 2, 3)
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(a, b)
    assert S.batch_bytes(batch_fn(0)) == JS.batch_bytes(batch_fn(0))
    stacked = S.stack_chunk(batch_fn, 0, 7)
    got, want = S.split_chunks(stacked, 3), JS.split_chunks(stacked, 3)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(_np(g), _np(w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("steps,chunk,depth", [(10, 3, 2), (8, 4, 1),
                                                (2, 4, 2)])
def test_prefetched_chunks_are_the_reference_chunks(steps, chunk, depth):
    """The same chunks in the same order, the remainder left out, and the
    producer never holds more than depth + 1 chunks."""
    with JS.ChunkPrefetcher(batch_fn, steps, chunk, depth) as jpf:
        want = []
        while chunks := jpf.take(2):
            want += chunks
    with S.ChunkPrefetcher(batch_fn, steps, chunk, depth,
                           device="cpu") as pf:
        got = []
        while chunks := pf.take(2):
            got += chunks
        assert pf.remainder == steps % chunk
        assert pf.high_water_chunks <= depth + 1
        if got:
            assert pf.chunk_bytes == S.batch_bytes(got[0])
            assert pf.high_water_bytes == pf.high_water_chunks * \
                pf.chunk_bytes
    assert len(got) == len(want) == steps // chunk
    for g, w in zip(got, want):
        assert all(isinstance(l, torch.Tensor) for l in tree_leaves(g))
        for a, b in zip(_np(g), _np(w)):
            np.testing.assert_array_equal(a, b)


def test_stacked_source_matches_the_prefetcher():
    stacked = S.stack_chunk(batch_fn, 0, 7)
    src = S.StackedChunkSource(stacked, 7, 3, device="cpu")
    got = src.take(5)
    with S.ChunkPrefetcher(batch_fn, 7, 3, 2, device="cpu") as pf:
        want = pf.take(5)
    assert len(got) == len(want) == 2 and src.take(1) == []
    for g, w in zip(got, want):
        for a, b in zip(_np(g), _np(w)):
            np.testing.assert_array_equal(a, b)
    assert src.high_water_chunks == 2


def test_close_does_not_deadlock():
    """A producer blocked on a full ring buffer stops when the consumer
    closes early."""
    pf = S.ChunkPrefetcher(batch_fn, 100, 1, 1, device="cpu")
    pf.take(1)
    time.sleep(0.2)  # the producer fills the buffer and blocks
    t0 = time.perf_counter()
    pf.close()
    assert not pf._thread.is_alive()
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() < 50


def test_producer_error_is_raised_from_take():
    def bad(t):
        if t == 3:
            raise KeyError("no batch 3")
        return batch_fn(t)

    with S.ChunkPrefetcher(bad, 8, 2, 2, device="cpu") as pf:
        with pytest.raises(RuntimeError, match="producer") as e:
            pf.take(4)
        assert isinstance(e.value.__cause__, KeyError)


def test_bad_sizes_raise():
    with pytest.raises(ValueError, match="chunk_size"):
        S.ChunkPrefetcher(batch_fn, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="prefetch_depth"):
        S.ChunkPrefetcher(batch_fn, 4, 2, 0, device="cpu")


def test_streamed_launcher_run_is_the_per_step_run():
    """``--stream`` over 3 steps in chunks of 2 (1 chunk and 1 remainder
    step; one layer of the reduced model) against the per-step step
    function fed the same ``(seed, t)`` batches: the parameters and the
    momentum bitwise, the losses equal."""
    argv = ["--arch", "stablelm_3b", "--steps", "3", "--f", "1",
            "--n-layers", "1", "--device", "cpu", "--seed", "4"]
    res = TR.run(argv + ["--stream", "--chunk-size", "2",
                         "--prefetch-depth", "1"], log=lambda _: None)
    assert len(res["losses"]) == 3 and len(res["step_ms"]) == 2
    assert 0 < res["host_high_water_bytes"] <= 2 * S.batch_bytes(
        res["batch_at"](0)) * 2
    s = TR.setup(TR.parse_args(argv))
    state, losses = s["state"], []
    for t in range(3):
        batch = {k: torch.from_numpy(v) for k, v in s["batch_at"](t).items()}
        state, m = s["step"](state, batch)
        losses.append(float(m["loss"]))
    assert losses == res["losses"]
    for a, b in zip(tree_leaves(state.params), tree_leaves(res["state"].params)):
        assert torch.equal(a, b)
    assert torch.equal(state.server.momentum, res["state"].server.momentum)
