"""The transformer testbed of the grid engine (``_transformer_testbed``:
reduced ``stablelm_3b``, 2 layers, d_model 256) and its token stream
against the reference's, and the ``transformer-table1`` registry spec
streamed on the CPU.

Bounds: the loss at the reference's initial parameters (carried over by
``from_jax_params``) within rel 5e-3, the bfloat16 bar of the LLM check
(``PERF.md`` §2); the eval accuracy equal; token streams bitwise. The
streamed spec against the port's own materialised run: bitwise."""

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as JS
from repro.data import synthetic_token_batch as jax_tokens
from repro_torch.adversary import registry as R
from repro_torch.core import sweep as S
from repro_torch.data import synthetic_token_batch
from repro_torch.testing import from_jax_params

N_WORKERS = 9  # transformer-table1's n


@pytest.mark.parametrize("shape", [(9, 4, 32, 512), (1, 32, 32, 512),
                                   (3, 2, 8, 50)])
def test_token_batches_are_the_references(shape):
    got = synthetic_token_batch(np.random.default_rng((5, 2)), *shape)
    want = jax_tokens(np.random.default_rng((5, 2)), *shape)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.fixture(scope="module")
def testbeds():
    return (JS._transformer_testbed(N_WORKERS),
            S._transformer_testbed(N_WORKERS, device="cpu"))


def test_testbed_matches_the_reference_at_its_parameters(testbeds):
    """One worker's loss on one round's batch and the held-out accuracy,
    at the reference's initial parameters; the round's batches and the
    held-out stream bitwise."""
    (jloss, jp0, jbatch, jeval, jeval_batch), \
        (loss, p0, batch, eval_fn, eval_batch) = testbeds
    for t in (0, 3):
        np.testing.assert_array_equal(batch(t)["tokens"],
                                      jbatch(t)["tokens"])
    np.testing.assert_array_equal(eval_batch["tokens"].numpy(),
                                  np.asarray(jeval_batch["tokens"]))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp0))
    assert sorted(params) == sorted(p0)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(p0)):
        assert a.shape == b.shape and a.dtype == b.dtype
    one = {k: v[2] for k, v in batch(3).items()}
    want = float(jloss(jp0, one))
    got = float(loss(params, {k: torch.as_tensor(v) for k, v in
                              one.items()}))
    assert abs(got - want) <= 5e-3 * abs(want)
    assert float(eval_fn(params, eval_batch)["acc"]) == float(
        jeval(jp0, jeval_batch)["acc"])


@pytest.fixture
def one_thread():
    """One intra-op thread: the grid's many small operations at D =
    1,313,280 slow down ~10x when the suite's parallel workers each start a
    thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_transformer_table1_streams_bitwise_its_materialised_run(
        testbeds, one_thread):
    """The registry spec (rosdhb, robust_dgd x alie, signflip, CWTM+NNM,
    n = 9, f = 2) streamed for 8 rounds (chunk 4, depth 2) gives the rows of
    the materialised run exactly; every row finite, accuracy in [0, 1]."""
    _, (loss, p0, batch, eval_fn, eval_batch) = testbeds
    cells = R.expand_scenario("transformer-table1")
    assert len(cells) == 4
    kw = dict(loss_fn=loss, params0=p0, batches=batch, seeds=(0,), steps=8,
              eval_fn=eval_fn, eval_batch=eval_batch, device="cpu")
    streamed = S.run_scenarios(cells, streaming=True, stream_chunk_size=4,
                               prefetch_depth=2, **kw)
    assert streamed == S.run_scenarios(cells, **kw)
    assert [r["scenario"] for r in streamed] == [c.label for c in cells]
    for r in streamed:
        assert np.isfinite(r["final_loss"]) and np.isfinite(r["min_loss"])
        assert 0.0 <= r["acc"] <= 1.0
