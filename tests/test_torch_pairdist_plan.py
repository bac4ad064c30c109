"""The launch plans of the pairdist and sorted-rank kernels, on the CPU.

The kernels run only on the card; how they cut a shape is pure Python
(``pairdist_plan``, ``sorted_weight_threads``, the plan structs), held here
at the main paths' shapes and at ragged ends."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.cwtm.cwtm import (plan_struct, cwtm_weights,
                                          sorted_weight_threads)
from repro_torch.kernels.median.median import median_weights
from repro_torch.kernels.pairdist.pairdist import (MAX_CLUSTER, MAX_THREADS,
                                                   PORTABLE_CLUSTER,
                                                   SMEM_LIMIT, TILE,
                                                   pairdist_plan)

H100_SMS = 132
PATH = [(1, 13, 11958), (1, 13, 1048576), (8, 13, 1048576)]
RAGGED = [(1, 13, 1), (1, 13, 100), (1, 13, 127), (1, 13, 128),
          (1, 13, 129), (1, 13, 2048), (1, 13, 2049), (3, 13, 300),
          (2, 1, 77), (2, 64, 999), (1, 64, 40000), (1, 13, 16383),
          (1, 13, 16384), (1, 13, 16385), (1, 13, 16512), (3, 13, 16513),
          (5, 4, 64), (16, 13, 1048577), (65535, 2, 3), (1, 13, 416179200),
          (1, 13, 4096), (1, 13, 4097), (1, 13, 32768), (1, 13, 32769),
          (1, 13, 33024), (3, 13, 33025)]


@pytest.mark.parametrize("b,n,d", PATH + RAGGED)
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_every_column_falls_in_exactly_one_cta(b, n, d, itemsize, sms):
    plan = pairdist_plan(b, n, d, itemsize, sms)
    spans = [plan.columns(k, d) for k in range(plan.ctas)]
    assert sum(len(s) for s in spans) == d
    ends = [s.stop for s in spans if len(s)]
    starts = [s.start for s in spans if len(s)]
    assert starts[0] == 0 and ends[-1] == d
    assert starts[1:] == ends[:-1]  # consecutive, no overlap, no gap
    # no cluster is all empty: the last one holds columns
    assert len(plan.columns((plan.groups - 1) * plan.cluster, d)) > 0


@pytest.mark.parametrize("b,n,d", PATH + RAGGED)
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_plan_limits(b, n, d, itemsize):
    plan = pairdist_plan(b, n, d, itemsize, H100_SMS)
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.cluster & (plan.cluster - 1) == 0
    if plan.groups > 1:
        assert plan.cluster == PORTABLE_CLUSTER
    assert plan.threads <= MAX_THREADS and plan.threads % plan.phases == 0
    assert (TILE // 2) % plan.phases == 0
    assert plan.smem < SMEM_LIMIT
    assert plan.groups * plan.cluster * plan.tiles_per_cta * plan.tile >= d


@pytest.mark.parametrize("n", range(1, 65))
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_shared_memory_stays_under_227_kb(n, itemsize):
    plan = pairdist_plan(1, n, 1 << 20, itemsize, H100_SMS)
    assert plan.smem < SMEM_LIMIT
    assert plan.n_pad == -(-n // 4) * 4


def test_cnn_shape_is_one_cluster_per_row():
    plan = pairdist_plan(1, 13, 11958, 4, H100_SMS)
    assert plan.groups == 1  # no scratch, no ticket, one launch
    assert plan.cluster == 16 and plan.tiles_per_cta == 3
    assert plan.threads == 320 and plan.phases == 32  # a warp a pair


@pytest.mark.parametrize("b", [1, 8])
def test_quadratic_shapes_fill_the_card(b):
    plan = pairdist_plan(b, 13, 1048576, 4, H100_SMS)
    assert plan.groups > 1
    assert b * plan.ctas >= H100_SMS
    assert b * plan.ctas <= 8 * H100_SMS  # one wave at 4 CTAs an SM


@pytest.mark.parametrize("b,d,threads", [(1, 11958, 64), (1, 20000, 128),
                                         (1, 1048576, 256),
                                         (8, 1048576, 256),
                                         (1, 416179200, 256), (3, 300, 64),
                                         (2, 70001, 256)])
def test_sorted_weight_block_size(b, d, threads):
    t = sorted_weight_threads(b, d, H100_SMS)
    assert t == threads
    if t < 256:  # a wider block would leave SMs idle
        assert -(-d // (2 * t)) * b < H100_SMS


@pytest.mark.parametrize("n,f", [(13, 3), (8, 1), (5, 2), (64, 20), (1, 0)])
@pytest.mark.parametrize("which", ["cwtm", "median"])
def test_cached_weights_hold_the_rank_weights_exactly(n, f, which):
    w = cwtm_weights(n, f) if which == "cwtm" else median_weights(n)
    assert (cwtm_weights(n, f) if which == "cwtm" else median_weights(n)) \
        is w  # built once per tuple
    s = plan_struct(1, n, 11958, torch.float32, w, H100_SMS)
    assert list(s.weights.w[:n]) == [float(np.float32(v)) for v in w]
    assert list(s.weights.w[n:]) == [0.0] * (64 - n)
    assert (s.B, s.n, s.d, s.dtype, s.threads) == (1, n, 11958, 0, 64)
