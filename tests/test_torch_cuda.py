"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA card and the CUDA toolkit; they skip elsewhere.
They import neither JAX nor the reference, so they run where only PyTorch
is installed, without the suite's conftest (which imports JAX)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import (AggregatorConfig, AlgorithmConfig, AttackConfig,
                              Simulator, SparsifierConfig, quadratic_testbed)
from repro_torch.kernels.cwtm import cwtm, cwtm_cuda, cwtm_ref
from repro_torch.kernels.median import median, median_cuda, median_ref
from repro_torch.kernels.pairdist import pairdist, pairdist_cuda, pairdist_ref
from repro_torch.testing import ReplayDraws

AWKWARD = [(3, 13, 3, 300), (2, 7, 0, 130), (4, 5, 2, 257),
           (1, 19, 9, 128), (5, 4, 1, 64), (2, 16, 3, 1024),
           (1, 13, 3, 11958), (2, 64, 20, 999), (1, 1, 0, 77)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(b, n, d, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).normal(size=(b, n, d)) * 3
    return torch.tensor(x, dtype=torch.float32, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f,d", AWKWARD)
def test_kernels_match_plain(card, b, n, f, d):
    """cwtm rtol/atol 1e-5, median atol 1e-6, pairdist |d| <= 1e-5 max sq
    with an exactly-zero diagonal (float32 sums in another order)."""
    x = _x(b, n, d, 11, card)
    if n > 2 * f:
        torch.testing.assert_close(cwtm_cuda(x, f), cwtm_ref(x, f),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(median_cuda(x), median_ref(x), rtol=0,
                               atol=1e-6)
    got, want = pairdist_cuda(x), pairdist_ref(x)
    assert got.shape == (b, n, n)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        x.square().sum(-1).max())
    assert bool((got.diagonal(dim1=1, dim2=2) == 0).all())
    torch.testing.assert_close(got, got.mT, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f,d", AWKWARD[:6])
def test_bf16_kernels_match_plain(card, b, n, f, d):
    x = _x(b, n, d, 12, card, torch.bfloat16)
    got = cwtm_cuda(x, f)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), cwtm_ref(x, f).float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(median_cuda(x).float(),
                               median_ref(x).float(), rtol=0, atol=5e-2)
    torch.testing.assert_close(pairdist_cuda(x), pairdist_ref(x),
                               rtol=1e-3, atol=1e-3 * float(
                                   x.float().square().sum(-1).max()))


@pytest.mark.cuda
def test_launch_counters(card):
    x = _x(2, 13, 500, 3, card)
    K.reset_launches()
    pairdist(x), cwtm(x, 3), median(x), cwtm(x[0], 3)
    assert K.launches() == {"pairdist": 1, "cwtm": 2, "median": 1}
    pairdist(x.cpu()), cwtm(x.cpu(), 3), median(x.cpu())
    assert K.launches() == {"pairdist": 1, "cwtm": 2, "median": 1}


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    with pytest.raises(TypeError):
        cwtm_cuda(_x(1, 5, 8, 0, card).double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        pairdist_cuda(_x(1, 5, 8, 0, card).mT.contiguous().mT)
    with pytest.raises(ValueError, match="n <= 64"):
        median_cuda(_x(1, 65, 8, 0, card))


@pytest.mark.cuda
def test_fig1_alie_rounds_card_vs_cpu(card):
    """Three fig1-alie rounds of the quadratic on the card (kernels) and on
    the CPU (plain versions) with the same draws: within 1e-5 of max |w|."""
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=13, f=3, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=AggregatorConfig(name="cwtm", f=3, pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5))
    d, steps = 4096, 3
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(13, d)) * 0.1 + 1.0
    perms = [rng.permutation(d)[:cfg.sparsifier.k(d)] for _ in range(steps)]
    finals = []
    K.reset_launches()
    for dev in (card, torch.device("cpu")):
        loss, p0, batch_fn, _ = quadratic_testbed(13, d=d, targets=targets,
                                                  device=dev)
        sim = Simulator(loss, p0, cfg, device=dev)
        state, _ = sim.rollout(sim.init(draws=ReplayDraws(dev, perms)),
                               batch_fn, steps=steps)
        finals.append(state.params_flat.cpu())
    assert K.launches()["pairdist"] == K.launches()["cwtm"] == steps
    scale = float(finals[1].abs().max())
    assert float((finals[0] - finals[1]).abs().max()) <= 1e-5 * scale
