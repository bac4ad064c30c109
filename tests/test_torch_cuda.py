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
    want = {k: 0 for k in K.kernel_wrappers()}
    want.update(pairdist=1, cwtm=2, median=1)
    assert K.launches() == want
    pairdist(x.cpu()), cwtm(x.cpu(), 3), median(x.cpu())
    assert K.launches() == want


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


# pairdist's launch plan at its edges: d below one tile, exactly one
# cluster's span (16 CTAs of one tile) and one column past it, n = 1 and
# n = 64, clusters of 8 with the ticket (B = 3 with odd d: 4-byte copies
# and the zero column), bfloat16 with odd d (plain loads) and with 16-, 8-
# and 4-byte copies, and a row start off 16 bytes (``offset``). At
# [1, 13, 1048576] in bfloat16 the float32 plain version is itself farther
# than 1e-5 max sq from the float64 distances (chip_smoke.py prints how
# far): that case is held to the float64 version at the same bar.
PAIRDIST_EDGES = [(1, 13, 100, torch.float32, 0),
                  (1, 13, 4096, torch.float32, 0),
                  (1, 13, 4097, torch.float32, 0),
                  (2, 1, 77, torch.float32, 0),
                  (2, 64, 999, torch.float32, 0),
                  (1, 64, 40000, torch.float32, 0),
                  (1, 13, 33024, torch.float32, 0),
                  (3, 13, 33025, torch.float32, 0),
                  (3, 13, 33025, torch.bfloat16, 0),
                  (2, 13, 11957, torch.bfloat16, 0),
                  (1, 13, 11958, torch.bfloat16, 0),
                  (2, 7, 130, torch.bfloat16, 0),
                  (1, 13, 1048576, torch.bfloat16, "float64"),
                  (2, 13, 20000, torch.float32, 1),
                  (2, 13, 20000, torch.bfloat16, 3)]
PATH_SHAPES = [(1, 13, 11958), (1, 13, 1048576), (8, 13, 1048576)]


def _pairdist_f64(x):
    xd = x.double()
    g = xd @ xd.mT
    sq = g.diagonal(dim1=-2, dim2=-1)
    return (sq[..., :, None] + sq[..., None, :] - 2.0 * g).clamp_min(0.0)


def _pairdist_ok(got, x, reference="plain"):
    """Within 1e-5 max sq of the plain (or the float64) version, an exactly
    zero diagonal, symmetric, and the ticket counters back at zero."""
    from repro_torch.kernels.pairdist.pairdist import counters
    want = _pairdist_f64(x) if reference == "float64" else pairdist_ref(x)
    b, n, _ = x.shape
    assert got.shape == (b, n, n) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        x.float().square().sum(-1).max())
    assert bool((got.diagonal(dim1=1, dim2=2) == 0).all())
    assert torch.equal(got, got.mT)
    assert not bool(counters(x.device).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype,offset", PAIRDIST_EDGES)
def test_pairdist_edges(card, b, n, d, dtype, offset):
    """``offset``: values the row start sits past an allocation's start,
    or "float64": the reference."""
    skip = offset if isinstance(offset, int) else 0
    flat = _x(1, 1, b * n * d + skip, 21, card, dtype).reshape(-1)
    x = flat[skip:].view(b, n, d)
    assert x.is_contiguous()
    _pairdist_ok(pairdist_cuda(x), x,
                 "float64" if offset == "float64" else "plain")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_pairdist_path_shapes_repeat_bitwise(card, shape):
    x = _x(*shape, 22, card)
    first = pairdist_cuda(x)
    _pairdist_ok(first, x)
    assert torch.equal(first, pairdist_cuda(x))


@pytest.mark.cuda
def test_pairdist_is_one_device_kernel_at_the_cnn_shape(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = _x(1, 13, 11958, 23, card)
    pairdist_cuda(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            pairdist_cuda(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 4 and all("pairdist_kernel" in m for m in names)


# The sorted-rank kernel at each block size (sorted_weight_threads on an
# H100's 132 SMs): 64 threads at [1, 13, 11958], 128 at [1, 13, 20000],
# 256 at [2, 13, 70001].
@pytest.mark.cuda
@pytest.mark.parametrize("d,threads", [(11958, 64), (20000, 128),
                                       (70001, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_weight_block_sizes(card, d, threads, dtype):
    from repro_torch.kernels import build
    from repro_torch.kernels.cwtm.cwtm import sorted_weight_threads
    b = 2 if d == 70001 else 1
    assert sorted_weight_threads(b, d, build.sm_count(0)) == threads or \
        build.sm_count(0) != 132
    x = _x(b, 13, d, 24, card, dtype)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(cwtm_cuda(x, 3).float(),
                               cwtm_ref(x, 3).float(), rtol=tol, atol=tol)
    torch.testing.assert_close(median_cuda(x).float(),
                               median_ref(x).float(), rtol=0,
                               atol=1e-6 if dtype == torch.float32 else 5e-2)


# --------------------------------------------------------------------------
# Block-RandK, flash attention and the LLM train step
# --------------------------------------------------------------------------

RANDK = [(3, 128 * 7, 128, 1, False, torch.float32),
         (3, 128 * 7, 128, 3, True, torch.float32),
         (2, 512 * 5, 512, 5, False, torch.float32),
         (4, 512 * 9, 512, 4, True, torch.bfloat16),
         (8, 512 * 33, 512, 2, False, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bs,kb,local,dtype", RANDK)
def test_block_kernels_bitwise(card, n, d, bs, kb, local, dtype):
    """Compress and decompress bitwise equal to their plain versions, and
    the round trip bitwise the dense ``(alpha * g) * mask`` (finite g)."""
    from repro_torch.kernels.randk import (block_compress_cuda,
                                           block_compress_ref,
                                           block_decompress_cuda,
                                           block_decompress_ref)
    nb = d // bs
    g = _x(1, n, d, 5, card, dtype)[0]
    rng = np.random.default_rng(kb)
    ids = torch.tensor(np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
                       if local else rng.permutation(nb)[:kb],
                       dtype=torch.int32, device=card)
    alpha = nb / kb
    pay = block_compress_cuda(g, ids, bs, alpha)
    assert torch.equal(pay, block_compress_ref(g, ids, bs, alpha))
    dense = block_decompress_cuda(pay, ids, bs, d)
    assert torch.equal(dense, block_decompress_ref(pay, ids, bs, d))
    mask = torch.zeros((n, nb), dtype=dtype, device=card)
    mask.scatter_(1, ids.long().expand(n, kb), 1)
    assert torch.equal(dense, (alpha * g) * mask.repeat_interleave(bs, 1))


@pytest.mark.cuda
def test_block_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.randk import block_compress_cuda
    g = torch.zeros(2, 1024, device=card)
    ids = torch.tensor([0], device=card)
    with pytest.raises(TypeError):
        block_compress_cuda(g.double(), ids, 128, 1.0)
    with pytest.raises(ValueError, match="16 bytes"):
        block_compress_cuda(g, ids, 6, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        block_compress_cuda(g[:, :1000].contiguous(), ids, 128, 1.0)


MOMENTUM = [(3, 128 * 7, 128, 1, False, torch.float32, 0.9),
            (3, 128 * 7, 128, 7, True, torch.float32, 0.0),
            (2, 512 * 5, 512, 5, False, torch.bfloat16, 0.99),
            (4, 512 * 9, 512, 4, True, torch.bfloat16, 0.9),
            (8, 512 * 33, 512, 2, False, torch.float32, 0.99)]


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bs,kb,local,dtype,beta", MOMENTUM)
def test_momentum_kernel_bitwise(card, n, d, bs, kb, local, dtype, beta):
    """The momentum kernel bitwise equal to its plain version (the bank,
    -0.0 entries included, and a bfloat16 bank's float32 result), one
    launch each."""
    from repro_torch.kernels.randk import (momentum_scatter_cuda,
                                           momentum_scatter_ref)
    nb = d // bs
    m0 = _x(1, n, d, 6, card, dtype)[0]
    m0[:, ::5] = -0.0
    pay = _x(1, n, kb * bs, 7, card, dtype)[0]
    rng = np.random.default_rng(kb)
    ids = torch.tensor(np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
                       if local else rng.permutation(nb)[:kb],
                       dtype=torch.int32, device=card)
    f32_out = dtype == torch.bfloat16
    K.reset_launches()
    m_k, m_p = m0.clone(), m0.clone()
    out_k = momentum_scatter_cuda(m_k, pay, ids, bs, beta, f32_out)
    out_p = momentum_scatter_ref(m_p, pay, ids, bs, beta, f32_out)
    torch.cuda.synchronize()
    assert K.launches()["momentum_scatter"] == 1
    assert torch.equal(_bits(m_k), _bits(m_p))
    assert torch.equal(_bits(out_k), _bits(out_p))


@pytest.mark.cuda
def test_momentum_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.randk import momentum_scatter_cuda
    m = torch.zeros(2, 1024, device=card)
    pay = torch.zeros(2, 256, device=card)
    with pytest.raises(ValueError, match="f32_out"):
        momentum_scatter_cuda(m, pay, torch.tensor([0, 1]), 128, 0.9, True)
    with pytest.raises(ValueError, match="block ids"):
        momentum_scatter_cuda(m, pay, torch.tensor([0]), 128, 0.9)
    with pytest.raises(ValueError, match="multiple of 4"):
        momentum_scatter_cuda(m, pay, torch.tensor([0, 1]), 126, 0.9)
    with pytest.raises(ValueError, match="aligned"):
        momentum_scatter_cuda(torch.zeros(2049, device=card)[1:].view(2, 1024),
                              pay, torch.tensor([0, 1]), 128, 0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_payload_route_is_bitwise_the_dense_route_on_card(card, mdt):
    """One RoSDHB round on the card: the payload route (compress, ALIE on
    the payload, the momentum kernel, CWTM) against the dense route
    (compress and decompress, ALIE on the dense wire, the dense momentum,
    CWTM) from the same bank, momentum and ids: momentum bitwise, direction
    within rtol 1e-5."""
    from repro_torch.core import algorithms as Alg
    from repro_torch.core import make_aggregator
    n, bs, nb = 8, 512, 64
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=n, f=1, beta=0.9, momentum_dtype=mdt,
        sparsifier=SparsifierConfig(kind="block", ratio=0.1, block_size=bs),
        aggregator=AggregatorConfig(name="cwtm", f=1),
        attack=AttackConfig(name="alie"))
    dt = Alg.BANK_DTYPES[mdt]
    g = _x(1, n, nb * bs, 8, card, dt)[0]
    m0 = _x(1, n, nb * bs, 9, card, dt)[0]
    ids = np.random.default_rng(0).permutation(nb)[:6]
    agg = make_aggregator(cfg.aggregator, device=card)
    state = Alg.init_state(cfg, nb * bs, device=card)._replace(momentum=m0)
    wire = Alg._compressed_wire(cfg, g, ReplayDraws(card, permutations=[ids]))
    r_d, dense = Alg._rosdhb_apply(cfg, agg, state, wire,
                                   Alg.static_hparams(cfg))
    K.reset_launches()
    r_p, fused, _ = Alg.server_round(
        cfg, state._replace(momentum=m0.clone()), g,
        ReplayDraws(card, permutations=[ids]), agg=agg)
    got = K.launches()
    assert got["block_compress"] == got["momentum_scatter"] == 1
    assert got["block_decompress"] == 0
    assert torch.equal(_bits(fused.momentum), _bits(dense.momentum))
    torch.testing.assert_close(r_p, r_d, rtol=1e-5, atol=1e-5 * float(
        r_d.abs().max()))


@pytest.mark.cuda
def test_prefetcher_on_card_gives_the_host_chunks(card):
    """Pinned buffers, a side stream and an event per chunk: the chunks on
    the card equal the CPU's, in order."""
    from repro_torch.data.stream import ChunkPrefetcher

    def batch_fn(t):
        rng = np.random.default_rng((1, t))
        return {"tokens": rng.integers(0, 50, (4, 2, 16)).astype(np.int32)}

    with ChunkPrefetcher(batch_fn, 9, 2, 2, device=card) as pf, \
            ChunkPrefetcher(batch_fn, 9, 2, 2, device="cpu") as host:
        while chunks := pf.take(1):
            want = host.take(1)[0]
            got = chunks[0]["tokens"]
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want["tokens"])
        assert host.take(1) == []


FLASH = [(2, 100, 100, 32, 32, 80, True, None, 0),
         (1, 130, 130, 16, 2, 64, True, None, 0),
         (2, 77, 77, 8, 1, 128, True, None, 0),
         (1, 200, 200, 16, 2, 80, True, 48, 0),
         (2, 64, 192, 8, 1, 64, True, None, 128),
         (1, 70, 90, 16, 2, 80, False, None, 0)]
# the Hopper kernels' tile edges (blocks of 128, streamed tiles of 128 keys
# forward and 64 backward) at each head dim: GQA with B = 2 at a tile + 1,
# MQA at a tile - 1, a window across a tile boundary, q_offset > 0 with
# Sq < Sk, a ragged non-causal case
FLASH += [case for d in (64, 80, 128) for case in (
    (2, 129, 129, 8, 2, d, True, None, 0),
    (1, 127, 127, 8, 1, d, True, None, 0),
    (1, 257, 257, 4, 2, d, True, 100, 0),
    (2, 65, 193, 4, 1, d, True, 70, 128),
    (1, 63, 191, 8, 2, d, False, None, 0))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_offset", FLASH)
def test_flash_kernels_match_plain(card, b, sq, sk, h, kv, d, causal, window,
                                   q_offset):
    """out within 1e-2 and dq, dk, dv within 2e-2 of the plain version's
    largest entry, the plain version computed in float32 from the same
    bf16 inputs (the kernel rounds P and dS to bf16 for the tensor cores
    and writes bf16)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card).to(  # noqa
        torch.bfloat16)
    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, sq, h, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    fl = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention_ref(*fl, **kw)
    ref_grads = torch.autograd.grad(ref, fl, dout.float())
    for got, want, tol in [(out, ref, 1e-2)] + [
            (g, w, 2e-2) for g, w in zip(grads, ref_grads)]:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.detach().float() - want.detach()).abs().max()
        assert float(err) <= tol * float(want.detach().abs().max())


@pytest.mark.cuda
def test_flash_at_head_dim_112_launches_the_kernel_padded_to_128(card):
    """zamba2's shared attention head dim: ``flash_attention`` pads
    [1, 256, 4, 112] to 128 around one forward and one backward launch,
    held against the plain version at 112 (out within 1e-2, dq, dk, dv
    within 2e-2 of the largest entry)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    gen = torch.Generator(device=card).manual_seed(112)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card).to(  # noqa
        torch.bfloat16)
    q, k, v, dout = (rnd(1, 256, 4, 112) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 1
    fl = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention_ref(*fl)
    ref_grads = torch.autograd.grad(ref, fl, dout.float())
    for got, want, tol in [(out, ref, 1e-2)] + [
            (g, w, 2e-2) for g, w in zip(grads, ref_grads)]:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.detach().float() - want.detach()).abs().max()
        assert float(err) <= tol * float(want.detach().abs().max())


@pytest.mark.cuda
def test_flash_runs_are_deterministic(card):
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    q = _x(1, 256, 16 * 80, 1, card).reshape(1, 256, 16, 80).to(
        torch.bfloat16)
    k = q[:, :, :4].contiguous()
    o, lse = flash_fwd_cuda(q, k, k)
    a = flash_bwd_cuda(q, k, k, o, lse, q)
    b = flash_bwd_cuda(q, k, k, o, lse, q)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.flash_attention import flash_fwd_cuda
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError):
        flash_fwd_cuda(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_cuda(q[..., :48].contiguous(), q[..., :48].contiguous(),
                       q[..., :48].contiguous())
    with pytest.raises(ValueError, match="no visible key"):
        flash_fwd_cuda(q, q, q, window=8, q_offset=80)


def _reduced_llm_steps(card, plain: bool, steps: int = 2):
    """``steps`` train steps of reduced stablelm_3b (2 layers, d_model 256,
    vocab 512, seq 256, n = 8, f = 1, global Block-RandK at 0.05, CWTM,
    ALIE) on the card; ``plain`` runs the plain versions."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchSpec, InputShape
    from repro_torch.core import algorithms as Alg
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch
    from repro_torch.models import model_init
    from repro_torch.testing import TorchDraws
    model = get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=256).with_overrides(
            vocab_size=512, use_flash_attention=False if plain else None)
    ov = {"f": 1, "gamma": 0.5, "attack": AttackConfig(name="alie"),
          "sparsifier": SparsifierConfig(kind="block", ratio=0.05,
                                         block_size=512,
                                         use_kernels=not plain),
          "aggregator": AggregatorConfig(name="cwtm", f=1,
                                         use_kernels=not plain)}
    plan = S.make_train_plan(ArchSpec(model, "test"),
                             InputShape("t", 256, 8, "train"), ov,
                             n_workers=8)
    step = S.build_train_step(plan, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    state = S.TrainState(
        model_init(plan.model, gen),
        Alg.init_state(plan.algo, plan.flat_spec.padded_size, device=card),
        0, TorchDraws(1, card))
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        toks = torch.from_numpy(make_batch(rng, 512, 8, 1, 256)).to(card)
        state, m = step(state, {"tokens": toks})
        out.append((float(m["loss"]), float(m["dir_norm"])))
    return out


@pytest.mark.cuda
def test_llm_train_steps_kernel_vs_plain(card):
    """Two steps (the plan's default bfloat16 banks): the kernel path
    launches flash fwd/bwd n_layers x n_workers times a step and compress,
    the momentum kernel and CWTM once (the payload route: no decompress);
    it agrees with the plain path (same seed and draws) within rtol 5e-3 on
    the honest loss and 2e-2 on |R| (bf16 rounding in the attention
    kernels)."""
    K.reset_launches()
    kern = _reduced_llm_steps(card, plain=False)
    got = K.launches()
    assert got["flash_fwd"] == got["flash_bwd"] == 2 * 8 * 2
    assert got["block_compress"] == got["momentum_scatter"] == 2
    assert got["block_decompress"] == 0
    assert got["cwtm"] == 2 and got["pairdist"] == 0
    K.reset_launches()
    plain = _reduced_llm_steps(card, plain=True)
    assert all(v == 0 for v in K.launches().values())
    for (lk, rk), (lp, rp) in zip(kern, plain):
        assert lk == pytest.approx(lp, rel=5e-3)
        assert rk == pytest.approx(rp, rel=2e-2)


# ----------------------------------------------------------------------- #
# the attention's dispatch: the kernel only where it takes the inputs
# ----------------------------------------------------------------------- #


def _lm_loss_and_grads(card, cfg, seed=0):
    from repro_torch.models import lm_loss, model_init
    from repro_torch.utils.tree import tree_leaves
    params = model_init(cfg, torch.Generator(device=card).manual_seed(seed))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 128))).to(card)
    loss = lm_loss(params, cfg, {"tokens": toks})
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32", "head_dim_256"])
def test_attention_takes_the_plain_path_where_the_kernel_cannot(card, case):
    """A float32 config and a head dim of 256 (gemma_2b's) run forward and
    backward on the card through ``causal_attention``, equal to the plain
    path, with no flash launch; asking for the kernel raises."""
    from repro_torch.configs import get_arch
    base = get_arch("stablelm_3b").model.reduced(n_layers=1, d_model=256)
    cfg = (base.with_overrides(dtype="float32") if case == "float32"
           else base.with_overrides(head_dim=256))
    K.reset_launches()
    loss, grads = _lm_loss_and_grads(card, cfg)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 0
    ploss, pgrads = _lm_loss_and_grads(
        card, cfg.with_overrides(use_flash_attention=False))
    assert torch.equal(loss, ploss)
    assert all(torch.equal(a, b) for a, b in zip(grads, pgrads))
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="use_flash_attention=True"):
        _lm_loss_and_grads(card, cfg.with_overrides(use_flash_attention=True))


@pytest.mark.cuda
def test_default_attention_launches_the_kernel_on_bf16(card):
    from repro_torch.configs import get_arch
    cfg = get_arch("stablelm_3b").model.reduced(n_layers=2, d_model=256)
    K.reset_launches()
    _lm_loss_and_grads(card, cfg)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 2


# ----------------------------------------------------------------------- #
# the grid: its kernel shapes, and launches that do not grow with B
# ----------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name,b", [("pairdist", 36), ("cwtm", 18),
                                    ("median", 18)])
def test_grid_kernel_shapes_match_plain(card, name, b):
    """The table1 CNN grid's shapes (2 seeds): pairdist over its 36 NNM
    lanes, CWTM and median over 18 lanes each, D = 11,958."""
    x = _x(b, 13, 11958, 31, card)
    if name == "pairdist":
        got, want = pairdist_cuda(x), pairdist_ref(x)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            x.square().sum(-1).max())
        assert bool((got.diagonal(dim1=1, dim2=2) == 0).all())
    elif name == "cwtm":
        torch.testing.assert_close(cwtm_cuda(x, 3), cwtm_ref(x, 3),
                                   rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(median_cuda(x), median_ref(x), rtol=0,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 12])
def test_aggregator_bank_launches_once_per_branch(card, b):
    """A 2-branch bank (NNM+CWTM, NNM+median) over B lanes: one pairdist,
    one CWTM and one median launch a call, whatever B; each lane equals its
    lone rule."""
    from repro_torch.core import aggregators as G
    x = _x(b, 13, 777, 5, card)
    bank = G.make_aggregator_bank(G.AggregatorConfig(
        name="bank", f=3, bank=(("cwtm", True), ("median", True))),
        device=card)
    idx = [i % 2 for i in range(b)]
    K.reset_launches()
    out = bank(x, idx)
    got = K.launches()
    assert (got["pairdist"], got["cwtm"], got["median"]) == (1, 1, 1)
    for i in (0, 1):
        name = ("cwtm", "median")[idx[i]]
        lone = G.make_aggregator(G.AggregatorConfig(
            name=name, f=3, pre_nnm=True), device=card)
        torch.testing.assert_close(out[i], lone(x[i]), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_grid_rollout_on_the_card_matches_the_cpu(card):
    """table1-mini on the quadratic (d = 64), 2 seeds, 3 rounds, the same
    draws on both sides: every lane within 1e-5 of max |w| of the CPU's
    plain path; pairdist and CWTM launch once a round."""
    from repro_torch.core import sweep as SW
    from repro_torch.adversary import registry as R
    bank, = SW.plan_grid(R.expand_scenario("table1-mini")).banks
    k, n = bank.cfg.sparsifier.k(64), bank.cfg.n_workers
    out = {}
    for dev in (card, "cpu"):
        loss, p0, batch, _ = SW.quadratic_testbed(n, d=64, device=dev)
        sim = Simulator(loss, p0, bank.cfg, device=dev)
        draws = []
        for s in (0, 1):
            rng = np.random.default_rng(s)
            draws.append(ReplayDraws(dev, permutations=[
                rng.permutation(64)[:k] for _ in range(3 * (n + 1))]))
        K.reset_launches()
        st, m = SW.fused_grid_rollout(sim, bank.scenario_params(), (0, 1),
                                      batch, 3, draws=draws)
        out[str(dev)] = (st.params_flat.cpu(), K.launches())
    (gpu, launches), (cpu, _) = out[str(card)], out["cpu"]
    assert launches["pairdist"] == launches["cwtm"] == 3
    assert float((gpu - cpu).abs().max()) <= 1e-5 * float(cpu.abs().max())


def _fig1(**over):
    import dataclasses
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=13, f=3, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=AggregatorConfig(name="cwtm", f=3, pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5))
    return dataclasses.replace(cfg, **over)


@pytest.mark.cuda
def test_two_servers_in_one_process_serve_bitwise(card):
    """Two streaming servers in one process, their batcher threads
    launching pairdist and CWTM at once (on the default stream, which the
    kernels' shared ticket counters and scratch rely on): each ends
    bitwise a lone server's run, and every fired round launched once."""
    import threading
    from repro_torch.serve import (ByzantineRobustServer, ClientPool,
                                   run_service)
    d, rounds = 65536, 8
    cfg = _fig1()

    def serve(seed, out):
        loss, p0, batch, _ = quadratic_testbed(13, d=d, seed=0, device=card)
        server = ByzantineRobustServer(cfg, p0, seed=seed, device=card)
        run_service(server, ClientPool(loss, p0, cfg, batch, device=card),
                    rounds)
        out[seed] = server.params_flat.cpu()

    lone, both = {}, {}
    for seed in (0, 1):
        serve(seed, lone)
    K.reset_launches()
    threads = [threading.Thread(target=serve, args=(s, both))
               for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    launches = K.launches()
    assert launches["pairdist"] == launches["cwtm"] == 2 * rounds
    for seed in (0, 1):
        assert torch.equal(both[seed], lone[seed])
    assert not torch.equal(both[0], both[1])


@pytest.mark.cuda
def test_bf16_compute_round_on_the_card_matches_the_cpu(card):
    """One RoSDHB round computing in bfloat16, kernels on the card against
    the kernels' plain versions on the CPU, the same inputs and draws: the
    bank bitwise, the direction within one bfloat16 ulp of max |R|."""
    from repro_torch.core import algorithms as Alg
    d = 200_000
    cfg = _fig1(server_compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    g = rng.normal(size=(13, d)).astype(np.float32)
    m0 = rng.normal(size=(13, d)).astype(np.float32)
    perm = rng.permutation(d)[:cfg.sparsifier.k(d)]
    out = {}
    for dev in (card, "cpu"):
        st = Alg.init_state(cfg, d, device=dev)._replace(
            momentum=torch.tensor(m0, device=dev))
        K.reset_launches()
        r, new, _ = Alg.server_round(cfg, st, torch.tensor(g, device=dev),
                                     ReplayDraws(dev, permutations=[perm]))
        out[str(dev)] = (r.float().cpu(), new.momentum.cpu(), K.launches())
    (r, m, launches), (r_cpu, m_cpu, _) = out[str(card)], out["cpu"]
    assert r.dtype == torch.float32 and launches["pairdist"] == 1
    assert launches["cwtm"] == 1
    assert torch.equal(m, m_cpu)
    scale = float(r_cpu.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((r - r_cpu).abs().max()) <= ulp


# ----------------------------------------------------------------------- #
# flash attention under torch.func, and streamed rollouts
# ----------------------------------------------------------------------- #


@pytest.mark.cuda
def test_flash_under_vmap_of_vmap_of_grad_is_one_launch_each(card):
    """``vmap`` over lanes of ``vmap`` over workers of ``grad`` through the
    kernels at [2 lanes, 3 workers, 4, 32, 2, 64] bf16: one forward and one
    backward launch a call, over the folded [24, 32, 2, 64]; out within
    1e-2 and the gradients within 2e-2 of the plain version's largest
    entry (the bars of ``test_flash_kernels_match_plain``), the plain
    version in float32 under the same transforms."""
    from torch.func import grad, vmap

    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     attention_ref)
    gen = torch.Generator(device=card).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card)  # noqa
    q, k, v = (rnd(2, 3, 4, 32, 2, 64).to(torch.bfloat16) for _ in range(3))
    w = rnd(2, 3, 4, 32, 2, 64)

    def kernel(q, k, v):
        return FlashAttention.apply(q, k, v, True, None, 0)[0]

    def loss(attend):
        return lambda q, k, v, w: (attend(q, k, v).float() * w).sum()

    transformed = lambda f: vmap(vmap(grad(loss(f), argnums=(0, 1, 2))))  # noqa
    K.reset_launches()
    with torch.no_grad():
        out = vmap(vmap(kernel))(q, k, v)
    assert K.launches()["flash_fwd"] == 1
    K.reset_launches()
    grads = transformed(kernel)(q, k, v, w)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 1
    fq, fk, fv = (t.float() for t in (q, k, v))
    ref = vmap(vmap(attention_ref))(fq, fk, fv)
    ref_grads = transformed(attention_ref)(fq, fk, fv, w)
    for got, want, tol in [(out, ref, 1e-2)] + [
            (g, r, 2e-2) for g, r in zip(grads, ref_grads)]:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.float() - want).abs().max()
        assert float(err) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["stacked", "callable"])
def test_streamed_cnn_run_is_bitwise_rollout_on_the_card(card, source):
    """fig1-alie on the CNN (D = 11,958), 20 rounds through
    ``rollout_streaming`` (chunk 8, depth 2, a 4-round tail) against
    ``Simulator.rollout`` on the same schedule and draws: parameters,
    momentum and every per-round metric bitwise, one pairdist and one CWTM
    launch a round (cuDNN held to its deterministic algorithms)."""
    from repro_torch.core import mnist_testbed
    from repro_torch.core.simulator import stack_batches
    from repro_torch.testing import TorchDraws
    steps = 20
    loss, p0, batch_fn, _, _ = mnist_testbed(13, per_worker=100,
                                             device=card)
    batches = stack_batches(batch_fn, steps)
    sim = Simulator(loss, p0, _fig1(), device=card)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, wm = sim.rollout(sim.init(draws=TorchDraws(3, card)), batches)
        K.reset_launches()
        feed = ((lambda t: {k: v[t] for k, v in batches.items()})
                if source == "callable" else batches)
        got, gm, info = sim.rollout_streaming(
            sim.init(draws=TorchDraws(3, card)), feed, steps, chunk_size=8,
            prefetch_depth=2)
    finally:
        torch.backends.cudnn.deterministic = det
    assert K.launches()["pairdist"] == K.launches()["cwtm"] == steps
    assert info["rounds_run"] == steps and not info["early_exit"]
    assert torch.equal(got.params_flat, want.params_flat)
    assert torch.equal(got.server.momentum, want.server.momentum)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k


# ----------------------------------------------------------------------- #
# prefill and decode over KV caches, the vlm's train-mode forward, and the
# allocate-once model_init on the card
# ----------------------------------------------------------------------- #


def _served(device, cfg, params, steps=4):
    """Prefill a seeded prompt of 2 x 12, then ``steps`` greedy decode
    steps: the prefill's hidden states, the caches of the ``blocks`` stack
    after the steps (k and v; the latents; the mamba2 states), and the
    tokens."""
    from repro_torch.launch.serve import make_prompt
    from repro_torch.models import (cache_init, forward, logits_fn,
                                    make_decode_step)
    from repro_torch.utils.tree import tree_leaves, tree_map
    params = tree_map(lambda a: a.to(device), params)
    prompt = {k: torch.from_numpy(v).to(device) for k, v in make_prompt(
        cfg, 2, 12, np.random.default_rng(0)).items()}
    caches = cache_init(cfg, 2, 12 + steps, device=device)
    with torch.no_grad():
        h, caches, _ = forward(params, cfg, prompt, mode="prefill",
                               caches=caches)
        tok = torch.argmax(logits_fn(params, cfg, h[:, -1:]), -1)
    step = make_decode_step(cfg, prompt.get("image_embeddings"))
    toks = [tok]
    for i in range(steps):
        tok, caches = step(params, tok, caches, 12 + i)
        toks.append(tok)
    return h.cpu(), [t.cpu() for t in tree_leaves(caches["blocks"])], \
        torch.cat(toks, 1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama32_vision_11b", "musicgen_medium",
                                  "qwen25_3b", "dbrx_132b",
                                  "deepseek_v2_lite_16b", "mamba2_1_3b",
                                  "zamba2_7b"])
def test_decode_on_the_card_matches_the_cpu(card, arch):
    """The reduced float32 model (the serving launcher's CPU size):
    prefill hidden states and the caches after 4 decode steps within
    1e-4 of max |x| of the CPU's, the same greedy tokens (every family:
    MoE, MLA latents, mamba2 states, the hybrid's)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init
    cfg = get_arch(arch).model.reduced(n_layers=2, d_model=256) \
        .with_overrides(vocab_size=512, dtype="float32")
    params = model_init(cfg, torch.Generator().manual_seed(0))
    ch, ck, ctok = _served("cpu", cfg, params)
    gh, gk, gtok = _served(card, cfg, params)
    for got, want in [(gh, ch)] + list(zip(gk, ck)):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    assert torch.equal(gtok, ctok)


@pytest.mark.cuda
def test_vlm_train_forward_launches_flash_once_a_self_attention_layer(card):
    """bfloat16 vlm of one group (4 self-attention layers, 1 cross layer):
    the train-mode forward launches the flash forward 4 times (the cross
    layer takes the plain attention), the gradient the backward 4 times."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_model_batch
    from repro_torch.models import forward, lm_loss, model_init
    from repro_torch.utils.tree import tree_leaves
    cfg = get_arch("llama32_vision_11b").model.reduced(
        n_layers=2, d_model=256).with_overrides(n_layers=5,
                                                cross_attn_every=5)
    params = model_init(cfg, torch.Generator(device=card).manual_seed(0))
    batch = {k: torch.from_numpy(v[0]).to(card) for k, v in make_model_batch(
        np.random.default_rng(0), cfg, 1, 2, 128).items()}
    K.reset_launches()
    with torch.no_grad():
        h, _, _ = forward(params, cfg, batch, mode="train")
    assert K.launches()["flash_fwd"] == 4 and bool(torch.isfinite(h).all())
    K.reset_launches()
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    grads = torch.autograd.grad(lm_loss(params, cfg, batch), leaves)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 4
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_3b", "llama32_vision_11b",
                                  "musicgen_medium"])
def test_model_init_on_the_card_is_the_per_layer_draws(card, arch):
    """Each stacked leaf filled on the card holds the bits of fresh
    per-layer draws from the same generator, the layers drawn in order."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init
    from repro_torch.models import transformer as T
    from repro_torch.utils.tree import tree_leaves
    cfg = get_arch(arch).model.reduced(n_layers=4, d_model=256)
    got = model_init(cfg, torch.Generator(device=card).manual_seed(3))
    gen = torch.Generator(device=card).manual_seed(3)
    if cfg.input_kind == "tokens":
        assert torch.equal(got["embed"], torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=card)
            * 0.02)
    if "lm_head" in got:
        assert torch.equal(got["lm_head"], torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=card)
            * 0.02)
    g, per, _ = T._vlm_groups(cfg) if cfg.family == "vlm" else \
        (1, cfg.n_layers, 0)
    n = g * per  # the self-attention blocks, drawn first
    stacked = tree_leaves(got["blocks"])
    for i in range(n):
        fresh = tree_leaves(T._attn_block_init(gen, cfg, device=card))
        for s, f in zip(stacked, fresh):
            assert torch.equal(s.reshape((-1,) + f.shape)[i], f)


@pytest.mark.cuda
def test_hybrid_train_forward_launches_flash_once_a_group_at_head_dim_112(
        card):
    """bfloat16 zamba2 of 3 groups of 2 mamba2 blocks and one trailing, its
    shared attention at head dim 112: the train-mode forward launches the
    flash forward once a group (3), padded to 128, the gradient the
    backward 3 times; within 5e-2 of max |h| of the plain attention's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, lm_loss, model_init
    from repro_torch.utils.tree import tree_leaves
    cfg = get_arch("zamba2_7b").model.reduced(n_layers=2, d_model=256) \
        .with_overrides(n_layers=7, attn_every=2, head_dim=112)
    params = model_init(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator(device=card).manual_seed(1),
                         device=card)
    K.reset_launches()
    with torch.no_grad():
        h, _, _ = forward(params, cfg, {"tokens": toks}, mode="train")
        plain, _, _ = forward(params, cfg.with_overrides(
            use_flash_attention=False), {"tokens": toks}, mode="train")
    assert K.launches()["flash_fwd"] == 3
    assert float((h.float() - plain.float()).abs().max()) <= \
        5e-2 * float(plain.float().abs().max())
    K.reset_launches()
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    grads = torch.autograd.grad(lm_loss(params, cfg, {"tokens": toks}),
                                leaves)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 3
    assert all(bool(torch.isfinite(g).all()) for g in grads)
