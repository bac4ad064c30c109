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


def _with_nan(b, n, d, seed, device):
    """Draws with NaN (none, one or two a coordinate, in any row) and
    +-inf among them."""
    x = _x(b, n, d, seed, "cpu")
    rng = np.random.default_rng(seed)
    for j in range(d):
        for r in rng.choice(n, size=j % 3, replace=False):
            x[:, r, j] = float("nan")
    x[:, rng.integers(n), ::7] = float("inf")
    x[:, rng.integers(n), ::11] = -float("inf")
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f,d", [(1, 8, 1, 3000), (2, 13, 3, 1000),
                                     (1, 7, 2, 999)])
def test_sort_kernels_put_nan_last_as_their_plain_versions(card, b, n, f,
                                                            d):
    """CWTM and the median with NaN and +-inf among a coordinate's values:
    the kernel sorts NaN after every number, as ``torch.sort`` (the plain
    versions) does, so a NaN at a trimmed rank is trimmed (the earlier
    network's fminf/fmaxf dropped it and repeated another value); the
    median is NaN wherever one is present, as its plain version."""
    x = _with_nan(b, n, d, 21, card)
    torch.testing.assert_close(cwtm_cuda(x, f), cwtm_ref(x, f), rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    torch.testing.assert_close(median_cuda(x), median_ref(x), rtol=0,
                               atol=1e-6, equal_nan=True)


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


def _graph_kernel_names(graph) -> list:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), read through libcuda's graph calls: each kernel
    node's function name, and ``"node type <t>"`` for any other node (a
    copy, a memset). A count that does not depend on the profiler's CUPTI
    window."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"node type {kind.value}")
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2 (under 128 bytes), the function first
        params = (ctypes.c_void_p * 16)()
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                params) == 0
        name = ctypes.c_char_p()
        assert cu.cuFuncGetName(ctypes.byref(name),
                                ctypes.c_void_p(params[0])) == 0
        names.append(name.value.decode())
    return names


@pytest.mark.cuda
def test_pairdist_is_one_device_kernel_at_the_cnn_shape(card):
    """Four calls captured in a CUDA graph are four nodes, each a launch
    of ``pairdist_kernel``, and no other node; replayed, each gives the
    eager call's distances bit for bit. The graph's nodes are read through
    libcuda (``cuGraphGetNodes``): a profiler window (CUPTI) once saw 3 of
    the 4 launches on an H100."""
    x = _x(1, 13, 11958, 23, card)
    want = pairdist_cuda(x)  # the first call sets the cluster attribute
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        outs = [pairdist_cuda(x) for _ in range(4)]
    names = _graph_kernel_names(graph)
    assert len(names) == 4 and all("pairdist_kernel" in m for m in names)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_compress_rows_into_one_payload(card, dtype):
    """The streamed train step's calls: each row of a bank compressed on
    its own into its row of one payload (``out=``), bitwise the whole
    bank's compress; an ``out`` of another shape or dtype raises."""
    from repro_torch.kernels.randk import block_compress_cuda
    from repro_torch.utils.dtypes import to_dtype
    n, bs, nb, kb = 5, 512, 40, 9
    g = to_dtype(_x(1, n, nb * bs, 13, card)[0], dtype)
    ids = torch.tensor(np.random.default_rng(13).permutation(nb)[:kb],
                       dtype=torch.int64, device=card)
    whole = block_compress_cuda(g, ids, bs, nb / kb)
    pay = torch.empty_like(whole)
    for w in range(n):
        got = block_compress_cuda(g[w:w + 1], ids, bs, nb / kb,
                                  out=pay[w:w + 1])
        assert got.data_ptr() == pay[w:w + 1].data_ptr()
    assert torch.equal(pay.view(torch.uint8), whole.view(torch.uint8))
    with pytest.raises(ValueError, match="out"):
        block_compress_cuda(g[:1], ids, bs, 1.0, out=pay[:2])
    with pytest.raises(ValueError, match="out"):
        block_compress_cuda(g[:1], ids, bs, 1.0,
                            out=torch.empty((1, kb * bs), device=card,
                                            dtype=torch.float16))


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
    f32 = (lambda: {"out": torch.empty(n, d, device=card)}
           if dtype == torch.bfloat16 else {})
    K.reset_launches()
    m_k, m_p = m0.clone(), m0.clone()
    out_k = momentum_scatter_cuda(m_k, pay, ids, bs, beta, **f32())
    out_p = momentum_scatter_ref(m_p, pay, ids, bs, beta, **f32())
    torch.cuda.synchronize()
    assert K.launches()["momentum_scatter"] == 1
    assert torch.equal(_bits(m_k), _bits(m_p))
    assert torch.equal(_bits(out_k), _bits(out_p))


@pytest.mark.cuda
def test_momentum_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.randk import momentum_scatter_cuda
    m = torch.zeros(2, 1024, device=card)
    pay = torch.zeros(2, 256, device=card)
    with pytest.raises(ValueError, match="narrower than float32"):
        momentum_scatter_cuda(m, pay, torch.tensor([0, 1]), 128, 0.9,
                              out=torch.empty(2, 1024, device=card))
    with pytest.raises(ValueError, match="block ids"):
        momentum_scatter_cuda(m, pay, torch.tensor([0]), 128, 0.9)
    with pytest.raises(ValueError, match="multiple of 4"):
        momentum_scatter_cuda(m, pay, torch.tensor([0, 1]), 126, 0.9)
    with pytest.raises(ValueError, match="aligned"):
        momentum_scatter_cuda(torch.zeros(2049, device=card)[1:].view(2, 1024),
                              pay, torch.tensor([0, 1]), 128, 0.9)


def _lowp(x, dtype):
    from repro_torch.utils.dtypes import to_dtype
    return to_dtype(x, dtype)


def _bits_any(t):
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


WINDOW_DTYPES = [torch.float32, torch.bfloat16, torch.float16,
                 torch.float8_e4m3fn]


@pytest.mark.cuda
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("window", [(0, 5), (5, 12), (12, 19)])
@pytest.mark.parametrize("dtype", WINDOW_DTYPES)
def test_windowed_momentum_kernel_bitwise(card, dtype, window, local):
    """The momentum kernel on a first, a middle and a ragged last window of
    19 blocks, bitwise its plain version on the same window: the window of
    the bank, the float32 result (banks narrower than float32, into a
    caller's buffer of a wider row stride) and the rest of the bank left
    as it was; one launch, the slot map built by the caller."""
    from repro_torch.kernels.randk import (momentum_scatter_cuda,
                                           momentum_scatter_ref, slot_map)
    n, bs, nb, kb, beta = 4, 512, 19, 6, 0.9
    b0, b1 = window
    m0 = _lowp(_x(1, n, nb * bs, 16, card)[0] * 60, dtype)
    m0[:, ::5] = -0.0
    pay = _lowp(_x(1, n, kb * bs, 17, card)[0], dtype)
    rng = np.random.default_rng(b0)
    ids = torch.tensor(np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
                       if local else rng.permutation(nb)[:kb],
                       dtype=torch.int32, device=card)
    slots = slot_map(ids, nb)
    narrow = dtype != torch.float32
    w = (b1 - b0) * bs
    wide_k = torch.full((n, w + bs), float("nan"), device=card)
    out_p = torch.empty((n, w), device=card) if narrow else None
    kw_k = {"out": wide_k[:, :w]} if narrow else {}
    K.reset_launches()
    m_k, m_p = m0.clone(), m0.clone()
    got = momentum_scatter_cuda(m_k, pay, ids, bs, beta, window=(b0, b1),
                                slots=slots, **kw_k)
    torch.cuda.synchronize()
    assert K.launches()["momentum_scatter"] == 1
    want = momentum_scatter_ref(m_p, pay, ids, bs, beta, window=(b0, b1),
                                out=out_p)
    assert torch.equal(_bits_any(m_k), _bits_any(m_p))
    cols = torch.zeros(nb * bs, dtype=torch.bool, device=card)
    cols[b0 * bs:b1 * bs] = True
    assert torch.equal(_bits_any(m_k[:, ~cols]), _bits_any(m0[:, ~cols]))
    if narrow:
        assert got is kw_k["out"]
        assert torch.equal(_bits_any(got), _bits_any(want))
        assert bool(torch.isnan(wide_k[:, w:]).all())
    else:
        assert got is m_k


@pytest.mark.cuda
def test_momentum_wrapper_rejects_a_bad_window(card):
    from repro_torch.kernels.randk import momentum_scatter_cuda, slot_map
    m = torch.zeros(2, 4 * 128, dtype=torch.bfloat16, device=card)
    pay = torch.zeros(2, 128, dtype=torch.bfloat16, device=card)
    ids = torch.tensor([1], dtype=torch.int32, device=card)
    for window in ((2, 2), (-1, 2), (3, 5)):
        with pytest.raises(ValueError, match="window"):
            momentum_scatter_cuda(m, pay, ids, 128, 0.9, window=window)
    with pytest.raises(ValueError, match="out must be"):
        momentum_scatter_cuda(m, pay, ids, 128, 0.9, window=(0, 2),
                              out=torch.empty(2, 128, device=card))
    with pytest.raises(ValueError, match="out must be"):
        momentum_scatter_cuda(m, pay, ids, 128, 0.9, window=(0, 2),
                              out=torch.empty(2, 512, device=card)[:, 2:258])
    with pytest.raises(ValueError, match="slots"):
        momentum_scatter_cuda(m, pay, ids, 128, 0.9,
                              slots=slot_map(ids, 4).long())


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", ["bfloat16", "float16", "float8_e4m3fn"])
def test_sliced_payload_round_on_the_card_matches_the_cpu(card, mdt,
                                                          monkeypatch):
    """RoSDHB's payload round by column slices (windows of 5 blocks of 512
    over 37: the last of 2), on the card against the same round on the
    CPU: the bank bitwise (the kernel is its plain version), the direction
    within rtol 1e-5 of max |R| (CWTM's kernel and plain version sum in
    other orders), one compress and, a window, one ``momentum_scatter`` and
    one CWTM launch."""
    from repro_torch.core import algorithms as Alg
    from repro_torch.core import make_aggregator
    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 5 * 512)
    n, bs, nb = 8, 512, 37
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=n, f=1, beta=0.9, momentum_dtype=mdt,
        sparsifier=SparsifierConfig(kind="block", ratio=0.25, block_size=bs),
        aggregator=AggregatorConfig(name="cwtm", f=1),
        attack=AttackConfig(name="alie"))
    assert Alg._payload_window(cfg, nb * bs) == 5
    dt = Alg.BANK_DTYPES[mdt]
    g = _lowp(_x(1, n, nb * bs, 18, "cpu")[0], dt)
    m0 = _lowp(_x(1, n, nb * bs, 19, "cpu")[0], dt)
    ids = np.random.default_rng(1).permutation(nb)[:9]
    out = {}
    for dev in ("cpu", card):
        state = Alg.init_state(cfg, nb * bs, device=dev)._replace(
            momentum=m0.clone().to(dev))
        K.reset_launches()
        r, new, _ = Alg.server_round(
            cfg, state, g.to(dev), ReplayDraws(dev, permutations=[ids]),
            agg=make_aggregator(cfg.aggregator, device=dev))
        out[str(dev)] = (r.cpu(), new.momentum.cpu(), K.launches())
    (r_c, m_c, _), (r_g, m_g, got) = out["cpu"], out[str(card)]
    assert got["block_compress"] == 1 and got["block_decompress"] == 0
    assert got["momentum_scatter"] == got["cwtm"] == 8
    assert torch.equal(_bits_any(m_g), _bits_any(m_c))
    torch.testing.assert_close(r_g, r_c, rtol=0, atol=1e-5 * float(
        r_c.abs().max()))


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
# head dim 256 (gemma_2b's), whose tiles are its own (64 keys a forward
# stage and a dk/dv block, 32 keys a dq stage)
FLASH += [(2, 129, 129, 8, 1, 256, True, None, 0),
          (1, 127, 127, 8, 2, 256, True, None, 0),
          (1, 257, 257, 4, 1, 256, True, 100, 0),
          (2, 65, 193, 4, 1, 256, True, 70, 128),
          (1, 63, 191, 8, 1, 256, False, None, 0),
          (1, 33, 97, 2, 1, 256, True, 40, 64)]


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
def test_flash_at_head_dim_112_launches_the_kernel_unpadded(card):
    """zamba2's shared attention head dim: ``flash_attention`` launches
    the kernels at 112 as it is (one forward and one backward launch, no
    pad: the kernels see the caller's tensors), held against the plain
    version at 112 (out within 1e-2, dq, dk, dv within 2e-2 of the
    largest entry)."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    gen = torch.Generator(device=card).manual_seed(112)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card).to(  # noqa
        torch.bfloat16)
    q, k, v, dout = (rnd(1, 256, 4, 112) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    seen = []
    kernel = FO._kernel

    def spy(q, *args):
        seen.append((q.shape[-1], args[5:]))  # args[5:]: a scale
        return kernel(q, *args)
    FO._kernel = spy
    try:
        K.reset_launches()
        out = flash_attention(*leaves)
        grads = torch.autograd.grad(out, leaves, dout)
    finally:
        FO._kernel = kernel
    assert seen == [(112, ())]  # no pad, the default scale
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
        flash_fwd_cuda(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="one dtype"):
        flash_fwd_cuda(q.float(), q, q)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_cuda(q[..., :48].contiguous(), q[..., :48].contiguous(),
                       q[..., :48].contiguous())
    with pytest.raises(ValueError, match="no visible key"):
        flash_fwd_cuda(q, q, q, window=8, q_offset=80)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_offset", FLASH)
def test_float32_flash_kernels_match_plain(card, b, sq, sk, h, kv, d, causal,
                                           window, q_offset):
    """The float32 kernels (``csrc/flash_attention_f32.cu``) at every
    bf16 case: out, dq, dk and dv float32 within 1e-5 of the plain
    version's largest entry (float32 on both sides, sums in other orders),
    one launch of each float32 wrapper and none of the bf16 ones."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card)  # noqa
    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, sq, h, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    got = K.launches()
    assert (got["flash_fwd_f32"], got["flash_bwd_f32"], got["flash_fwd"],
            got["flash_bwd"]) == (1, 1, 0, 0)
    fl = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention_ref(*fl, **kw)
    ref_grads = torch.autograd.grad(ref, fl, dout)
    for g, w in [(out, ref)] + list(zip(grads, ref_grads)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = (g.detach() - w.detach()).abs().max()
        assert float(err) <= 1e-5 * float(w.detach().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
def test_float32_flash_backward_repeats_bitwise(card, d):
    from repro_torch.kernels.flash_attention import (flash_bwd_f32_cuda,
                                                     flash_fwd_f32_cuda)
    q = _x(1, 256, 16 * d, 1, card).reshape(1, 256, 16, d)
    k = q[:, :, :4].contiguous()
    o, lse = flash_fwd_f32_cuda(q, k, k)
    assert o.dtype == lse.dtype == torch.float32
    a = flash_bwd_f32_cuda(q, k, k, o, lse, q)
    b = flash_bwd_f32_cuda(q, k, k, o, lse, q)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="dout"):
        flash_bwd_f32_cuda(q, k, k, o, lse, q.to(torch.bfloat16))


# the float32 kernels at head dim 112, which they take unpadded, and where
# their dk/dv blocks split (flash.dkdv_plan: Sk no multiple of a key block,
# a window, q_offset > 0; MQA at 256, where dq reads dk/dv's dS^T, and GQA
# at 80)
FLASH_F32_EXTRA = [(2, 129, 129, 8, 2, 112, True, None, 0),
                   (1, 257, 257, 4, 2, 112, True, 100, 0),
                   (2, 65, 193, 4, 1, 112, True, 70, 128),
                   (1, 300, 1000, 8, 1, 256, True, 200, 700),
                   (2, 250, 700, 16, 2, 80, True, 300, 450)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_offset",
                         FLASH_F32_EXTRA)
def test_float32_flash_kernels_take_112_and_split_dkdv(
        card, b, sq, sk, h, kv, d, causal, window, q_offset):
    """Head dim 112 runs unpadded on the float32 kernels, and the dk/dv
    split adds up: out, dq, dk and dv within 1e-5 of the plain version's
    largest entry, the backward bitwise equal on repeat, and the split
    where the plan says (every small grid here splits)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     dkdv_plan,
                                                     flash_bwd_f32_cuda,
                                                     flash_fwd_f32_cuda,
                                                     padded_dim)
    assert padded_dim(d, torch.float32) == d
    case = (b, sq, sk, h, kv, d, causal, window, q_offset)
    assert dkdv_plan(*case, sms=build.sm_count(0),
                     dtype=torch.float32)["nsplit"] > 1
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card)  # noqa
    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, sq, h, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_fwd_f32_cuda(q, k, v, **kw)
    grads = flash_bwd_f32_cuda(q, k, v, o, lse, dout, **kw)
    again = flash_bwd_f32_cuda(q, k, v, o, lse, dout, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    fl = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention_ref(*fl, **kw)
    ref_grads = torch.autograd.grad(ref, fl, dout)
    for g, w in [(o, ref)] + list(zip(grads, ref_grads)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = (g - w.detach()).abs().max()
        assert float(err) <= 1e-5 * float(w.detach().abs().max())


# the bf16 kernels where their dk/dv blocks split (flash.dkdv_plan with the
# bf16 tiles), at head dim 256 (dq from dk/dv's dS^T) with a window and a
# q_offset, at 112, and at KV 2 with Sk no multiple of a key block; and
# the short-sequence forward (Sq, Sk <= 64: one item a warpgroup),
# transformer-table1's folded call and a GQA continuation chunk
FLASH_BF16_SPLIT = [(1, 300, 1000, 8, 1, 256, True, 200, 700),
                    (2, 129, 129, 8, 1, 256, True, None, 0),
                    (2, 129, 129, 8, 2, 112, True, None, 0),
                    (1, 1000, 1000, 8, 2, 128, True, None, 0)]
FLASH_SHORT = [(288, 32, 32, 2, 2, 64, True, None, 0),
               (3, 40, 64, 8, 2, 128, True, None, 24),
               (2, 64, 64, 4, 1, 256, False, None, 0),
               (5, 17, 33, 4, 4, 112, True, 8, 16)]


def _bf16_case(card, case, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    b, sq, sk, h, kv, d = case[:6]
    rnd = lambda *s: torch.randn(s, generator=gen, device=card).to(  # noqa
        torch.bfloat16)
    return rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, sq, h, d)


def _against_plain(q, k, v, out, grads, dout, kw):
    """out within 1e-2 and dq, dk, dv within 2e-2 of the plain version's
    largest entry (float32 from the same bf16 inputs)."""
    from repro_torch.kernels.flash_attention import attention_ref
    fl = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention_ref(*fl, **kw)
    ref_grads = torch.autograd.grad(ref, fl, dout.float())
    for got, want, tol in [(out, ref, 1e-2)] + [
            (g, w, 2e-2) for g, w in zip(grads, ref_grads)]:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.detach().float() - want.detach()).abs().max()
        assert float(err) <= tol * float(want.detach().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_offset",
                         FLASH_BF16_SPLIT)
def test_bf16_flash_split_and_ds_paths_match_plain(card, b, sq, sk, h, kv,
                                                   d, causal, window,
                                                   q_offset):
    """The bf16 backward where dk/dv splits (and at 256 writes dS^T for
    dq) matches the plain version, with the split the plan says."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (dkdv_plan,
                                                     flash_bwd_cuda,
                                                     flash_fwd_cuda)
    case = (b, sq, sk, h, kv, d, causal, window, q_offset)
    assert dkdv_plan(*case, sms=build.sm_count(0))["nsplit"] > 1
    q, k, v, dout = _bf16_case(card, case, sq + sk + d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    grads = flash_bwd_cuda(q, k, v, o, lse, dout, **kw)
    _against_plain(q, k, v, o, grads, dout, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_bf16_flash_backward_repeats_bitwise(card, d):
    """Two bf16 backward runs at a split shape (and at 256 through dS^T)
    are bitwise equal: the partial sums are added in split order, no
    atomics."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (dkdv_plan,
                                                     flash_bwd_cuda,
                                                     flash_fwd_cuda)
    q = _x(1, 512, 8 * d, 1, card).reshape(1, 512, 8, d).to(torch.bfloat16)
    k = q[:, :, :2].contiguous()
    assert dkdv_plan(1, 512, 512, 8, 2, d, True, None, 0,
                     build.sm_count(0))["nsplit"] > 1
    o, lse = flash_fwd_cuda(q, k, k)
    a = flash_bwd_cuda(q, k, k, o, lse, q)
    b = flash_bwd_cuda(q, k, k, o, lse, q)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_offset",
                         FLASH_SHORT)
def test_bf16_short_forward_matches_plain(card, b, sq, sk, h, kv, d, causal,
                                          window, q_offset):
    """The forward at Sq, Sk <= 64 (each consumer warpgroup its own
    (batch, head) item) matches the plain version, and so does the
    backward after it."""
    from repro_torch.kernels.flash_attention import flash_attention
    case = (b, sq, sk, h, kv, d, causal, window, q_offset)
    q, k, v, dout = _bf16_case(card, case, 7 + sq + d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 1
    _against_plain(q, k, v, out, grads, dout, kw)


@pytest.mark.cuda
def test_float32_attention_launches_the_float32_kernels(card):
    """A float32 config's train-mode attention takes the float32 kernels
    (``use_flash_attention=None``): a 2-layer model's loss and gradients
    launch each float32 wrapper once a layer and no bf16 one, and agree
    with the plain path within 1e-5 (loss, relative) and 1e-4 of each
    gradient's largest entry (float32 sums in other orders through two
    layers)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=256).with_overrides(dtype="float32")
    K.reset_launches()
    loss, grads = _lm_loss_and_grads(card, cfg)
    got = K.launches()
    assert (got["flash_fwd_f32"], got["flash_bwd_f32"], got["flash_fwd"],
            got["flash_bwd"]) == (2, 2, 0, 0)
    ploss, pgrads = _lm_loss_and_grads(
        card, cfg.with_overrides(use_flash_attention=False))
    assert float(loss) == pytest.approx(float(ploss), rel=1e-5)
    for g, w in zip(grads, pgrads):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


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
    launches flash fwd/bwd n_layers x n_workers times a step, compress
    once a worker, the momentum kernel and CWTM once (the streamed payload
    route: no decompress); it agrees with the plain path (same seed and
    draws) within rtol 5e-3 on the honest loss and 2e-2 on |R| (bf16
    rounding in the attention kernels)."""
    K.reset_launches()
    kern = _reduced_llm_steps(card, plain=False)
    got = K.launches()
    assert got["flash_fwd"] == got["flash_bwd"] == 2 * 8 * 2
    assert got["block_compress"] == 2 * 8 and got["momentum_scatter"] == 2
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
@pytest.mark.parametrize("case", ["float16"])
def test_attention_takes_the_plain_path_where_the_kernel_cannot(card, case):
    """A float16 config (the kernels take bfloat16 and float32) runs
    forward and backward on the card through ``causal_attention``, equal
    to the plain path, with no flash launch; asking for the kernel
    raises."""
    from repro_torch.configs import get_arch
    base = get_arch("stablelm_3b").model.reduced(n_layers=1, d_model=256)
    cfg = base.with_overrides(dtype=case)
    K.reset_launches()
    loss, grads = _lm_loss_and_grads(card, cfg)
    assert all(K.launches()[k] == 0 for k in (
        "flash_fwd", "flash_bwd", "flash_fwd_f32", "flash_bwd_f32"))
    ploss, pgrads = _lm_loss_and_grads(
        card, cfg.with_overrides(use_flash_attention=False))
    assert torch.equal(loss, ploss)
    assert all(torch.equal(a, b) for a, b in zip(grads, pgrads))
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="use_flash_attention=True"):
        _lm_loss_and_grads(card, cfg.with_overrides(use_flash_attention=True))


@pytest.mark.cuda
def test_attention_at_head_dim_256_launches_the_kernel_once_a_layer(card):
    """gemma_2b's head dim, 256, on its one kv head: a 2-layer bf16
    model's loss and gradients launch the flash forward and backward once
    a layer; one layer's attention output within 1e-2 and the gradients of
    its input and weights within 2e-2 of the plain path's largest entry
    (``chip_smoke.FLASH_TOL_OUT``, ``FLASH_TOL_GRAD``: P and dS rounded to
    bf16 for the tensor cores)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg = get_arch("gemma_2b").model.reduced(
        n_layers=2, d_model=256).with_overrides(head_dim=256)
    assert cfg.resolved_head_dim == 256 and cfg.n_kv_heads == 1
    K.reset_launches()
    _lm_loss_and_grads(card, cfg)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 2
    gen = torch.Generator(device=card).manual_seed(256)
    p = L.attn_init(gen, cfg)
    x = torch.randn(2, 160, cfg.d_model, generator=gen, device=card).to(
        torch.bfloat16)
    dy = torch.randn(2, 160, cfg.d_model, generator=gen, device=card).to(
        torch.bfloat16)

    weights, treedef = tree_flatten(p)

    def run(flash):
        leaves = [t.detach().clone().requires_grad_() for t in
                  [x] + weights]
        params = tree_unflatten(treedef, leaves[1:])
        y, _ = L.attn_apply(params, cfg.with_overrides(
            use_flash_attention=flash), leaves[0])
        return y, torch.autograd.grad(y, leaves, dy)

    K.reset_launches()
    y, grads = run(None)
    assert K.launches()["flash_fwd"] == K.launches()["flash_bwd"] == 1
    y_p, grads_p = run(False)
    assert K.launches()["flash_fwd"] == 1
    for got, want, tol in [(y, y_p, 1e-2)] + [
            (g, w, 2e-2) for g, w in zip(grads, grads_p)]:
        err = (got.detach().float() - want.detach().float()).abs().max()
        assert float(err) <= tol * float(want.detach().float().abs().max())


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


def _ulps_off(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many steps of their dtype apart two tensors of one narrow dtype
    are (NaN alike), by their bit patterns taken as signed magnitudes."""
    bits = {1: torch.uint8, 2: torch.int16}[got.element_size()]
    wide = lambda t: t.view(bits).to(torch.int32)  # noqa: E731
    top = 1 << (8 * got.element_size() - 1)

    def key(t):
        v = wide(t) & (2 * top - 1)
        return torch.where(v >= top, top - v, v)

    both_nan = torch.isnan(got.float()) & torch.isnan(want.float())
    return torch.where(both_nan, 0, (key(got) - key(want)).abs())


def _steps_off(got, want, x):
    """:func:`_ulps_off`, 0 where the two differ by no more than 2^-20 of
    max |x| (two float32 sums of x's values in other orders: near zero
    that is several steps of a float16 result)."""
    xf = x.float()
    scale = float(xf[torch.isfinite(xf)].abs().max())
    near = (got.float() - want.float()).abs() <= 2.0 ** -20 * scale
    return torch.where(near, 0, _ulps_off(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float16, torch.float8_e4m3fn])
@pytest.mark.parametrize("b,n,f,d", [(1, 13, 3, 11958), (3, 13, 3, 300),
                                     (2, 8, 1, 1001), (1, 7, 0, 130),
                                     (2, 64, 20, 999), (1, 5, 2, 257)])
def test_float16_and_float8_inputs_match_plain(card, dt, b, n, f, d):
    """pairdist, CWTM and the median on float16 and float8_e4m3fn inputs
    (n = 13 and 5 padded): pairdist float32 within 1e-5 of max |x|^2 with
    a zero diagonal; CWTM and the median in the input dtype, within one
    step of it of their plain versions (the kernel sums rank weights, the
    plain version the sum times 1/k), the median bitwise (its weights are
    1 or 1/2: exact). Near zero "one step" reads as 2^-20 of max |x|
    (:func:`_steps_off`)."""
    from repro_torch.utils.dtypes import to_dtype
    x = to_dtype(_x(b, n, d, 31, card), dt)
    got = pairdist_cuda(x)
    want = pairdist_ref(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        x.float().square().sum(-1).max())
    assert bool((got.diagonal(dim1=1, dim2=2) == 0).all())
    if n > 2 * f:
        c = cwtm_cuda(x, f)
        assert c.dtype == dt and torch.isfinite(c.float()).all()
        assert int(_steps_off(c, cwtm_ref(x, f), x).max()) <= 1
    m = median_cuda(x)
    assert m.dtype == dt
    assert int(_ulps_off(m, median_ref(x)).max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float16, torch.float8_e4m3fn])
def test_sort_kernels_order_nan_last_at_float16_and_float8(card, dt):
    """NaN among a coordinate's float16 or float8 values: CWTM trims it,
    the median is NaN, as their plain versions."""
    from repro_torch.utils.dtypes import to_dtype
    x = _with_nan(2, 13, 777, 23, card)
    x = to_dtype(x.clamp(-400, 400), dt)  # float8 has no inf
    assert int(_steps_off(cwtm_cuda(x, 3), cwtm_ref(x, 3), x).max()) <= 1
    assert int(_ulps_off(median_cuda(x), median_ref(x)).max()) == 0


@pytest.mark.cuda
def test_cwtm_at_float16_compute_through_make_aggregator(card):
    """RoSDHB at ``server_compute_dtype="float16"`` hands float16 momenta to
    its aggregator: CWTM (and NNM's pairdist) on CUDA tensors launch the
    kernels on them, matching the CPU run within one float16 step."""
    from repro_torch.core.aggregators import make_aggregator
    x = _x(1, 8, 5000, 41, card, torch.float16)[0]
    for pre in (False, True):
        cfg = AggregatorConfig(name="cwtm", f=1, pre_nnm=pre)
        K.reset_launches()
        got = make_aggregator(cfg, device="cuda")(x)
        launched = K.launches()
        assert launched["cwtm"] == 1 and launched["pairdist"] == int(pre)
        want = make_aggregator(cfg, device="cpu")(x.cpu())
        assert got.dtype == torch.float16
        assert int(_steps_off(got.cpu(), want, x).max()) <= 1


# --------------------------------------------------------------------------
# The sort kernels' narrow classes: V coordinates a thread, pairs sorted in
# f16x2/bf16x2 (sorted_weight.cu), tiles of bytes widened once (pairdist.cu)
# --------------------------------------------------------------------------

NARROW = [torch.bfloat16, torch.float16, torch.float8_e4m3fn]
ODD_D = list(range(1, 34)) + [4099, 11958]
# Row lengths whose grid takes the vector plan at n = 13 (V = 4; over
# VEC_MIN_THREADS_PER_SM threads an SM of an H100): odd, 2 and 4 mod 8.
VEC_D = [300_001, 300_002, 300_004]


def _vec(x):
    """Coordinates a thread the sorted-weight plan takes for ``x``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.cwtm.cwtm import plan_vec
    return plan_vec(*x.shape, x.element_size(), build.sm_count(0))


def _narrow(x, dt, offset=0):
    """``x`` rounded to ``dt`` (float8: the reference's cast), copied into
    a tensor that starts ``offset`` elements into its storage."""
    from repro_torch.utils.dtypes import to_dtype
    v = to_dtype(x, dt)
    flat = torch.empty(v.numel() + offset, dtype=dt, device=v.device)
    out = flat[offset:].view(v.shape)
    out.copy_(v)
    return out


def _rounded_f32_kernel(x, kernel):
    """The float32 kernel on ``x`` widened, rounded to ``x``'s dtype: the
    narrow classes sort the same values and sum them in the same order, so
    they must give these bits (NaN alike)."""
    from repro_torch.utils.dtypes import to_dtype
    return to_dtype(kernel(x.float()), x.dtype)


def _same_narrow(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int(_ulps_off(got, want).max()) == 0
    # _ulps_off reads -0 and +0 as one value: the bits must agree too
    same = got.view(torch.uint8 if got.element_size() == 1 else torch.int16
                    ) == want.view(torch.uint8 if want.element_size() == 1
                                   else torch.int16)
    nan = torch.isnan(got.float()) & torch.isnan(want.float())
    assert bool((same | nan).all())


def _sort_checks(x, f):
    """CWTM and the median on narrow ``x``: the float32 kernel's bits
    rounded; against the plain versions within one step (the median
    bitwise), NaN at their places."""
    if x.shape[1] > 2 * f:
        got = cwtm_cuda(x, f)
        _same_narrow(got, _rounded_f32_kernel(x, lambda t: cwtm_cuda(t, f)))
        assert int(_steps_off(got, cwtm_ref(x, f), x).max()) <= 1
    got = median_cuda(x)
    _same_narrow(got, _rounded_f32_kernel(x, median_cuda))
    assert int(_ulps_off(got, median_ref(x)).max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", NARROW)
def test_narrow_sort_kernels_keep_signed_zeros(card, dt):
    """-0.0 and +0.0 among a coordinate's values (and values that round to
    zero): f16x2/bf16x2 min/max order them as the float32 network does."""
    x = _x(2, 13, 300_001, 41, card)
    rng = np.random.default_rng(41)
    zero = torch.tensor(rng.random(x.shape) < 0.4, device=card)
    sign = torch.tensor(rng.random(x.shape) < 0.5, device=card)
    x = torch.where(zero, torch.where(sign, -0.0, 0.0), x)
    x[:, :, ::5] = torch.where(sign[:, :, ::5], -1e-4, 1e-4)
    x[:, :, ::9] = torch.where(sign[:, :, ::9], -0.0, 0.0)
    xs = _narrow(x, dt)
    assert bool((xs.float() == 0).any() & torch.signbit(xs.float()).any())
    assert _vec(xs) > 1  # the pairs kernel
    _sort_checks(xs, 3)
    x8 = _narrow(x[:, :8].contiguous(), dt)
    assert _vec(x8) > 1
    _sort_checks(x8, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("lanes", ["even", "odd", "one_of_each_pair"])
def test_nan_in_one_lane_of_a_packed_pair(card, dt, lanes):
    """NaN in one coordinate of a packed pair: only that coordinate takes
    the second sort (CWTM trims the NaN, the median is NaN), its neighbour
    keeps its sum."""
    d = 140_001
    x = _x(2, 13, d, 42, card).clamp(-400, 400)
    rng = np.random.default_rng(42)
    cols = np.arange(d)
    pick = {"even": cols[cols % 2 == 0], "odd": cols[cols % 2 == 1],
            "one_of_each_pair": cols[(cols // 2) % 2 == cols % 2]}[lanes]
    pick = pick[rng.random(pick.size) < 0.5]
    # one NaN in each picked coordinate, a second in every third of them
    for part in (pick, pick[pick % 3 == 2]):
        x[:, torch.tensor(rng.integers(13, size=part.size)),
          torch.tensor(part)] = float("nan")
    xs = _narrow(x, dt)
    assert _vec(xs) > 1  # the pairs kernel
    _sort_checks(xs, 3)
    nan_cols = torch.isnan(median_cuda(xs).float()).any(0)
    assert bool(nan_cols[torch.tensor(pick)].all())
    assert not bool(nan_cols[torch.tensor(np.setdiff1d(cols, pick))].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dt,offset", [(torch.bfloat16, 0), (torch.bfloat16, 1),
                                       (torch.float16, 0), (torch.float16, 1),
                                       (torch.float8_e4m3fn, 0),
                                       (torch.float8_e4m3fn, 1),
                                       (torch.float8_e4m3fn, 2),
                                       (torch.float8_e4m3fn, 3)])
def test_narrow_sort_kernels_on_misaligned_rows(card, dt, offset):
    """Rows made misaligned by odd d (1..33, 4,099, 11,958: the
    one-coordinate plan; VEC_D: the vector plan) and by a tensor that
    starts ``offset`` elements (1, 2 or 3 bytes at float8, 2 at 16 bits)
    into its storage: the sorted-weight kernel's narrower loads, and
    pairdist's covering chunks, give what aligned rows give. pairdist is
    held to the float64 distances: at d = 4,099 in bfloat16 the float32
    plain version (cuBLAS) is 0.39 from them on an H100, the kernel
    0.001."""
    from repro_torch.kernels.cwtm.cwtm import load_width, n_pad_of, vec_of
    for d in ODD_D + VEC_D:
        x = _x(2 if d < VEC_D[0] else 1, 13, d, 43 + d, card).clamp(-400,
                                                                    400)
        xs = _narrow(x, dt, offset)
        size = xs.element_size()
        w = load_width(xs.data_ptr() % 16, d, size, vec_of(n_pad_of(13),
                                                           size))
        if offset * size % 2 or d * size % 2:
            assert w == size  # no wider load fits these rows
        assert (_vec(xs) > 1) == (d in VEC_D)
        _sort_checks(xs, 3)
        got = pairdist_cuda(xs)
        _pairdist_ok(got, xs, "float64")
        assert torch.equal(got, pairdist_cuda(xs))
        # the same values aligned: within 1e-5 of max |x|^2 of them
        aligned = pairdist_cuda(_narrow(x, dt))
        assert float((got - aligned).abs().max()) <= 1e-5 * float(
            xs.float().square().sum(-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("b,n,f,d", [(1, 1, 0, 1 << 21), (3, 1, 0, 77),
                                     (1, 13, 3, 300_001), (4, 13, 3, 2049),
                                     (3, 13, 3, 100_003),
                                     (1, 64, 20, 140_001), (3, 64, 20, 999),
                                     (2, 33, 10, 70_001)])
def test_narrow_sort_kernels_at_n_1_13_64_and_batches(card, dt, b, n, f, d):
    """n = 1 (N_PAD 2), 13, 33 and 64 (V = 2 at N_PAD 64), one and several
    batch rows, each on the plan its grid takes (the pairs kernel past
    VEC_MIN_THREADS_PER_SM threads an SM): the sorted-weight kernel gives
    the float32 kernel's bits rounded; pairdist stays within 1e-5 of max
    |x|^2 of the float64 distances and repeats bitwise."""
    xs = _narrow(_x(b, n, d, 44, card).clamp(-400, 400), dt)
    assert (_vec(xs) > 1) == (d > 50_000)
    _sort_checks(xs, f)
    got = pairdist_cuda(xs)
    _pairdist_ok(got, xs, "float64")
    assert torch.equal(got, pairdist_cuda(xs))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("shape", [(1, 13, 11958), (36, 13, 11958),
                                   (1, 13, 1048576), (8, 13, 1048576)])
def test_narrow_pairdist_repeats_bitwise(card, dt, shape):
    """No float atomics: two calls on the same narrow inputs give the same
    bits, with a zero diagonal and a symmetric result."""
    xs = _narrow(_x(*shape, 45, card).clamp(-400, 400), dt)
    first = pairdist_cuda(xs)
    _pairdist_ok(first, xs, "float64")
    assert torch.equal(first, pairdist_cuda(xs))
