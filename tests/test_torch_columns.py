"""The plain versions that run a few columns of an ``[n, D]`` bank at a
time (so that they fit the card at D ~ 1e9): the trimmed mean and the
median, the momentum update on the wire payload, and the dense RoSDHB
round of the LLM train step, each bitwise the whole-bank computation, with
the column widths shrunk so that small banks split into many slices."""

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import (AggregatorConfig, AlgorithmConfig, AttackConfig,
                              SparsifierConfig)
from repro_torch.core import make_aggregator
from repro_torch.kernels.cwtm import ref as CR
from repro_torch.kernels.median.ref import median_ref
from repro_torch.kernels.randk import ref as RR
from repro_torch.testing import ReplayDraws


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", [((8, 1000), 1), ((2, 13, 777), 3)])
def test_sorted_rank_plain_versions_by_columns_are_bitwise(monkeypatch,
                                                           dtype, shape, f):
    """``cwtm_ref`` and ``median_ref`` 64 or 128 columns at a time equal
    the one-sort results bit for bit (slices of a multiple of the CPU's
    vector width, as ``SORT_COLS`` is: the reduction over the kept rows
    then treats every column as the whole bank's does)."""
    x = torch.tensor(np.random.default_rng(0).normal(size=shape),
                     dtype=torch.float32).to(dtype)
    whole = (CR.cwtm_ref(x, f), median_ref(x))
    for cols in (64, 128):
        monkeypatch.setattr(CR, "SORT_COLS", cols)
        for a, b in zip((CR.cwtm_ref(x, f), median_ref(x)), whole):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("bank", ["float32", "bfloat16"])
@pytest.mark.parametrize("local", [False, True])
def test_momentum_plain_version_by_columns_is_bitwise(monkeypatch, bank,
                                                      local):
    """The plain momentum update over 3 blocks at a time (the last slice
    ragged) equals the one-pass update: the bank and, on a bfloat16 bank,
    the float32 result, -0.0 included."""
    n, bs, nb, kb = 4, 16, 20, 7
    rng = np.random.default_rng(1)
    dtype = getattr(torch, bank)
    m0 = torch.tensor(rng.normal(size=(n, nb * bs)),
                      dtype=torch.float32).to(dtype)
    m0[:, ::5] = -0.0
    pay = torch.tensor(rng.normal(size=(n, kb * bs)),
                       dtype=torch.float32).to(dtype)
    ids = (torch.stack([torch.randperm(nb)[:kb] for _ in range(n)])
           if local else torch.randperm(nb)[:kb]).int()
    f32 = dtype == torch.bfloat16
    m_whole = m0.clone()
    out_whole = RR.momentum_scatter_ref(m_whole, pay, ids, bs, 0.9, f32)
    monkeypatch.setattr(RR, "MOMENTUM_COLS", 3 * bs)
    m_cols = m0.clone()
    out_cols = RR.momentum_scatter_ref(m_cols, pay, ids, bs, 0.9, f32)
    assert torch.equal(_bits(m_cols), _bits(m_whole))
    assert torch.equal(_bits(out_cols), _bits(out_whole))
    # the one-pass update is the dense step (the reference's arithmetic)
    wire = RR.block_decompress_ref(pay.float(), ids, bs, nb * bs)
    want = ((m0.float() * 0.9).add_(wire, alpha=0.1) if f32 else
            (wire * 0.1).add_(m0.float(), alpha=0.9))
    assert torch.equal(_bits(out_whole if f32 else m_whole),
                       _bits(want if f32 else want.to(dtype)))


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg_name,attack", [("cwtm", "alie"),
                                             ("median", "signflip")])
def test_dense_round_by_columns_is_bitwise_the_whole_round(monkeypatch, mdt,
                                                           agg_name, attack):
    """The dense RoSDHB round (the train step's plain path: Block-RandK
    without kernels) over slices of 96 columns equals the whole-bank round
    on the same draws: the direction and the momentum bank bit for bit."""
    n, d, bs = 8, 512 * 3, 64
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=n, f=1, beta=0.9, momentum_dtype=mdt,
        sparsifier=SparsifierConfig(kind="block", ratio=0.25, block_size=bs,
                                    use_kernels=False),
        aggregator=AggregatorConfig(name=agg_name, f=1, use_kernels=False),
        attack=AttackConfig(name=attack))
    rng = np.random.default_rng(2)
    wire = getattr(torch, mdt)
    grads = torch.tensor(rng.normal(size=(n, d)),
                         dtype=torch.float32).to(wire)
    m0 = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32).to(wire)
    ids = rng.permutation(d // bs)[:6]
    agg = make_aggregator(cfg.aggregator, device="cpu")
    state = alg.init_state(cfg, d, device="cpu")._replace(momentum=m0)
    assert alg._dense_by_columns(cfg, d)
    runs = []
    for cols in (1 << 24, 96):
        monkeypatch.setattr(alg, "DENSE_COLUMNS", cols)
        s = state._replace(momentum=m0.clone())
        r, new, _ = alg.server_round(cfg, s, grads, ReplayDraws(
            "cpu", permutations=[ids]), agg=agg)
        runs.append((r, new.momentum))
    (r1, m1), (r2, m2) = runs
    assert torch.equal(_bits(r1), _bits(r2))
    assert torch.equal(_bits(m1), _bits(m2))
    assert m2.dtype == wire


def test_dense_round_keeps_the_whole_bank_where_columns_do_not_separate():
    """NNM mixes rows across every column, a stateful attack carries
    memory, local masks with the kernels take the payload round trip: those
    rounds stay whole."""
    base = dict(name="rosdhb", n_workers=8, f=1,
                sparsifier=SparsifierConfig(kind="block", ratio=0.25,
                                            block_size=64, use_kernels=False),
                aggregator=AggregatorConfig(name="cwtm", f=1),
                attack=AttackConfig(name="alie"))
    assert alg._dense_by_columns(AlgorithmConfig(**base), 512)
    for over in (dict(aggregator=AggregatorConfig(name="cwtm", f=1,
                                                  pre_nnm=True)),
                 dict(attack=AttackConfig(name="gauss")),
                 dict(name="dasha"),
                 dict(sparsifier=SparsifierConfig(kind="block", ratio=0.25,
                                                  block_size=64, local=True))):
        assert not alg._dense_by_columns(AlgorithmConfig(**{**base, **over}),
                                         512)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_bank_widened_to_whole_blocks_is_the_dense_round(mdt):
    """At a flat width that is not a whole number of 512-wide blocks (the
    reference then takes its dense round), the train step's bank is widened
    by zero columns to whole blocks so the payload route takes it: the same
    block ids, and on the first D columns the dense round's direction
    (rtol 1e-5) and momentum (bitwise)."""
    n, bs = 8, 512
    d = 512 * 7 + 200
    width = 512 * 8
    base = dict(name="rosdhb", n_workers=n, f=1, beta=0.9,
                momentum_dtype=mdt, attack=AttackConfig(name="alie"))
    sparse = lambda k: SparsifierConfig(kind="block", ratio=0.3,  # noqa
                                        block_size=bs, use_kernels=k)
    kern = AlgorithmConfig(**base, sparsifier=sparse(True),
                           aggregator=AggregatorConfig(name="cwtm", f=1))
    dense = AlgorithmConfig(**base, sparsifier=sparse(False),
                            aggregator=AggregatorConfig(name="cwtm", f=1,
                                                        use_kernels=False))
    assert alg._payload_route(kern, width) and not alg._payload_route(kern, d)
    rng = np.random.default_rng(3)
    wire = getattr(torch, mdt)
    g = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32).to(wire)
    m0 = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32).to(wire)
    ids = rng.permutation(8)[:2]  # ceil(d / 512) = 8 blocks either way
    gw = torch.zeros((n, width), dtype=wire)
    gw[:, :d] = g
    mw = torch.zeros((n, width), dtype=wire)
    mw[:, :d] = m0
    rw, sw, _ = alg.server_round(
        kern, alg.init_state(kern, width, device="cpu")._replace(
            momentum=mw), gw, ReplayDraws("cpu", permutations=[ids]),
        agg=make_aggregator(kern.aggregator, device="cpu"))
    rd, sd, _ = alg.server_round(
        dense, alg.init_state(dense, d, device="cpu")._replace(
            momentum=m0.clone()), g, ReplayDraws("cpu", permutations=[ids]),
        agg=make_aggregator(dense.aggregator, device="cpu"))
    assert torch.equal(_bits(sw.momentum[:, :d].contiguous()),
                       _bits(sd.momentum))
    assert not bool(sw.momentum[:, d:].any()) and not bool(rw[d:].any())
    np.testing.assert_allclose(rw[:d].numpy(), rd.numpy(), rtol=1e-5,
                               atol=1e-5 * float(rd.abs().max()))


def test_train_plans_widen_their_banks_to_whole_blocks():
    """``TrainPlan.bank_width``: the flat width rounded up to whole blocks
    under Block-RandK; the card's families cases use the train paths'
    widths (2-layer deepseek_v2_lite_16b, 2-layer mamba2_1_3b, 6-layer
    zamba2_7b at full width)."""
    import sys
    from pathlib import Path
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.configs.base import ArchSpec
    from repro_torch.launch.steps import make_train_plan
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    layers = {a: n for a, n, _ in chip_smoke.FAMILY_TRAIN}
    for arch, width, dtype in chip_smoke.FAMILY_BANKS:
        spec = get_arch(arch)
        spec = ArchSpec(model=spec.model.with_overrides(
            n_layers=layers[arch]), citation="")
        plan = make_train_plan(spec, INPUT_SHAPES["train_4k"],
                               {"sparsifier": SparsifierConfig(
                                   kind="block", ratio=0.05, block_size=512)})
        assert plan.bank_width == width
        assert 0 <= width - plan.flat_spec.padded_size < 512
        assert width % 512 == 0
    spec = get_arch("stablelm_3b")
    plan = make_train_plan(spec, INPUT_SHAPES["train_4k"])  # block_hash
    assert plan.bank_width == plan.flat_spec.padded_size
