"""RoSDHB's payload round by column slices
(``algorithms._payload_apply`` a window of
``algorithms._payload_window`` blocks at a time: past ``DENSE_COLUMNS`` at
banks narrower than float32, which fits the vlm's train path on one card):
with the slice width shrunk so that small banks split into many windows and
the last one ragged, at bfloat16, float16 and float8_e4m3fn banks, over two
rounds, bitwise the round over one window of the whole bank and the
reference's compiled round (the bank, the direction and the float32
momenta); the round writing into the caller's bank; the windows taken
exactly where they should be; the
windowed plain momentum update (``momentum_scatter_ref(window=...)``)
bitwise the whole-bank one on every window; the dry run's server pieces
counting the sliced round's bytes; the card's widths and launch counts;
and one ``launch.train`` step through the route against the reference's
train step."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro_torch.core import algorithms as Alg
from repro_torch.core import (AggregatorConfig, AlgorithmConfig, AttackConfig,
                              SparsifierConfig, make_aggregator)
from repro_torch.kernels.randk import momentum_scatter_ref
from repro_torch.kernels.randk import ops as RK
from repro_torch.testing import ReplayDraws
from repro_torch.utils.dtypes import to_dtype

N, F, BS, NB, RATIO = 13, 3, 64, 37, 0.25
D = BS * NB
KB = max(1, int(round(RATIO * NB)))
WINDOW = 5  # blocks a slice under the `narrow` fixture: 7 whole, then 2
LOWP = ["bfloat16", "float16", "float8_e4m3fn"]


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def narrow(monkeypatch):
    """Slices of WINDOW blocks of 64 columns: D = 37 blocks is 7 whole
    windows and a ragged eighth of 2 blocks."""
    monkeypatch.setattr(Alg, "DENSE_COLUMNS", WINDOW * BS)


def _cfg(mdt="bfloat16", agg="cwtm", attack="alie", pre_nnm=False, n=N,
         f=F):
    return AlgorithmConfig(
        name="rosdhb", n_workers=n, f=f, gamma=0.05, beta=0.9,
        momentum_dtype=mdt,
        sparsifier=SparsifierConfig(kind="block", ratio=RATIO,
                                    block_size=BS),
        aggregator=AggregatorConfig(name=agg, f=f, pre_nnm=pre_nnm),
        attack=AttackConfig(name=attack))


def _jcfg(mdt):
    return JAlg.AlgorithmConfig(
        name="rosdhb", n_workers=N, f=F, gamma=0.05, beta=0.9,
        momentum_dtype=mdt,
        sparsifier=JC.SparsifierConfig(kind="block", ratio=RATIO,
                                       block_size=BS),
        aggregator=JG.AggregatorConfig(name="cwtm", f=F),
        attack=JA.AttackConfig(name="alie"))


class _Momenta:
    """Records the float32 momenta each ``momentum_update`` call hands
    back (a clone: the sliced round reuses its buffer)."""

    def __init__(self, monkeypatch):
        self.got = []
        real = RK.momentum_update

        def recorded(*a, **k):
            out = real(*a, **k)
            self.got.append(out.clone())
            return out

        monkeypatch.setattr(Alg.RK, "momentum_update", recorded)

    def take(self):
        got, self.got = self.got, []
        return torch.cat(got, dim=1)


def _same_up_to_zero_sign(got: np.ndarray, want: np.ndarray) -> None:
    """Bitwise, NaN where the other is NaN (of either sign), and a zero
    may differ in sign (both must be zero there)."""
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    diff = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    assert not diff.any() or ((got[diff] == 0) & (want[diff] == 0)).all()


def _whole_round(monkeypatch, *args, **kw):
    """``server_round`` with the payload round over one window, the whole
    bank (``DENSE_COLUMNS`` as the port sets it)."""
    with monkeypatch.context() as mp:
        mp.setattr(Alg, "DENSE_COLUMNS", 1 << 24)
        assert Alg._payload_window(args[0], D) == NB
        return Alg.server_round(*args, **kw)


@pytest.mark.parametrize("mdt", LOWP)
def test_sliced_round_is_bitwise_the_whole_round_and_the_reference(
        narrow, monkeypatch, mdt):
    """Two rounds (steps 0 and 1) from a random bank: the sliced round
    (``server_round``, 8 windows, the last of 2 blocks) bitwise the round
    over one window of the whole bank on a copy of the state (the bank,
    the direction and the float32 momenta); and, from the same bank and
    block ids (along the reference's key chain), the reference's compiled
    ``server_round``: the bank and the float32 momenta (its
    ``_rosdhb_apply`` under an identity aggregator, compiled with its
    wire) bitwise on every row, Byzantine rows included, NaN where the
    reference's is (float8 ALIE overflows in 3 values of the second
    round), but at float8 for the sign of a zero momentum (a bank value
    that rounded to -0.0 decays to +0.0 off the selected blocks on the
    payload route, whose wire there is +0.0, and to -0.0 in the
    reference's mask product with a negative gradient, as its own Pallas
    round trip does not). The direction: the reference's CWTM on the
    round's float32 momenta within rtol 1e-5 of max |R| (it sums in
    another order)."""
    cfg, jcfg = _cfg(mdt), _jcfg(mdt)
    assert Alg._payload_window(cfg, D) == WINDOW
    tdt, jdt = Alg.BANK_DTYPES[mdt], jnp.dtype(mdt)
    rng = np.random.default_rng(len(mdt))
    m0 = rng.normal(size=(N, D)).astype(np.float32)
    agg = make_aggregator(cfg.aggregator, device="cpu")
    state = Alg.init_state(cfg, D, device="cpu")._replace(
        momentum=to_dtype(torch.tensor(m0), tdt))
    jagg = JG.make_aggregator(jcfg.aggregator)

    @jax.jit
    def ref(st, g, key):
        _, new, _ = JAlg.server_round(jcfg, st, g, key)
        mask_key, atk_key = jax.random.split(key)
        wire = JAlg._compressed_wire(jcfg, None, g, mask_key, atk_key)[0]
        m32, _ = JAlg._rosdhb_apply(jcfg, lambda m: m, st, wire,
                                    JAlg.static_hparams(jcfg))
        return new.momentum.astype(jnp.float32), m32

    rec = _Momenta(monkeypatch)
    for t in range(2):
        g = rng.normal(size=(N, D)).astype(np.float32)
        key = jax.random.PRNGKey(40 + t)
        ids = np.asarray(jax.random.permutation(jax.random.split(key)[0],
                                                NB)[:KB])
        tg = to_dtype(torch.tensor(g), tdt)
        jst = JAlg.init_state(jcfg, D)._replace(
            momentum=jnp.asarray(state.momentum.float().numpy(), jdt),
            step=jnp.asarray(t, jnp.int32))
        whole = state._replace(momentum=state.momentum.clone())
        r_w, new_w, _ = _whole_round(
            monkeypatch, cfg, whole, tg,
            ReplayDraws("cpu", permutations=[ids]), agg=agg)
        assert len(rec.got) == 1
        m_w = rec.take()
        r_s, new_s, _ = Alg.server_round(
            cfg, state, tg, ReplayDraws("cpu", permutations=[ids]), agg=agg)
        assert len(rec.got) == -(-NB // WINDOW)
        m_s = rec.take()
        _same(new_s.momentum, new_w.momentum)
        _same(r_s, r_w)
        _same(m_s, m_w)
        jmom, jm32 = (np.asarray(a) for a in ref(jst, jnp.asarray(g, jdt),
                                                 key))
        mom, m32 = new_s.momentum.float().numpy(), m_s.numpy()
        if mdt == "float8_e4m3fn":
            _same_up_to_zero_sign(mom, jmom)
            _same_up_to_zero_sign(m32, jm32)
        else:
            np.testing.assert_array_equal(mom.view(np.uint32),
                                          jmom.view(np.uint32))
            np.testing.assert_array_equal(m32.view(np.uint32),
                                          jm32.view(np.uint32))
        assert np.isfinite(mom[F:]).all()
        jr = np.asarray(jax.jit(jagg)(jnp.asarray(m32)))
        np.testing.assert_allclose(r_s.numpy(), jr, rtol=0,
                                   atol=1e-5 * np.abs(jr).max())
        assert new_s.step == t + 1
        state = new_s


@pytest.mark.parametrize("mdt", LOWP)
def test_sliced_round_writes_into_the_callers_bank(narrow, mdt):
    cfg = _cfg(mdt)
    bank = to_dtype(torch.ones(N, D), Alg.BANK_DTYPES[mdt])
    ptr = bank.data_ptr()
    state = Alg.init_state(cfg, D, device="cpu")._replace(momentum=bank)
    r, new, _ = Alg.server_round(
        cfg, state, to_dtype(torch.ones(N, D), bank.dtype),
        ReplayDraws("cpu", permutations=[np.arange(KB)]),
        agg=make_aggregator(cfg.aggregator, device="cpu"))
    assert new.momentum is bank and new.momentum.data_ptr() == ptr
    assert r.shape == (D,) and r.dtype == torch.float32


def _run(cfg, seed=0):
    rng = np.random.default_rng(seed)
    dt = Alg.BANK_DTYPES[cfg.momentum_dtype]
    g = to_dtype(torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32),
                 dt)
    m0 = to_dtype(torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32),
                  dt)
    state = Alg.init_state(cfg, D, device="cpu")._replace(momentum=m0)
    ids = rng.permutation(NB)[:KB]
    return Alg.server_round(cfg, state, g,
                            ReplayDraws("cpu", permutations=[ids]),
                            agg=make_aggregator(cfg.aggregator,
                                                device="cpu"))


@pytest.mark.parametrize("over", [
    {"mdt": "bfloat16"}, {"mdt": "float16", "agg": "median"},
    {"mdt": "float8_e4m3fn", "agg": "mean"},
    {"mdt": "bfloat16", "attack": "signflip"},
    {"mdt": "float16", "attack": "foe", "agg": "median"}])
def test_the_sliced_route_is_taken_where_it_applies(narrow, monkeypatch,
                                                    over):
    """The round runs 8 windows: the momentum update once a window. The
    direction is finite wherever the bank is (float8 ALIE overflows to NaN
    in a few Byzantine values, as the reference's does, and the mean keeps
    them)."""
    cfg = _cfg(**over)
    assert Alg._payload_route(cfg, D)
    assert Alg._payload_window(cfg, D) == WINDOW
    rec = _Momenta(monkeypatch)
    r, new, _ = _run(cfg)
    assert len(rec.got) == -(-NB // WINDOW)
    fin = torch.isfinite(new.momentum.float()).all(0)
    assert bool(torch.isfinite(r[fin]).all()) and new.step == 1
    assert int(fin.sum()) >= D - 3


@pytest.mark.parametrize("over", [
    {"mdt": "float32"}, {"mdt": "bfloat16", "pre_nnm": True},
    {"mdt": "float16", "agg": "krum"}, {"mdt": "bfloat16", "agg": "geomed"},
    {"mdt": "float8_e4m3fn", "pre_nnm": True, "agg": "median"}])
def test_the_whole_bank_round_is_kept_elsewhere(narrow, monkeypatch, over):
    """A float32 bank (its float32 momenta are the bank) and an aggregator
    that is not coordinate-wise take the payload round over one window,
    the whole bank: the momentum update once."""
    cfg = _cfg(**over)
    assert Alg._payload_route(cfg, D) and Alg._payload_window(cfg, D) == NB
    rec = _Momenta(monkeypatch)
    r, new, _ = _run(cfg)
    assert len(rec.got) == 1
    assert new.momentum.shape == (N, D) and new.step == 1


def test_the_route_starts_past_dense_columns():
    """One window up to ``DENSE_COLUMNS`` columns, two past it; a local
    mask and dasha are off the payload route."""
    cfg = _cfg()
    width = Alg.DENSE_COLUMNS
    assert Alg._payload_route(cfg, width)
    assert Alg._payload_window(cfg, width) == width // BS
    assert Alg._payload_window(cfg, width + BS) == width // BS
    assert Alg._payload_window(cfg, width // 2) == width // 2 // BS
    assert not Alg._payload_route(dataclasses.replace(
        cfg, sparsifier=dataclasses.replace(cfg.sparsifier, local=True)),
        width + BS)
    assert not Alg._payload_route(dataclasses.replace(
        cfg, name="dasha"), width + BS)


# ----------------------------------------------------------------------- #
# the windowed plain momentum update
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("mdt", ["float32"] + LOWP)
def test_windowed_plain_update_is_the_whole_bank_one(mdt, local):
    """On every window of 3 blocks (the last of 1), a bank of -0.0 entries
    and values past float8's range among them: the window of the bank
    bitwise the whole-bank update's there and the rest of the bank left as
    it was; the float32 momenta (into a caller's ``out``, also of a wider
    row stride) bitwise the whole-bank result's window."""
    n, bs, nb, kb, beta = 3, 64, 10, 4, 0.9
    dt = Alg.BANK_DTYPES[mdt]
    rng = np.random.default_rng(7)
    m0 = to_dtype(torch.tensor(rng.normal(size=(n, nb * bs)) * 200,
                               dtype=torch.float32), dt)
    m0[:, ::5] = -0.0
    pay = to_dtype(torch.tensor(rng.normal(size=(n, kb * bs)),
                                dtype=torch.float32), dt)
    ids = torch.tensor(np.stack([rng.permutation(nb)[:kb] for _ in range(n)])
                       if local else rng.permutation(nb)[:kb])
    whole = m0.clone()
    res = momentum_scatter_ref(whole, pay, ids, bs, beta,
                               out=torch.empty(n, nb * bs))
    for b0 in range(0, nb, 3):
        b1 = min(nb, b0 + 3)
        cols = slice(b0 * bs, b1 * bs)
        m = m0.clone()
        got = momentum_scatter_ref(
            m, pay, ids, bs, beta, window=(b0, b1),
            **({} if mdt == "float32"
               else {"out": torch.empty(n, (b1 - b0) * bs)}))
        _same(m[:, cols], whole[:, cols])
        rest = torch.ones(nb * bs, dtype=torch.bool)
        rest[cols] = False
        _same(m[:, rest], m0[:, rest])
        if mdt == "float32":
            assert got is m
        else:
            _same(got, res[:, cols])
        wide = torch.full((n, (b1 - b0 + 2) * bs), float("nan"))
        out = wide[:, :(b1 - b0) * bs]
        m = m0.clone()
        assert momentum_scatter_ref(m, pay, ids, bs, beta, window=(b0, b1),
                                    out=out) is out
        _same(out, res[:, cols])
        assert bool(torch.isnan(wide[:, (b1 - b0) * bs:]).all())


def test_plain_update_takes_a_window_in_one_pass(monkeypatch):
    """The plain version runs a window of more than ``MOMENTUM_COLS``
    columns in passes of whole blocks, each bitwise the one-pass window."""
    from repro_torch.kernels.randk import ref as R
    n, bs, nb, kb = 2, 64, 12, 5
    rng = np.random.default_rng(3)
    m0 = to_dtype(torch.tensor(rng.normal(size=(n, nb * bs)),
                               dtype=torch.float32), torch.bfloat16)
    pay = to_dtype(torch.tensor(rng.normal(size=(n, kb * bs)),
                                dtype=torch.float32), torch.bfloat16)
    ids = torch.tensor(rng.permutation(nb)[:kb])
    one, many = m0.clone(), m0.clone()
    want = R.momentum_columns_ref(one, pay, ids, bs, 0.9, 2, 11)
    monkeypatch.setattr(R, "MOMENTUM_COLS", 2 * bs)
    got = R.momentum_scatter_ref(many, pay, ids, bs, 0.9, window=(2, 11),
                                 out=torch.empty(n, 9 * bs))
    _same(got, want)
    _same(many, one)


# ----------------------------------------------------------------------- #
# the dry run, the card's widths and launches
# ----------------------------------------------------------------------- #


def test_the_dry_run_counts_the_sliced_rounds_bytes():
    """The windows partition the bank: their momentum kernels move the
    bank, the payload and the float32 momenta of the whole-bank kernel (the
    dry run's ``momentum`` piece), and their CWTM launches read and write
    what the whole-bank one does (its ``aggregation`` piece). Only the
    block table differs: the windows read the slot map's ``nb`` entries
    where the piece counts the ``kb`` ids."""
    from types import SimpleNamespace

    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as R
    n, bs, nb = 8, 512, 4_182_105
    d = nb * bs
    cfg = dataclasses.replace(_cfg("float8_e4m3fn", n=n, f=1), sparsifier=(
        SparsifierConfig(kind="block", ratio=0.05, block_size=bs)))
    assert Alg._payload_window(cfg, d) == Alg.DENSE_COLUMNS // bs
    plan = SimpleNamespace(algo=cfg, n_workers=n, bank_width=d,
                           flat_spec=SimpleNamespace(size=d - 511))
    pieces = dryrun.server_counts(plan)["pieces"]
    kb = max(1, int(round(0.05 * nb)))
    ids = np.random.default_rng(0).permutation(nb)[:kb]
    step = Alg.DENSE_COLUMNS // bs
    mom, agg = np.zeros(2), np.zeros(2)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        kw = int(((ids >= b0) & (ids < b1)).sum())
        mom += R.momentum_work(n, (b1 - b0) * bs, kw, bs, 1, 1, b1 - b0,
                               True)
        agg += R.sorted_weight_work(1, n, (b1 - b0) * bs, 4)
    whole = R.momentum_work(n, d, kb, bs, 1, 1, kb, True)
    assert pieces["momentum"]["bytes"] == whole[0]
    assert mom[0] - nb * 4 == whole[0] - kb * 4 and mom[1] == whole[1]
    assert tuple(agg) == R.sorted_weight_work(1, n, d, 4)
    assert pieces["aggregation"]["bytes"] == agg[0]


def test_the_cards_train_paths_slice_as_chip_smoke_counts():
    """``chip_smoke.payload_slices``: a window of 32,768 blocks a launch of
    ``momentum_scatter`` and CWTM at the narrow banks of the LLM cut (25),
    deepseek (62), zamba2 (54), gemma_2b (45), the vlm at 5 layers and
    float8 banks (128: its bank of 4,182,105 blocks ends in a window of
    20,569, ``chip_smoke.VLM_WINDOWS``; the same at bfloat16 banks),
    qwen25_3b at 2 layers (47), mistral_large_123b at 1 layer and float8
    banks (131) and dbrx_132b at 1 layer and float8 banks (268: its bank of
    8,773,860 blocks ends in a window of 24,804, ``chip_smoke.DBRX_BANK``);
    one at float32 banks."""
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.configs.base import ArchSpec
    from repro_torch.launch.steps import make_train_plan
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def plan(arch, layers, mdt):
        spec = get_arch(arch)
        spec = ArchSpec(model=spec.model.with_overrides(n_layers=layers),
                        citation="")
        return make_train_plan(spec, INPUT_SHAPES["train_4k"], {
            "momentum_dtype": mdt, "sparsifier": SparsifierConfig(
                kind="block", ratio=0.05, block_size=512)},
            n_workers=8)

    want = {"deepseek_v2_lite_16b": 62, "mamba2_1_3b": 1, "zamba2_7b": 54,
            "gemma_2b": 45, "llama32_vision_11b": 128, "qwen25_3b": 47,
            "mistral_large_123b": 131, "dbrx_132b": 268}
    assert {a for a, _, _ in chip_smoke.FAMILY_TRAIN} == set(want)
    for arch, layers, mdt in chip_smoke.FAMILY_TRAIN:
        assert chip_smoke.payload_slices(plan(arch, layers, mdt)) == \
            want[arch], arch
    for mdt, slices in (("float32", 1), ("bfloat16", 25), ("float16", 25),
                        ("float8_e4m3fn", 25)):
        assert chip_smoke.payload_slices(plan(
            "stablelm_3b", chip_smoke.LLM_LAYERS, mdt)) == slices
    vlm = plan("llama32_vision_11b", 5, "float8_e4m3fn")
    arch, width, mdt = chip_smoke.VLM_BANK
    assert (vlm.bank_width, vlm.algo.momentum_dtype) == (width, mdt)
    nb = width // 512
    assert nb == 4_182_105 and nb - 127 * 32_768 == 20_569
    assert [w[:2] for w in chip_smoke.VLM_WINDOWS] == [
        (0, 32_768), (127 * 32_768, nb)]
    dbrx = plan("dbrx_132b", 1, "float8_e4m3fn")
    arch, width, mdt = chip_smoke.DBRX_BANK
    assert (arch, dbrx.bank_width, dbrx.algo.momentum_dtype) == (
        "dbrx_132b", width, mdt)
    nb = width // 512
    assert nb == 8_773_860 and nb - 267 * 32_768 == 24_804
    assert chip_smoke.MOMENTUM_DBRX_SWEEP[1] == width and \
        chip_smoke.MOMENTUM_DBRX_SWEEP[8] == 32_768
    assert chip_smoke.RANDK_DBRX[:2] == (1, width)
    assert chip_smoke.compressions(dbrx) == 8


# ----------------------------------------------------------------------- #
# launch.train, one layer, through the route
# ----------------------------------------------------------------------- #


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU train steps down ~10x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_step_through_the_route_matches_the_reference(monkeypatch,
                                                            one_thread):
    """Two steps of reduced stablelm_3b at one layer, d_model 128, 8
    workers, f = 1, global Block-RandK at 0.05, ALIE and CWTM, bfloat16
    banks, with the slices shrunk to 2^15 columns so the port's steps take
    the sliced payload round; the reference's train step on the same
    parameters, batches and block ids. The honest loss within rtol 2e-3
    and |R| within 2e-2 (the bounds of ``test_torch_train.py``), and the
    route taken once a step."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ArchSpec as JArchSpec
    from repro.configs.base import InputShape as JInputShape
    from repro.core import AggregatorConfig as JAgg
    from repro.core import AttackConfig as JAtk
    from repro.core import SparsifierConfig as JSp
    from repro.launch import steps as JS
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as JT
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchSpec, InputShape
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.testing import from_jax_params

    n, seq, steps = 8, 32, 2

    def ov(sp, agg, atk):
        return {"name": "rosdhb", "f": 1, "gamma": 0.5,
                "momentum_dtype": "bfloat16",
                "sparsifier": sp(kind="block", ratio=0.05, block_size=512),
                "aggregator": agg(name="cwtm", f=1),
                "attack": atk(name="alie")}

    jmodel = jax_get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=128).with_overrides(vocab_size=512,
                                                use_flash_attention=False)
    shape = ("host_train", seq, n, "train")
    mesh = make_host_mesh()
    jplan = JS.make_train_plan(JArchSpec(jmodel, "t"), JInputShape(*shape),
                               mesh, ov(JSp, JAgg, JAtk), n_workers=n)
    jstep = jax.jit(JS.build_train_step(jplan, mesh))
    d = jplan.flat_spec.padded_size
    params = JT.model_init(jax.random.PRNGKey(0), jplan.model)
    p0 = jax.tree.map(np.asarray, params)
    key = jax.random.PRNGKey(1)
    jstate = JS.TrainState(params, JAlg.init_state(jplan.algo, d),
                           jnp.zeros((), jnp.int32), key)
    rng = np.random.default_rng(0)
    batches = [TR.make_batch(rng, jmodel.vocab_size, n, 1, seq)
               for _ in range(steps)]
    nb = -(-d // 512)
    kb = max(1, int(round(0.05 * nb)))
    ids, ref = [], {"loss": [], "dir_norm": []}
    for b in batches:
        key, round_key = jax.random.split(key)
        mask_key, _ = jax.random.split(round_key)
        ids.append(np.asarray(jax.random.permutation(mask_key, nb)[:kb]))
        with mesh:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        ref["loss"].append(float(m["loss"]))
        ref["dir_norm"].append(float(m["dir_norm"]))

    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 1 << 15)
    taken = []
    sliced = Alg._payload_apply
    monkeypatch.setattr(Alg, "_payload_apply",
                        lambda *a, **k: taken.append(1) or sliced(*a, **k))
    model = get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=128).with_overrides(vocab_size=512)
    plan = S.make_train_plan(ArchSpec(model, "t"), InputShape(*shape),
                             ov(SparsifierConfig, AggregatorConfig,
                                AttackConfig), n_workers=n)
    assert plan.bank_width > (1 << 15)
    assert Alg._payload_window(plan.algo, plan.bank_width) == 64
    step = S.build_train_step(plan, device="cpu")
    state = S.TrainState(from_jax_params(p0),
                         Alg.init_state(plan.algo, plan.bank_width,
                                        device="cpu"), 0,
                         ReplayDraws("cpu", permutations=ids))
    port = {"loss": [], "dir_norm": []}
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        port["loss"].append(float(m["loss"]))
        port["dir_norm"].append(float(m["dir_norm"]))
    assert len(taken) == steps and state.draws.remaining == 0
    assert state.server.momentum.dtype == torch.bfloat16
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)
