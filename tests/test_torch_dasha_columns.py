"""Byz-DASHA-PAGE's round by column slices (``algorithms._dasha_columns``,
the route past ``DENSE_COLUMNS`` that fits the LLM cut on one card):
bitwise the whole round (``_dasha_round``) over several rounds, with the
slice width shrunk so that small banks split into many slices and D not a
multiple of it, at float32, bfloat16 and float8_e4m3fn banks, under ALIE,
FOE and signflip, with CWTM, the median and the mean; the whole round kept
where a step is not coordinate-wise (NNM, Krum, the geometric median,
stateful attacks); the slice masks bitwise slices of the whole mask; the
round writing its new banks over the caller's, bitwise the whole round
and the reference's compiled round; and one ``launch.train --algo dasha``
step through the route against the reference's train step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as Alg
from repro_torch.core import compression as C
from repro_torch.core import (AggregatorConfig, AlgorithmConfig, AttackConfig,
                              SparsifierConfig, make_aggregator)
from repro_torch.testing import ReplayDraws, TorchDraws
from repro_torch.utils.dtypes import to_dtype

N, F, BS = 7, 2, 64


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.element_size() == 2:
        return t.view(torch.int16)
    return t.view(torch.uint8)


def _cfg(mdt="float32", attack="alie", agg="cwtm", kind="block",
         ratio=0.25, pre_nnm=False):
    return AlgorithmConfig(
        name="dasha", n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind=kind, ratio=ratio, block_size=BS),
        aggregator=AggregatorConfig(name=agg, f=F, pre_nnm=pre_nnm),
        attack=AttackConfig(name=attack), momentum_dtype=mdt)


def _grads(t, d, dtype, seed=0):
    g = torch.tensor(np.random.default_rng((seed, t)).normal(size=(N, d)),
                     dtype=torch.float32)
    return to_dtype(g, dtype)


def _rounds(cfg, d, rounds, grad_dtype, whole):
    """``rounds`` rounds of ``cfg`` from zero state: the whole round, or
    ``server_round`` (the sliced route where it applies)."""
    agg = make_aggregator(cfg.aggregator, device="cpu")
    state = Alg.init_state(cfg, d, device="cpu")
    draws = TorchDraws(5, "cpu")
    hp = Alg.static_hparams(cfg)
    out = []
    for t in range(rounds):
        g = _grads(t, d, grad_dtype)
        if whole:
            r, state = Alg._dasha_round(cfg, agg, state, g, draws, hp)
        else:
            r, state, _ = Alg.server_round(cfg, state, g, draws, agg=agg)
        out.append(r)
    return out, state


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def narrow(monkeypatch):
    """Slices of 1,024 columns (16 blocks of 64)."""
    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 1024)


def _check(cfg, d, grad_dtype, rounds=3):
    assert Alg._dasha_by_columns(cfg, d)
    want, ws = _rounds(cfg, d, rounds, grad_dtype, whole=True)
    got, gs = _rounds(cfg, d, rounds, grad_dtype, whole=False)
    for a, b in zip(got, want):
        _same(a, b)
    for a, b in ((gs.momentum, ws.momentum), (gs.mirror, ws.mirror),
                 (gs.prev_grad, ws.prev_grad)):
        _same(a, b)
    assert gs.step == ws.step == rounds


@pytest.mark.parametrize("agg", ["cwtm", "median", "mean"])
@pytest.mark.parametrize("attack", ["alie", "foe", "signflip"])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16", "float8_e4m3fn"])
def test_sliced_round_is_bitwise_the_whole_round(narrow, mdt, attack, agg):
    """D = 5,000 (four whole slices and a ragged fifth, whose last block is
    ragged too); the gradients in the bank dtype, as the train step's wire
    bank is."""
    _check(_cfg(mdt, attack, agg), 5000, Alg.BANK_DTYPES[mdt])


@pytest.mark.parametrize("kind,ratio", [("block", 0.25), ("block_hash", 0.3),
                                        ("randk", 0.1), ("bernoulli", 0.2),
                                        ("block", 1.0)])
def test_sliced_round_takes_every_mask_kind(narrow, kind, ratio):
    """Float32 gradients (the simulator's), the block kinds at a
    block-aligned D (the whole round takes the Block-RandK round trip
    there) and at a ragged one."""
    for d in (4992, 5000):
        _check(_cfg(kind=kind, ratio=ratio), d, torch.float32, rounds=2)


@pytest.mark.parametrize("kind,ratio", [("block", 0.25), ("block_hash", 0.3),
                                        ("randk", 0.1), ("bernoulli", 0.2),
                                        ("natural", 1.0), ("none", 1.0)])
def test_slice_masks_are_slices_of_the_whole_mask(kind, ratio):
    sp = SparsifierConfig(kind=kind, ratio=ratio, block_size=BS, local=True)
    d = 5000
    raw = C.mask_draw(TorchDraws(3, "cpu"), d, sp, local_workers=N)
    for dtype in (torch.float32, torch.float8_e4m3fn):
        whole = C.mask_from_draw(raw, d, sp, dtype, device="cpu")
        for lo, hi in ((0, 1024), (1024, 3072), (4096, 5000), (4992, 5000)):
            part = C.mask_columns(raw, d, sp, lo, hi, dtype, device="cpu")
            _same(part, whole[..., lo:hi])
    if kind in ("block", "block_hash"):
        with pytest.raises(ValueError, match="block"):
            C.mask_columns(raw, d, sp, 100, 1100)


@pytest.mark.parametrize("change", [
    {"pre_nnm": True}, {"agg": "krum"}, {"agg": "geomed"},
    {"attack": "mimic"}, {"attack": "gauss"}, {"attack": "spectral"}])
def test_the_whole_round_is_kept_where_a_step_is_not_coordinatewise(
        narrow, monkeypatch, change):
    cfg = _cfg(**change)
    assert not Alg._dasha_by_columns(cfg, 5000)
    monkeypatch.setattr(Alg, "_dasha_columns", None)  # would raise if taken
    got, _ = _rounds(cfg, 5000, 2, torch.float32, whole=False)
    want, _ = _rounds(cfg, 5000, 2, torch.float32, whole=True)
    for a, b in zip(got, want):
        _same(a, b)


def test_the_route_starts_past_dense_columns():
    cfg = _cfg()
    assert not Alg._dasha_by_columns(cfg, Alg.DENSE_COLUMNS)
    assert Alg._dasha_by_columns(cfg, Alg.DENSE_COLUMNS + 1)
    assert not Alg._dasha_by_columns(dataclasses.replace(cfg, name="rosdhb"),
                                     Alg.DENSE_COLUMNS + 1)


def test_float32_gradients_become_prev_grad_without_a_copy(narrow):
    """The float32 gradient bank becomes prev_grad itself; the new momentum
    and mirror are written over the caller's banks (the round consumes its
    state)."""
    cfg = _cfg()
    state = Alg.init_state(cfg, 5000, device="cpu")
    g = _grads(0, 5000, torch.float32)
    agg = make_aggregator(cfg.aggregator, device="cpu")
    _, new, _ = Alg.server_round(cfg, state, g, TorchDraws(1, "cpu"),
                                 agg=agg)
    assert new.prev_grad is g
    assert new.momentum.data_ptr() == state.momentum.data_ptr()
    assert new.mirror.data_ptr() == state.mirror.data_ptr()


def _state(cfg, d, seed, step):
    """A state with random momentum, mirror (in the bank dtype) and float32
    previous gradients at ``step``."""
    rng = np.random.default_rng(seed)
    bank = Alg.BANK_DTYPES[cfg.momentum_dtype]
    f = lambda: torch.tensor(rng.normal(size=(N, d)),  # noqa: E731
                             dtype=torch.float32)
    return Alg.init_state(cfg, d, device="cpu")._replace(
        momentum=to_dtype(f(), bank), mirror=to_dtype(f(), bank),
        prev_grad=f(), step=step)


def _copy(state):
    return state._replace(momentum=state.momentum.clone(),
                          mirror=state.mirror.clone(),
                          prev_grad=state.prev_grad.clone())


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_sliced_round_writes_into_the_callers_banks(narrow, mdt, step):
    """The sliced round consumes the caller's banks: the new momentum and
    mirror are the old tensors, written slice by slice after each slice's
    reads; prev_grad is the float32 gradient bank itself (float32 banks) or
    the old prev_grad written over (bfloat16 banks, whose gradients are
    bfloat16). Each value is bitwise the whole round's, run on its own copy
    of the same state."""
    cfg = _cfg(mdt)
    d = 5000
    agg = make_aggregator(cfg.aggregator, device="cpu")
    state = _state(cfg, d, 11 + step, step)
    whole = _copy(state)
    ptrs = {k: getattr(state, k).data_ptr()
            for k in ("momentum", "mirror", "prev_grad")}
    g = _grads(step, d, Alg.BANK_DTYPES[mdt])
    r, new, _ = Alg.server_round(cfg, state, g, TorchDraws(1, "cpu"),
                                 agg=agg)
    want_r, want = Alg._dasha_round(cfg, agg, whole, g, TorchDraws(1, "cpu"),
                                    Alg.static_hparams(cfg))
    assert new.momentum.data_ptr() == ptrs["momentum"]
    assert new.mirror.data_ptr() == ptrs["mirror"]
    if mdt == "float32":
        assert new.prev_grad is g
    else:
        assert new.prev_grad.data_ptr() == ptrs["prev_grad"]
    _same(r, want_r)
    for a, b in ((new.momentum, want.momentum), (new.mirror, want.mirror),
                 (new.prev_grad, want.prev_grad)):
        _same(a, b)
    assert new.step == want.step == step + 1


@pytest.mark.parametrize("step", [0, 1])
def test_sliced_round_in_place_matches_the_reference(narrow, step):
    """The sliced round, writing over its state, against the reference's
    compiled round from the same momentum, mirror, previous gradients and
    per-worker RandK draws (three slices, the last ragged), held as
    ``test_torch_dasha.py::test_one_round`` holds the whole round: the
    momentum, the previous gradients and the honest mirror rows bitwise,
    the Byzantine mirror rows within 1 ulp of their largest value (the
    compiled reference fuses ALIE's statistics), the direction within 4
    ulp (CWTM sums in another order)."""
    from repro.core import aggregators as JG
    from repro.core import algorithms as JAlg
    from repro.core import attacks as JA
    from repro.core import compression as JC
    from repro_torch.testing import ReplayDraws
    d = 2500
    ref = JAlg.AlgorithmConfig(
        name="dasha", n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=JG.AggregatorConfig(name="cwtm", f=F),
        attack=JA.AttackConfig(name="alie"))
    cfg = _cfg(kind="randk", ratio=0.1)
    assert Alg._dasha_by_columns(cfg, d)
    state = _state(cfg, d, 21 + step, step)
    m, h, pg = (getattr(state, k).numpy().copy()
                for k in ("momentum", "mirror", "prev_grad"))
    g = np.random.default_rng(31 + step).normal(size=(N, d)).astype(
        np.float32)
    key = jax.random.PRNGKey(5 + step)
    mask_key = jax.random.split(key)[0]
    k = cfg.sparsifier.k(d)
    perms = [np.asarray(jax.random.permutation(kk, d)[:k])
             for kk in jax.random.split(mask_key, N)]
    st = JAlg.init_state(ref, d)._replace(
        momentum=jnp.asarray(m), mirror=jnp.asarray(h),
        prev_grad=jnp.asarray(pg), step=jnp.asarray(step, jnp.int32))
    jr, jnew, _ = jax.jit(lambda st, g, key: JAlg.server_round(
        ref, st, g, key))(st, jnp.asarray(g), key)
    draws = ReplayDraws("cpu", permutations=perms)
    agg = make_aggregator(cfg.aggregator, device="cpu")
    ptr = state.momentum.data_ptr()
    r, new, _ = Alg.server_round(cfg, state, torch.tensor(g), draws, agg=agg)
    assert draws.remaining == 0 and new.momentum.data_ptr() == ptr
    np.testing.assert_array_equal(new.momentum.numpy(),
                                  np.asarray(jnew.momentum))
    np.testing.assert_array_equal(new.prev_grad.numpy(),
                                  np.asarray(jnew.prev_grad))
    mir, tmir = np.asarray(jnew.mirror), new.mirror.numpy()
    np.testing.assert_array_equal(tmir[F:], mir[F:])
    np.testing.assert_allclose(tmir[:F], mir[:F], rtol=0,
                               atol=np.spacing(np.abs(mir[:F]).max()))
    jr = np.asarray(jr)
    np.testing.assert_allclose(r.numpy(), jr, rtol=0,
                               atol=4 * np.spacing(np.abs(jr).max()))


# ----------------------------------------------------------------------- #
# launch.train --algo dasha, one layer, through the route
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
    workers, f = 1, per-worker Block-RandK at 0.05 and CWTM, float32 banks,
    with the slices shrunk to 2^15 columns so the port's steps take the
    sliced route; the
    reference's train step on the same parameters, batches and block ids.
    The honest loss within rtol 2e-3 and |R| within 2e-2 (the bounds of
    ``test_torch_train.py``: bf16 gradients rounded at other places), and
    the route taken once a step."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ArchSpec as JArchSpec
    from repro.configs.base import InputShape as JInputShape
    from repro.core import AggregatorConfig as JAgg
    from repro.core import AttackConfig as JAtk
    from repro.core import SparsifierConfig as JSp
    from repro.core import algorithms as JAlg
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
        return {"name": "dasha", "f": 1, "gamma": 0.5,
                "momentum_dtype": "float32",
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
        ids += [np.asarray(jax.random.permutation(k, nb)[:kb])
                for k in jax.random.split(mask_key, n)]
        with mesh:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        ref["loss"].append(float(m["loss"]))
        ref["dir_norm"].append(float(m["dir_norm"]))

    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 1 << 15)
    taken = []
    sliced = Alg._dasha_columns
    monkeypatch.setattr(Alg, "_dasha_columns",
                        lambda *a, **k: taken.append(1) or sliced(*a, **k))
    model = get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=128).with_overrides(vocab_size=512)
    plan = S.make_train_plan(ArchSpec(model, "t"), InputShape(*shape),
                             ov(SparsifierConfig, AggregatorConfig,
                                AttackConfig), n_workers=n)
    assert plan.flat_spec.padded_size == d and plan.bank_width > (1 << 15)
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
    assert state.server.prev_grad.dtype == torch.float32
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)


def test_the_launcher_lets_the_initial_state_go(monkeypatch, one_thread):
    """``launch.train.run`` holds no reference to its setup's initial
    state: a dasha step allocates its banks anew, so a launcher that kept
    the first state alive held a third set of banks from the second step
    on (at the LLM cut on the card that ran out of memory)."""
    import weakref

    from repro_torch.launch import train as TR

    real, alive = TR.setup, []

    def setup(args, plain=False, dtype=None):
        s = real(args, plain=plain, dtype=dtype)
        first = weakref.ref(s["state"].server.momentum)
        step = s["step"]

        def watched(state, batch):
            alive.append(first() is not None)
            return step(state, batch)

        s["step"] = watched
        return s

    monkeypatch.setattr(TR, "setup", setup)
    TR.run(["--arch", "stablelm_3b", "--steps", "3", "--n-layers", "1",
            "--f", "1", "--algo", "dasha", "--device", "cpu"],
           log=lambda *a: None)
    assert alive == [True, False, False]
