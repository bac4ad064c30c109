"""The streamed train step (``launch.steps.build_train_step`` where
``algorithms.streams_payload``): the round's block ids drawn first, each
worker's gradient raveled into one row and compressed at once into its
payload row, the round run on the payload (``algorithms.payload_round``),
the update applied in place. Held bitwise to the bank round it replaces
(every worker's row in a hand-built ``[n, D]`` bank, ``server_round``, the
update as a new tree) over three steps at every bank dtype, windows of the
payload round included; no ``[n, D]`` tensor and no second float32 set of
parameters allocated during a step; the plain route (``use_kernels``
off) bitwise the kernel-free dense round; the configurations off the
route still taking the bank."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.core import AggregatorConfig, AttackConfig, SparsifierConfig
from repro_torch.core import algorithms as Alg
from repro_torch.core import compression as C
from repro_torch.core import make_aggregator
from repro_torch.launch import steps as S
from repro_torch.launch.train import make_batch
from repro_torch.models import lm_loss, model_init
from repro_torch.testing import ReplayDraws
from repro_torch.utils import tree as T
from repro_torch.utils.dtypes import to_dtype, vector_norm

N, F, SEQ, BS, RATIO, STEPS = 5, 1, 32, 64, 0.25, 3
BANKS = ["float32", "bfloat16", "float16", "float8_e4m3fn"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plan(mdt, kernels=True, **over):
    model = get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=64).with_overrides(vocab_size=128)
    ov = {"f": F, "gamma": 0.5, "momentum_dtype": mdt,
          "sparsifier": SparsifierConfig(kind="block", ratio=RATIO,
                                         block_size=BS, use_kernels=kernels),
          "aggregator": AggregatorConfig(name="cwtm", f=F,
                                         use_kernels=kernels),
          "attack": AttackConfig(name="alie")}
    ov.update(over)
    return S.make_train_plan(ArchSpec(model, "t"),
                             InputShape("t", SEQ, N, "train"), ov,
                             n_workers=N)


def _ids(plan, steps=STEPS):
    nb = plan.bank_width // BS
    kb = max(1, int(round(RATIO * nb)))
    rng = np.random.default_rng(11)
    return [rng.permutation(nb)[:kb] for _ in range(steps)]


def _state(plan, ids):
    params = model_init(plan.model, torch.Generator().manual_seed(0),
                        device="cpu")
    server = Alg.init_state(plan.algo, plan.bank_width, device="cpu")
    # a bank of values, not zeros, so that the decay shows
    rng = np.random.default_rng(3)
    m0 = torch.tensor(rng.normal(size=tuple(server.momentum.shape)),
                      dtype=torch.float32)
    server = server._replace(momentum=to_dtype(m0, server.momentum.dtype))
    return S.TrainState(params, server, 0, ReplayDraws("cpu",
                                                       permutations=ids))


def _batches(plan, steps=STEPS):
    rng = np.random.default_rng(0)
    return [{"tokens": torch.from_numpy(make_batch(
        rng, plan.model.vocab_size, N, 1, SEQ))} for _ in range(steps)]


def _bank_step(plan, state, batch, dense=False):
    """The step as it was before the stream: every worker's bf16 gradient
    raveled into its row of an ``[n, D]`` bank, the round on the bank
    (``server_round``, or with ``dense`` the kernel-free dense round:
    the mask product, the attack on the dense wire and the dense
    momentum), the update into a new tree."""
    algo, fspec = plan.algo, plan.flat_spec
    half = [(p.to(torch.bfloat16) if p.dtype == torch.float32 else p)
            .detach().requires_grad_() for p in T.tree_leaves(state.params)]
    tree = T.tree_unflatten(fspec.treedef, half)
    bank = torch.empty((N, plan.bank_width),
                       dtype=Alg.BANK_DTYPES[algo.momentum_dtype])
    losses = []
    for w in range(N):
        loss = lm_loss(tree, plan.model, {k: v[w] for k, v in batch.items()})
        T.tree_ravel_into(list(torch.autograd.grad(loss, half)), bank[w],
                          fspec)
        losses.append(loss.detach())
    agg = make_aggregator(algo.aggregator, device="cpu")
    if dense:
        assert not C._kernel_eligible(algo.sparsifier, plan.bank_width)
        wire = Alg._compressed_wire(algo, bank, state.draws)
        r, server = Alg._rosdhb_apply(algo, agg, state.server, wire,
                                      Alg.static_hparams(algo))
    else:
        r, server, _ = Alg.server_round(algo, state.server, bank,
                                        state.draws, agg=agg)
    params = T.tree_unflatten(fspec.treedef, [
        torch.add(p, d.to(p.dtype), alpha=-algo.gamma) for p, d in
        zip(T.tree_leaves(state.params),
            T.tree_leaves(T.tree_unravel(r, fspec)))])
    return (S.TrainState(params, server, state.step + 1, state.draws),
            {"loss": torch.stack(losses)[algo.f:].mean(),
             "dir_norm": vector_norm(r)})


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def _same(a, b, zero_sign=False):
    """Bitwise; with ``zero_sign`` a zero may differ in sign (both zero)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    diff = _bits(a) != _bits(b)
    if zero_sign:
        nan = torch.isnan(a.float())
        assert torch.equal(nan, torch.isnan(b.float()))
        diff &= ~nan
        assert bool(((a.float()[diff] == 0) & (b.float()[diff] == 0)).all())
    else:
        assert not bool(diff.any())


def _run(plan, step_fn, steps=STEPS):
    state = _state(plan, _ids(plan, steps))
    out = []
    for b in _batches(plan, steps):
        state, m = step_fn(state, b)
        out.append((float(m["loss"]), float(m["dir_norm"])))
    return state, out


@pytest.mark.parametrize("mdt", BANKS)
def test_streamed_step_is_bitwise_the_bank_round(monkeypatch, mdt):
    """Three steps of the streamed step against three of the bank round
    from the same parameters, momentum, batches and block ids: the
    parameters, the momentum bank, the honest loss and |R| bit for bit, and
    every draw consumed. Windows of 100 blocks (the payload round's
    windows at banks narrower than float32: 11 whole and a ragged last)."""
    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 100 * BS)
    plan = _plan(mdt)
    assert Alg.streams_payload(plan.algo, plan.bank_width)
    nb = plan.bank_width // BS
    assert Alg._payload_window(plan.algo, plan.bank_width) == (
        nb if mdt == "float32" else 100) and nb % 100
    got, got_m = _run(plan, S.build_train_step(plan, device="cpu"))
    want, want_m = _run(plan, lambda s, b: _bank_step(plan, s, b))
    assert got_m == want_m
    for a, b in zip(T.tree_leaves(got.params), T.tree_leaves(want.params)):
        _same(a, b)
    _same(got.server.momentum, want.server.momentum)
    assert got.server.momentum.dtype == Alg.BANK_DTYPES[mdt]
    assert got.step == want.step == STEPS
    assert got.draws.remaining == want.draws.remaining == 0
    # the update moved the parameters (the comparison is not of two copies
    # of the initial state)
    p0 = model_init(plan.model, torch.Generator().manual_seed(0),
                    device="cpu")
    assert any(not torch.equal(a, b) for a, b in
               zip(T.tree_leaves(got.params), T.tree_leaves(p0)))


class _Allocations(TorchDispatchMode):
    """The output tensors of every operation that is not a view (a view
    allocates nothing): shape, dtype and data pointer."""

    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.outs.append((tuple(t.shape), t.dtype, t.data_ptr()))
        return out


@pytest.mark.parametrize("mdt", ["bfloat16", "float16", "float8_e4m3fn"])
def test_streamed_step_allocates_no_bank_and_no_second_tree(monkeypatch,
                                                            mdt):
    """Under a dispatch mode that sees every tensor an operation makes,
    during a streamed step whose round runs windows of 100 blocks (as at an
    LLM's D, where a window is ``DENSE_COLUMNS`` wide): no ``[n,
    bank_width]`` tensor but the momentum bank, updated in place; no
    float32 tensor the shape of a parameter leaf (of 256 values or more)
    but the parameters themselves, updated in place (their data pointers
    unchanged); one ``[bank_width]`` row at a time and the ``[n, kb *
    block_size]`` payload."""
    monkeypatch.setattr(Alg, "DENSE_COLUMNS", 100 * BS)
    plan = _plan(mdt)
    state = _state(plan, _ids(plan, 1))
    step = S.build_train_step(plan, device="cpu")
    leaves = T.tree_leaves(state.params)
    ptrs = {p.data_ptr() for p in leaves}
    shapes = {tuple(p.shape) for p in leaves if p.numel() >= 256}
    bank = state.server.momentum.data_ptr()
    with _Allocations() as rec:
        new, _ = step(state, _batches(plan, 1)[0])
    n, d = plan.n_workers, plan.bank_width
    made = {o[0] for o in rec.outs}
    assert not [o for o in rec.outs if o[0] == (n, d) and o[2] != bank]
    assert (n, C.payload_width(d, plan.algo.sparsifier)) in made
    assert (d,) in made  # one raveled row at a time
    second = [o for o in rec.outs if o[1] == torch.float32
              and o[0] in shapes and o[2] not in ptrs]
    assert not second, second[:3]
    assert [p.data_ptr() for p in T.tree_leaves(new.params)] == \
        [p.data_ptr() for p in leaves]
    assert new.server.momentum.data_ptr() == bank


@pytest.mark.parametrize("mdt", BANKS)
def test_plain_route_is_bitwise_the_dense_round(mdt):
    """``use_kernels`` off (the card's comparison path): the step still
    streams, on the kernels' plain versions, and its three steps equal the
    kernel-free dense round's (the mask product, the attack on the dense
    wire, the dense momentum) bit for bit; at float8 but for the sign of a
    zero momentum (a bank value that rounded to -0.0 decays to +0.0 off the
    selected blocks on the payload route, whose wire there is +0.0, and to
    -0.0 in the dense mask product with a negative gradient:
    ``test_torch_payload_columns.py``)."""
    plan = _plan(mdt, kernels=False)
    assert Alg.streams_payload(plan.algo, plan.bank_width)
    got, got_m = _run(plan, S.build_train_step(plan, device="cpu"))
    want, want_m = _run(plan, lambda s, b: _bank_step(plan, s, b,
                                                      dense=True))
    f8 = mdt == "float8_e4m3fn"
    assert got_m == want_m
    for a, b in zip(T.tree_leaves(got.params), T.tree_leaves(want.params)):
        _same(a, b)
    _same(got.server.momentum, want.server.momentum, zero_sign=f8)
    assert got.draws.remaining == want.draws.remaining == 0


@pytest.mark.parametrize("over", [
    {"sparsifier": SparsifierConfig(kind="block", ratio=RATIO,
                                    block_size=BS, local=True)},
    {"clip_norm": 1.0},
    {"attack": AttackConfig(name="gauss")},
    {"server_compute_dtype": "bfloat16"},
    {"name": "dasha"}])
def test_off_route_configs_take_the_bank(over):
    """Local masks, a per-worker clip, an attack that does not keep zero
    columns zero, a compute dtype narrower than float32, dasha: no stream;
    the step builds the ``[n, D]`` bank and runs ``server_round`` on it."""
    plan = _plan("bfloat16", **over)
    assert not Alg.streams_payload(plan.algo, plan.bank_width)
    nb = plan.bank_width // BS
    kb = max(1, int(round(RATIO * nb)))
    rng = np.random.default_rng(5)
    local = plan.algo.sparsifier.local or plan.algo.name == "dasha"
    ids = [rng.permutation(nb)[:kb] for _ in range(N if local else 1)]
    state = S.TrainState(
        model_init(plan.model, torch.Generator().manual_seed(0),
                   device="cpu"),
        Alg.init_state(plan.algo, plan.bank_width, device="cpu"), 0,
        ReplayDraws("cpu", permutations=ids,
                    normals=[rng.normal(size=(F, plan.bank_width))]))
    with _Allocations() as rec:
        new, m = S.build_train_step(plan, device="cpu")(
            state, _batches(plan, 1)[0])
    assert (N, plan.bank_width) in {o[0] for o in rec.outs}
    assert np.isfinite(float(m["loss"])) and new.step == 1


def test_payload_round_refuses_what_does_not_stream():
    plan = _plan("bfloat16", clip_norm=1.0)
    d = plan.bank_width
    pay = torch.zeros((N, C.payload_width(d, plan.algo.sparsifier)),
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="server_round"):
        Alg.payload_round(plan.algo, Alg.init_state(plan.algo, d,
                                                    device="cpu"),
                          pay, torch.arange(pay.shape[1] // BS), d, None)
    plan = _plan("bfloat16")
    with pytest.raises(ValueError, match="payload"):
        Alg.payload_round(plan.algo, Alg.init_state(plan.algo, d,
                                                    device="cpu"),
                          pay[:, :BS], torch.arange(1), d, None)
