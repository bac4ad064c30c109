"""The LLM train step of the port against the reference's
``build_train_step`` (host mesh, naive flatten): reduced ``stablelm_3b``,
n = 8 workers, global Block-RandK at 0.05 with 512-wide blocks (the
reference on its Pallas round trip in interpret mode), ALIE, CWTM with
f = 1, float32 momentum, three steps from the same parameters, batches and
block ids. The reference's attention runs its plain XLA path: its gradient
through the Pallas flash kernel fails."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.core import AggregatorConfig, AttackConfig, SparsifierConfig
from repro_torch.core import algorithms as Alg
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import moe as MOE
from repro_torch.testing import ReplayDraws, from_jax_params
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, SEQ, STEPS, GAMMA = 8, 128, 3, 0.5


def _overrides(sp, agg, atk):
    return {"name": "rosdhb", "f": 1, "gamma": GAMMA,
            "momentum_dtype": "float32",
            "sparsifier": sp(kind="block", ratio=0.05, block_size=512),
            "aggregator": agg(name="cwtm", f=1),
            "attack": atk(name="alie")}


def _run_both(jov, ov, steps=STEPS, use_pallas=True, n_layers=2,
              arch="stablelm_3b", routes=None, **model_over):
    """``steps`` steps of the reference (compiled once) and of the port,
    from the same parameters, batches and block ids; ``jov`` and ``ov``
    are the two packages' plan overrides, ``model_over`` both models'
    (``arch`` reduced to ``n_layers`` at d_model 256); ``routes``: a
    ``models.moe.RouteLog`` the port's steps route through."""
    jmodel = jax_get_arch(arch).model.reduced(
        n_layers=n_layers, d_model=256).with_overrides(
            vocab_size=512, use_flash_attention=False, **model_over)
    shape = ("host_train", SEQ, N, "train")
    mesh = make_host_mesh()
    jov = dict(jov)
    jov["sparsifier"] = JSp(kind="block", ratio=0.05, block_size=512,
                            local=jov["sparsifier"].local,
                            use_pallas=use_pallas)
    jplan = JS.make_train_plan(JArchSpec(jmodel, "test"), JInputShape(*shape),
                               mesh, jov, n_workers=N)
    jstep = jax.jit(JS.build_train_step(jplan, mesh))
    d = jplan.flat_spec.padded_size
    params = JT.model_init(jax.random.PRNGKey(0), jplan.model)
    p0 = jax.tree.map(np.asarray, params)
    key = jax.random.PRNGKey(1)
    jstate = JS.TrainState(params, JAlg.init_state(jplan.algo, d),
                           jnp.zeros((), jnp.int32), key)
    rng = np.random.default_rng(0)
    # the launcher's batches: tokens (the same draws as make_batch's), and
    # the vlm's image embeddings after them
    batches = [TR.make_model_batch(rng, jmodel, N, 1, SEQ)
               for _ in range(steps)]
    # the block ids along the reference's key chain: steps.py:131 splits
    # (key, round_key), algorithms.py:819 (mask_key, atk_key),
    # compression.py:275 permutes the block ids (local masks and dasha:
    # compression.py:175 splits the mask key per worker first)
    nb = -(-d // 512)  # whole blocks (compression.py:87)
    kb = max(1, int(round(0.05 * nb)))
    local = jplan.algo.sparsifier.local or jplan.algo.name == "dasha"
    ids = []
    ref = {"loss": [], "dir_norm": [], "payload": []}
    for b in batches:
        key, round_key = jax.random.split(key)
        mask_key, _ = jax.random.split(round_key)
        keys = jax.random.split(mask_key, N) if local else [mask_key]
        ids += [np.asarray(jax.random.permutation(k, nb)[:kb]) for k in keys]
        with mesh:
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        ref["loss"].append(float(m["loss"]))
        ref["dir_norm"].append(float(m["dir_norm"]))
        ref["payload"].append(float(m["payload_floats_per_worker"]))
    ref["params"] = [np.asarray(a) for a in
                     jax.tree_util.tree_leaves(jstate.params)]
    ref["momentum"] = np.asarray(jstate.server.momentum.astype(jnp.float32))

    ref["plan"] = jplan
    ref["p0_tree"] = p0
    ref["batches"] = batches
    ref["p0"] = jax.tree_util.tree_leaves(p0)
    ref["ids"] = ids
    model = get_arch(arch).model.reduced(
        n_layers=n_layers, d_model=256).with_overrides(vocab_size=512,
                                                       **model_over)
    return ref, _run_port(ref, model, ov, shape, routes)


def _run_port(ref, model, ov, shape, routes=None):
    """The port's steps of :func:`_run_both` from the reference's initial
    parameters, batches and block ids (through ``routes`` where given)."""
    plan = S.make_train_plan(ArchSpec(model, "test"), InputShape(*shape), ov,
                             n_workers=N)
    step = S.build_train_step(plan, device="cpu")
    state = S.TrainState(from_jax_params(ref["p0_tree"]),
                         Alg.init_state(plan.algo, plan.bank_width,
                                        device="cpu"), 0,
                         ReplayDraws("cpu", permutations=ref["ids"]))
    port = {"loss": [], "dir_norm": [], "payload": []}
    with (MOE.routes(routes) if routes is not None
          else contextlib.nullcontext()):
        for b in ref["batches"]:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            port["loss"].append(float(m["loss"]))
            port["dir_norm"].append(float(m["dir_norm"]))
            port["payload"].append(m["payload_floats_per_worker"])
    port["params"] = [t.numpy() for t in tree_leaves(state.params)]
    port["momentum"] = state.server.momentum.float().numpy()
    port["state"] = state
    port["draws_left"] = state.draws.remaining
    port["plan"] = plan
    port["shape"] = shape
    return port


def _reference_routes(monkeypatch):
    """The reference's MoE choices, as its compiled steps make them: every
    ``jax.lax.top_k`` the steps trace hands its indices to this list
    through a debug callback (under the step's ``vmap`` one call a worker,
    in no fixed order, and the rematerialised forward of the backward
    again)."""
    calls, real = [], jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), idx)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return calls


def _replay_of(ref_calls, port_calls, steps):
    """For each of the port's MoE calls (a worker's, in step and worker
    order), the reference's call of the same step that routes its tokens
    most alike, and the number of tokens whose experts differ."""
    per_ref, per_port = len(ref_calls) // steps, len(port_calls) // steps
    replay, flips = [], []
    for t in range(steps):
        pool = ref_calls[t * per_ref:(t + 1) * per_ref]
        for own in port_calls[t * per_port:(t + 1) * per_port]:
            own = np.sort(own.numpy(), -1)
            diffs = [int((np.sort(r.reshape(own.shape), -1) != own)
                         .any(-1).sum()) for r in pool]
            best = int(np.argmin(diffs))
            replay.append(torch.from_numpy(pool[best].reshape(own.shape)
                                           .astype(np.int64)))
            flips.append(diffs[best])
    return replay, flips


@pytest.fixture(scope="module")
def runs():
    """Three steps of both packages: RoSDHB, float32 banks."""
    return _run_both(_overrides(JSp, JAgg, JAtk),
                     _overrides(SparsifierConfig, AggregatorConfig,
                                AttackConfig))


def test_plans_agree(runs):
    ref, port = runs
    jp, p = ref["plan"], port["plan"]
    assert p.flat_spec.padded_size == jp.flat_spec.padded_size == 1_313_280
    assert (p.n_workers, p.local_batch) == (jp.n_workers, jp.local_batch)
    assert (p.algo.f, p.algo.gamma, p.algo.beta) == (jp.algo.f, jp.algo.gamma,
                                                     jp.algo.beta)
    assert port["payload"] == ref["payload"]
    assert port["draws_left"] == 0


def test_losses_and_directions_match(runs):
    """Honest loss within rtol 2e-3 and |R| within rtol 2e-2 at each of the
    three steps. Both sides differentiate with respect to bf16 parameters,
    so activations and gradients round to bf16 (relative 2^-9) at places
    the two frameworks choose differently; the loss averages 7 x 127 token
    losses, |R| is a norm over the 5% of coordinates CWTM keeps of the
    momentum of those bf16 gradients."""
    ref, port = runs
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)


def test_parameters_after_three_steps_match(runs):
    """Each parameter leaf after three steps: its distance to the
    reference's within 5e-2 of the reference's own update (the bf16
    gradient noise above, at most 3 steps of it). Coordinates in no block
    any step selected have zero momentum, so a zero direction: both
    packages leave them bitwise as they were."""
    ref, port = runs
    for got, want, p0 in zip(port["params"], ref["params"], ref["p0"]):
        update = np.abs(want - p0).max()
        assert np.abs(got - want).max() <= 5e-2 * update + 1e-7
    flat = lambda leaves: np.concatenate(  # noqa: E731
        [np.ravel(a) for a in leaves])
    p0, got, want = flat(ref["p0"]), flat(port["params"]), flat(ref["params"])
    sel = np.zeros(port["plan"].flat_spec.padded_size // 512, bool)
    for ids in ref["ids"]:
        sel[ids] = True
    untouched = ~np.repeat(sel, 512)[:p0.size]
    assert 0.8 < untouched.mean() < 0.9
    np.testing.assert_array_equal(got[untouched], p0[untouched])
    np.testing.assert_array_equal(want[untouched], p0[untouched])


# ----------------------------------------------------------------------- #
# the launcher's other options: bfloat16 banks, dasha
# ----------------------------------------------------------------------- #


def test_plan_defaults_to_bf16_banks_as_the_reference():
    """``make_train_plan`` with no overrides: bfloat16 server banks in both
    packages (the reference's default, ``steps.py:111``)."""
    jmodel = jax_get_arch("stablelm_3b").model.reduced(n_layers=1,
                                                       d_model=64)
    model = get_arch("stablelm_3b").model.reduced(n_layers=1, d_model=64)
    shape = ("host_train", 16, N, "train")
    jplan = JS.make_train_plan(JArchSpec(jmodel, "test"), JInputShape(*shape),
                               make_host_mesh(), n_workers=N)
    plan = S.make_train_plan(ArchSpec(model, "test"), InputShape(*shape),
                             n_workers=N)
    assert plan.algo.momentum_dtype == jplan.algo.momentum_dtype == "bfloat16"
    bank = Alg.init_state(plan.algo, 64, device="cpu").momentum
    jbank = JAlg.init_state(jplan.algo, 64).momentum
    assert bank.dtype == torch.bfloat16 and str(jbank.dtype) == "bfloat16"
    assert (plan.algo.name, plan.algo.f, plan.algo.sparsifier.kind) == (
        jplan.algo.name, jplan.algo.f, jplan.algo.sparsifier.kind)


def _launcher_overrides(argv):
    """The plan overrides the reference's launcher builds from ``argv``
    (``repro/launch/train.py:76-88``), and the port's plan from the same
    flags."""
    args = TR.parse_args(argv + ["--device", "cpu"])
    jov = {"name": args.algo, "gamma": args.gamma,
           "momentum_dtype": args.momentum_dtype,
           "sparsifier": JSp(kind="block", ratio=args.ratio, block_size=512,
                             local=args.local_masks),
           "attack": JAtk(name=args.attack),
           "f": args.f, "aggregator": JAgg(name="cwtm", f=max(args.f, 1))}
    return jov, TR.setup(args)["plan"]


@pytest.mark.parametrize("flags", [["--momentum-dtype", "bfloat16"],
                                   ["--algo", "dasha"], ["--local-masks"],
                                   ["--stream", "--chunk-size", "2"]])
def test_launcher_flags_give_the_reference_plan(flags):
    jov, plan = _launcher_overrides(["--arch", "stablelm_3b", "--f", "1",
                                     "--gamma", "0.5"] + flags)
    a = plan.algo
    assert (a.name, a.momentum_dtype, a.gamma, a.f, a.sparsifier.local,
            a.sparsifier.ratio, a.attack.name, a.aggregator.f) == (
        jov["name"], jov["momentum_dtype"], jov["gamma"], jov["f"],
        jov["sparsifier"].local, jov["sparsifier"].ratio,
        jov["attack"].name, jov["aggregator"].f)


@pytest.fixture(scope="module")
def runs_bf16():
    """Three steps of both packages with bfloat16 banks (the reference's
    jnp compressor: its default here)."""
    jov = {**_overrides(JSp, JAgg, JAtk), "momentum_dtype": "bfloat16"}
    ov = {**_overrides(SparsifierConfig, AggregatorConfig, AttackConfig),
          "momentum_dtype": "bfloat16"}
    return _run_both(jov, ov, use_pallas=None)


def test_bf16_banks_match_the_reference(runs_bf16):
    """bfloat16 wire and momentum bank in both packages; the honest loss
    and |R| within the float32 run's bounds (the bf16 gradients dominate
    the difference, the banks' rounding adds 2^-9 relative); coordinates in
    no selected block keep their parameters bitwise."""
    ref, port = runs_bf16
    assert port["state"].server.momentum.dtype == torch.bfloat16
    assert port["draws_left"] == 0
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)
    sel = np.zeros(port["plan"].flat_spec.padded_size // 512, bool)
    for ids in ref["ids"]:
        sel[ids] = True
    untouched = ~np.repeat(sel, 512)
    assert (port["momentum"][:, untouched] == 0).all()
    assert (ref["momentum"][:, untouched] == 0).all()


@pytest.fixture(scope="module")
def runs_dasha():
    jov = {**_overrides(JSp, JAgg, JAtk), "name": "dasha"}
    ov = {**_overrides(SparsifierConfig, AggregatorConfig, AttackConfig),
          "name": "dasha"}
    return _run_both(jov, ov)


def test_dasha_steps_match_the_reference(runs_dasha):
    """Byz-DASHA-PAGE through the train step, per-worker block ids: the
    honest loss within rtol 2e-3 and |R| within rtol 2e-2 at each step (the
    float32 run's bounds: bf16 gradients rounded at other places), and the
    full state (float32 MVR momentum, mirror and previous gradients)."""
    ref, port = runs_dasha
    assert port["draws_left"] == 0
    srv = port["state"].server
    assert srv.mirror is not None and srv.prev_grad.dtype == torch.float32
    assert port["payload"] == ref["payload"]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)


# ----------------------------------------------------------------------- #
# model dtype float32: the float32 flash kernels' train step
# ----------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def runs_f32():
    """Two steps of both packages on reduced stablelm_3b cut to 1 layer at
    model dtype float32 (the LLM cut's float32 train step: both steps
    differentiate with respect to bf16 parameters, but the activations,
    and so q, k and v, stay float32): RoSDHB, float32 banks."""
    return _run_both(_overrides(JSp, JAgg, JAtk),
                     _overrides(SparsifierConfig, AggregatorConfig,
                                AttackConfig), steps=2, n_layers=1,
                     dtype="float32")


def test_float32_model_steps_match_the_reference(runs_f32):
    """Honest loss within rtol 1e-5 and |R| within rtol 1e-4 at both
    steps, far inside the bfloat16 model's 2e-3 and 2e-2: with float32
    activations on both sides the two frameworks differ only in float32
    summation order until each rounds its gradients to the bf16
    parameters' dtype (read: 2e-7 on the loss, 4e-6 on |R|)."""
    ref, port = runs_f32
    assert port["plan"].model.dtype == ref["plan"].model.dtype == "float32"
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=1e-4)


def test_float32_model_loss_matches_the_pallas_kernel(runs_f32):
    """The step's forward at float32 through the reference's Pallas flash
    kernel in interpret mode (``use_flash_attention=True``; its gradient
    fails, so the reference's steps above take its plain attention): the
    reference's loss at the initial parameters and the first batch against
    the port's (the kernels' plain forward on the CPU) within rtol 1e-5,
    and against the reference's own plain attention within 1e-5."""
    from repro.models import transformer as JTm
    from repro_torch.models import lm_loss
    ref, port = runs_f32
    jcfg = ref["plan"].model
    batch = {"tokens": jnp.asarray(ref["batches"][0]["tokens"][0])}
    pallas = float(JTm.lm_loss(ref["p0_tree"], jcfg.with_overrides(
        use_flash_attention=True), batch))
    plain = float(JTm.lm_loss(ref["p0_tree"], jcfg, batch))
    cfg = port["plan"].model.with_overrides(use_flash_attention=True)
    got = float(lm_loss(from_jax_params(ref["p0_tree"]), cfg,
                        {"tokens": torch.from_numpy(
                            ref["batches"][0]["tokens"][0])}))
    assert pallas == pytest.approx(plain, rel=1e-5)
    assert got == pytest.approx(pallas, rel=1e-5)


#: The bank dtype each new train path runs at on the card (float32 where
#: the card's run holds other banks: the float32 run's bounds hold there).
NEW_PATH_BANKS = {"dbrx_132b": "float8_e4m3fn",
                  "llama32_vision_11b": "bfloat16"}


@pytest.mark.parametrize("arch", ["qwen25_3b", "mistral_large_123b",
                                  "dbrx_132b", "llama32_vision_11b"])
def test_new_train_paths_match_the_reference(arch):
    """The train paths the card runs at full width, at 1 layer and d_model
    256: qwen25_3b (QKV bias, grouped KV heads, an untied head),
    mistral_large_123b, dbrx_132b at float8 banks (2 experts of the
    reduced MoE, top 2) and llama32_vision_11b at bfloat16 banks (2
    layers, the second a cross layer over 16 image embeddings: the
    smallest depth with one), each through the port's streamed step, two
    steps against the reference's ``build_train_step`` at the float32
    run's bounds (honest loss rtol 2e-3, |R| rtol 2e-2, each parameter
    within 5e-2 of the reference's own update), and every coordinate of no
    selected block bitwise. Below float32 the reference takes its jnp
    compressor, as its bfloat16 run above. At float8 banks a bf16
    gradient that differs in its last bit can cross a float8 rounding
    boundary (steps of 2^-3 relative: 3 mantissa bits), so a parameter is
    held instead to two such steps (one a step) of the largest momentum
    of its leaf, times gamma, and at most 1% of the coordinates may
    differ at all (0.34% do here). In bf16 a near tie of two router
    probabilities can break either way between the packages (3 of the
    second step's 1,024 token choices here): dbrx's port reruns its steps
    with the reference's own choices replayed (``models.moe.RouteLog``),
    each within 4 tokens of its own."""
    mdt = NEW_PATH_BANKS.get(arch, "float32")
    jov = {**_overrides(JSp, JAgg, JAtk), "momentum_dtype": mdt}
    ov = {**_overrides(SparsifierConfig, AggregatorConfig, AttackConfig),
          "momentum_dtype": mdt}
    moe = get_arch(arch).model.family == "moe"
    if moe:
        with pytest.MonkeyPatch.context() as mp:
            ref_calls = _reference_routes(mp)
            own = MOE.RouteLog()
            ref, port = _run_both(jov, ov, steps=2, n_layers=1, arch=arch,
                                  use_pallas=None, routes=own)
            jax.effects_barrier()
        replay, flips = _replay_of(ref_calls, own.calls, 2)
        assert len(replay) == 2 * N and max(flips) <= 4
        port = _run_port(ref, port["plan"].model, ov, port["shape"],
                         routes=MOE.RouteLog(replay))
    else:
        ref, port = _run_both(jov, ov, steps=2, n_layers=1, arch=arch,
                              use_pallas=True if mdt == "float32" else None)
    assert port["plan"].algo.momentum_dtype == mdt
    assert Alg.streams_payload(port["plan"].algo, port["plan"].bank_width)
    assert port["plan"].flat_spec.padded_size == \
        ref["plan"].flat_spec.padded_size
    assert port["draws_left"] == 0
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)
    flat = lambda leaves: np.concatenate(  # noqa: E731
        [np.ravel(a) for a in leaves])
    p0, got = flat(ref["p0"]), flat(port["params"])
    off = 0
    for g, want, w0 in zip(port["params"], ref["params"], ref["p0"]):
        err = np.abs(g - want).max()
        if mdt == "float8_e4m3fn":
            m = np.abs(ref["momentum"][:, off:off + g.size]).max()
            assert err <= GAMMA * 2 * 2.0 ** -3 * m
        else:
            assert err <= 5e-2 * np.abs(want - w0).max() + 1e-7
        off += g.size
    if mdt == "float8_e4m3fn":
        assert (got != flat(ref["params"])).mean() <= 0.01
    sel = np.zeros(port["plan"].bank_width // 512, bool)
    for ids in ref["ids"]:
        sel[ids] = True
    untouched = ~np.repeat(sel, 512)[:p0.size]
    np.testing.assert_array_equal(got[untouched], p0[untouched])
