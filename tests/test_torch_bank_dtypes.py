"""float16 and float8_e4m3fn server banks of the port against the
reference: the float8 cast (``utils.dtypes.to_float8``) bit for bit against
JAX's on every float8 value, the boundary around 448 and 464, the
subnormals, +-inf and NaN; RoSDHB and dasha rollouts on the quadratic with
such banks against the reference's ``Simulator.rollout`` on its own draws;
the randk kernels' plain versions at those dtypes; and what stays refused
(a float8 direction onto float32 parameters)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.core.simulator import Simulator as JSimulator
from repro.core.sweep import quadratic_testbed as jax_quadratic
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import Simulator, quadratic_testbed
from repro_torch.kernels.randk import (block_compress_ref,
                                       block_decompress_ref,
                                       momentum_scatter_ref)
from repro_torch.testing import ReplayDraws
from repro_torch.utils.dtypes import FLOAT8, lowp, to_dtype, to_float8

N, F = 13, 3
LOWP = ["float16", "float8_e4m3fn"]


def _jax_f8_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(
        jnp.asarray(x))).view(np.uint8)


def _f8_bits(x: np.ndarray) -> np.ndarray:
    return to_float8(torch.tensor(x)).view(torch.uint8).numpy()


def test_float8_cast_is_jaxs_bit_for_bit():
    """Every float8 value (as float32), the midpoints between neighbours
    and a float32 ulp either side, the values around 448 and 464, the
    subnormals, +-inf and +-NaN: the same bits as JAX's cast, NaN (of the
    value's sign) past 464 where PyTorch's own cast saturates to 448."""
    every = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(
        np.float32)
    fin = np.sort(every[np.isfinite(every)])
    mid = (fin[:-1] + fin[1:]) / 2
    edge = np.array([440, 447.9, 448, 448.1, 456, 463.99, 464, 464.0001,
                     465, 470, 479.9, 480, 1e4, 2 ** -9, 2 ** -10,
                     3 * 2 ** -10, 2 ** -6, 2 ** -6 - 2 ** -10, 1e-30,
                     np.inf, np.nan, 0.0], np.float32)
    x = np.concatenate([every, mid, np.nextafter(mid, np.inf),
                        np.nextafter(mid, -np.inf), edge, -edge])
    np.testing.assert_array_equal(_f8_bits(x), _jax_f8_bits(x))
    assert torch.isnan(to_float8(torch.tensor([465.0, -1e4])).float()).all()
    assert float(torch.tensor(470.0).to(FLOAT8).float()) == 448.0


@pytest.mark.parametrize("src", [torch.float16, torch.bfloat16])
def test_float8_cast_from_half_types(src):
    """From float16 (every value) and bfloat16 (every value): JAX's bits
    (the port casts straight from the narrow type)."""
    x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(src)
    want = np.asarray(jnp.asarray(x.float().numpy()).astype(src.__repr__(
    ).split(".")[-1]).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(to_float8(x).view(torch.uint8).numpy(),
                                  want)


def test_to_dtype_and_lowp():
    x = torch.tensor([1.0, 500.0, -3.3])
    assert to_dtype(x, torch.float16).dtype == torch.float16
    assert torch.equal(to_dtype(x, FLOAT8).view(torch.uint8),
                       to_float8(x).view(torch.uint8))
    y = lowp(torch.mul, to_float8(x), to_float8(x), dtype=FLOAT8)
    np.testing.assert_array_equal(
        y.view(torch.uint8).numpy(),
        _jax_f8_bits(np.asarray(jnp.asarray(x.numpy()).astype(
            jnp.float8_e4m3fn) ** 2).astype(np.float32)))
    assert torch.isnan(y.float()[1])


def _cell(name, mdt):
    """The fig1-alie cell (global RandK 0.1, ALIE z=1.5, NNM+CWTM) in both
    packages at ``mdt`` banks."""
    kw = dict(name=name, n_workers=N, f=F, gamma=0.05, beta=0.9,
              momentum_dtype=mdt)
    ref = JAlg.AlgorithmConfig(
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.1,
                                       local=name == "dasha"),
        aggregator=JG.AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=JA.AttackConfig(name="alie", z=1.5), **kw)
    port = Alg.AlgorithmConfig(
        sparsifier=C.SparsifierConfig(kind="randk", ratio=0.1,
                                      local=name == "dasha"),
        aggregator=G.AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=A.AttackConfig(name="alie", z=1.5), **kw)
    return ref, port


def _draws(name, steps, d, k):
    """The reference's RandK prefixes along its key chain: one global
    permutation a round (RoSDHB), one per worker (dasha)."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, mask_key = jax.random.split(key)
        mask_key, _ = jax.random.split(mask_key)
        keys = (jax.random.split(mask_key, N) if name == "dasha"
                else [mask_key])
        out += [np.asarray(jax.random.permutation(kk, d)[:k]) for kk in keys]
    return out


QD, QSTEPS = 200, 3


def _bits32(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("mdt", LOWP)
@pytest.mark.parametrize("name", ["rosdhb", "dasha"])
def test_quadratic_rounds_with_low_precision_banks(name, mdt):
    """Three rounds of fig1-alie on the quadratic with ``mdt`` banks
    against the reference's ``Simulator.rollout`` on its draws: the banks
    (RoSDHB's momentum; dasha's momentum and mirrors, Byzantine rows
    included) bitwise; the parameters within 8 ulp of the largest and the
    losses within rtol 1e-5, the float32 rollouts' bounds."""
    ref, port = _cell(name, mdt)
    loss_fn, params0, batch_fn, tg = jax_quadratic(N, d=QD, seed=0)
    jsim = JSimulator(loss_fn, params0, ref)
    jstate, jm = jsim.rollout(jsim.init(0), batch_fn, steps=QSTEPS)
    tloss, tparams, tbatch, _ = quadratic_testbed(N, d=QD, targets=tg,
                                                 device="cpu")
    sim = Simulator(tloss, tparams, port, device="cpu")
    draws = ReplayDraws("cpu", permutations=_draws(
        name, QSTEPS, QD, port.sparsifier.k(QD)))
    state, m = sim.rollout(sim.init(draws=draws), tbatch, steps=QSTEPS)
    assert draws.remaining == 0
    assert state.server.momentum.dtype == Alg.BANK_DTYPES[mdt]
    js, ts = jstate.server, state.server
    slots = ["momentum"] + (["mirror"] if name == "dasha" else [])
    for slot in slots:
        want = np.asarray(getattr(js, slot).astype(jnp.float32))
        got = getattr(ts, slot).float().numpy()
        np.testing.assert_array_equal(_bits32(got), _bits32(want), slot)
    # the parameters as the float32 rollouts' tests bound them: 8 ulp of
    # the largest (the aggregation sums in another order)
    want = np.asarray(jstate.params_flat)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(state.params_flat.numpy() - want).max() <= 8 * ulp
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    assert sim.server_state_bytes() == jsim.server_state_bytes()


@pytest.mark.parametrize("mdt", LOWP + ["bfloat16", "float32"])
def test_server_state_bytes_read_the_itemsize(mdt):
    for name in ("rosdhb", "dasha"):
        ref, port = _cell(name, mdt)
        assert Alg.server_state_bytes(port, 1000) == \
            JAlg.server_state_bytes(ref, 1000)


def test_float8_compute_dtype_raises_with_its_reason():
    """A float8 compute dtype is ported (``test_torch_compute_dtypes.py``),
    but its float8 direction cannot update float32 parameters: the
    simulator's step raises, with the reason, as the reference's
    ``apply_direction`` does; an unknown compute dtype is refused."""
    _, port = _cell("rosdhb", "float8_e4m3fn")
    f8 = dataclasses.replace(port, server_compute_dtype="float8_e4m3fn")
    Alg.init_state(f8, 16, device="cpu")
    with pytest.raises(TypeError, match="float8 promotes with no other"):
        Alg.apply_direction(torch.zeros(16), torch.zeros(16, dtype=FLOAT8),
                            0.05)
    with pytest.raises(ValueError, match="is not ported"):
        Alg.init_state(dataclasses.replace(port, server_compute_dtype="int8"),
                       16, device="cpu")
    Alg.init_state(dataclasses.replace(port, server_compute_dtype="float16"),
                   16, device="cpu")


@pytest.mark.parametrize("dt", [torch.float16, FLOAT8])
def test_randk_plain_versions_at_low_precision(dt):
    """compress rounds ``alpha * g`` once (float8: NaN past 464, here
    ``alpha = 16`` lifts values past it), decompress moves bits, and the
    momentum update rounds the float32 ``fma(beta, m, (1-beta) p)`` once
    and hands the float32 result back."""
    n, bs, nb, kb = 3, 64, 8, 2
    rng = np.random.default_rng(1)
    g32 = torch.tensor(rng.normal(size=(n, nb * bs)).astype(np.float32)) * 8
    g = to_dtype(g32, dt)
    ids = torch.tensor([5, 2])
    pay = block_compress_ref(g, ids, bs, 16.0)
    want = to_dtype(g.float().reshape(n, nb, bs)[:, [5, 2]].reshape(n, -1)
                    * 16.0, dt)
    np.testing.assert_array_equal(pay.view(torch.uint8).numpy(),
                                  want.view(torch.uint8).numpy())
    if dt == FLOAT8:
        assert torch.isnan(pay.float()).any()
    dense = block_decompress_ref(pay, ids, bs, nb * bs)
    assert dense.dtype == dt
    np.testing.assert_array_equal(
        dense.reshape(n, nb, bs)[:, 5].view(torch.uint8).numpy(),
        pay.reshape(n, kb, bs)[:, 0].view(torch.uint8).numpy())
    pay = to_dtype(g32[:, :kb * bs], dt)
    m = to_dtype(torch.tensor(rng.normal(size=(n, nb * bs)).astype(
        np.float32)) * 300, dt)
    m0 = m.clone()
    out = momentum_scatter_ref(m, pay, ids, bs, 0.9,
                               out=torch.empty(n, nb * bs))
    wire = torch.zeros(n, nb, bs)
    wire[:, [5, 2]] = pay.float().reshape(n, kb, bs)
    want = (wire.reshape(n, -1) * (1 - 0.9)).add_(m0.float(), alpha=0.9)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    np.testing.assert_array_equal(m.view(torch.uint8).numpy(),
                                  to_dtype(want, dt).view(torch.uint8)
                                  .numpy())


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"] + LOWP)
@pytest.mark.parametrize("cdt", ["float16", "bfloat16"])
def test_float16_compute_dtype_matches_the_reference(cdt, mdt):
    """One RoSDHB round computing in ``cdt`` over ``mdt`` banks against the
    reference's compiled ``server_round`` (the fig1-alie cell): the bank
    bitwise, the direction within one ``cdt`` ulp of max |R|, at most 2%
    of its coordinates off (NNM's float32 mixing sums in another order),
    as the bfloat16 compute dtype's test bounds it. The port aggregates
    with its plain rules, which rank NNM's neighbours by distances in the
    compute dtype as the reference does (the kernel path ranks by float32
    distances, ROADMAP "reference behaviours"; on this input at bfloat16
    over float8 banks that picks other neighbours, 0.055 apart)."""
    ref, port = _cell("rosdhb", mdt)
    ref = dataclasses.replace(ref, server_compute_dtype=cdt)
    port = dataclasses.replace(
        port, server_compute_dtype=cdt,
        aggregator=dataclasses.replace(port.aggregator, use_kernels=False))
    d = 500
    rng = np.random.default_rng(0)
    g = rng.normal(size=(N, d)).astype(np.float32)
    m0 = rng.normal(size=(N, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[0], d)[
        :ref.sparsifier.k(d)])
    st = JAlg.init_state(ref, d)._replace(
        momentum=jnp.asarray(m0).astype(mdt))
    r, new, _ = jax.jit(lambda st, g: JAlg.server_round(ref, st, g, key))(
        st, g)
    tst = Alg.init_state(port, d, device="cpu")._replace(
        momentum=to_dtype(torch.tensor(m0), Alg.BANK_DTYPES[mdt]))
    tr, tnew, _ = Alg.server_round(port, tst, torch.tensor(g),
                                   ReplayDraws("cpu", permutations=[perm]))
    assert tr.dtype == Alg.COMPUTE_DTYPES[cdt] and str(r.dtype) == cdt
    np.testing.assert_array_equal(
        _bits32(tnew.momentum.float().numpy()),
        _bits32(np.asarray(new.momentum.astype(jnp.float32))))
    want_r = np.asarray(r.astype(jnp.float32))
    got_r = tr.float().numpy()
    scale = np.abs(want_r).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - (10 if cdt == "float16"
                                               else 7))
    assert np.abs(got_r - want_r).max() <= ulp
    assert (got_r != want_r).mean() <= 0.02


def test_ravel_into_a_float8_row_casts_as_the_reference():
    """The train step ravels bf16 gradients into the float8 wire bank with
    the reference's cast (NaN past 464), where ``copy_`` would saturate."""
    from repro_torch.utils.tree import make_flat_spec, tree_ravel_into
    tree = {"a": torch.tensor([1.0, 470.0, -1e4], dtype=torch.bfloat16),
            "b": torch.tensor([[0.3, -0.0]], dtype=torch.bfloat16)}
    spec = make_flat_spec(tree, pad_to=8)
    row = torch.full((spec.padded_size,), 7.0).to(FLOAT8)
    tree_ravel_into(tree, row, spec)
    want = np.concatenate([np.array([1.0, 470.0, -1e4, 0.3, -0.0],
                                    np.float32), np.zeros(3, np.float32)])
    want = jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(row.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
