"""RoSDHB's server arithmetic at float16 and float8_e4m3fn
(``server_compute_dtype``) against the reference on the CPU: one round over
every bank dtype, aggregator and attack, bitwise; the float8 momentum step
over many values; the aggregation kernels' plain versions on float16 and
float8 inputs; the launcher's step, the simulator (which refuses a float8
direction, as the reference's does) and the dry run at float8 compute."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.kernels.cwtm.ref import cwtm_ref as j_cwtm_ref
from repro.kernels.median.ref import median_ref as j_median_ref
from repro.kernels.pairdist.ref import pairdist_ref as j_pairdist_ref
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.kernels.cwtm import cwtm_ref
from repro_torch.kernels.median import median_ref
from repro_torch.kernels.pairdist import pairdist_ref
from repro_torch.testing import ReplayDraws
from repro_torch.utils.dtypes import FLOAT8, to_dtype

BANKS = ["float32", "bfloat16", "float16", "float8_e4m3fn"]
AGGS = {"cwtm": ("cwtm", False), "median": ("median", False),
        "nnm_cwtm": ("cwtm", True)}
D = 384


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """float32 bit patterns, every NaN alike."""
    a = np.asarray(a, np.float32).copy()
    a[np.isnan(a)] = np.nan
    return a.view(np.uint32)


def _cfgs(cdt, mdt, agg, n, attack):
    f = 1 if n == 8 else 3
    name, pre = AGGS[agg]
    atk = dict(name=attack, z=1.5) if attack == "alie" else dict(name=attack)
    kw = dict(name="rosdhb", n_workers=n, f=f, gamma=0.05, beta=0.9,
              momentum_dtype=mdt, server_compute_dtype=cdt)
    ref = JAlg.AlgorithmConfig(
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.25),
        aggregator=JG.AggregatorConfig(name=name, f=f, pre_nnm=pre),
        attack=JA.AttackConfig(**atk), **kw)
    port = Alg.AlgorithmConfig(
        sparsifier=C.SparsifierConfig(kind="randk", ratio=0.25),
        aggregator=G.AggregatorConfig(name=name, f=f, pre_nnm=pre,
                                      use_kernels=False),
        attack=A.AttackConfig(**atk), **kw)
    return ref, port


@functools.lru_cache(maxsize=None)
def _inputs(n):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n, D)) * 3).astype(np.float32)
    m0 = (rng.normal(size=(n, D)) * 20).astype(np.float32)
    return g, m0


@pytest.mark.parametrize("n,attack", [(8, "foe"), (13, "alie")])
@pytest.mark.parametrize("agg", list(AGGS))
@pytest.mark.parametrize("mdt", BANKS)
@pytest.mark.parametrize("cdt", ["float16", "float8_e4m3fn"])
def test_server_round_matches_the_reference(cdt, mdt, agg, n, attack):
    """One RoSDHB round computing in ``cdt`` over ``mdt`` banks against the
    reference's compiled ``server_round`` on the CPU, with the port's plain
    rules (the reference's on the CPU): the direction (in ``cdt``) and the
    bank bitwise. FOE at scale 10 lifts the Byzantine rows past float8's
    range, so NaN flows through the float8 rounds as it does in the
    reference's; at float16 FOE's rows round their momentum with the other
    product first (``algorithms._attacked_rows``)."""
    ref, port = _cfgs(cdt, mdt, agg, n, attack)
    g, m0 = _inputs(n)
    key = jax.random.PRNGKey(n)
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[0], D)[
        :ref.sparsifier.k(D)])
    st = JAlg.init_state(ref, D)._replace(
        momentum=jnp.asarray(m0).astype(mdt))
    r, new, _ = jax.jit(lambda st, g: JAlg.server_round(ref, st, g, key))(
        st, g)
    tst = Alg.init_state(port, D, device="cpu")._replace(
        momentum=to_dtype(torch.tensor(m0), Alg.BANK_DTYPES[mdt]))
    tr, tnew, _ = Alg.server_round(port, tst, torch.tensor(g),
                                   ReplayDraws("cpu", permutations=[perm]))
    assert tr.dtype == Alg.COMPUTE_DTYPES[cdt] and str(r.dtype) == cdt
    assert tnew.momentum.dtype == Alg.BANK_DTYPES[mdt]
    np.testing.assert_array_equal(
        _bits(tnew.momentum.float().numpy()),
        _bits(np.asarray(new.momentum.astype(jnp.float32))))
    np.testing.assert_array_equal(_bits(tr.float().numpy()),
                                  _bits(np.asarray(r.astype(jnp.float32))))


@pytest.mark.parametrize("attack", ["signflip", "ipm"])
def test_float16_rounds_under_the_other_scaled_mean_attacks(attack):
    """signflip and IPM write ``-c * mu`` rows as FOE does: at float16
    compute their rows' momentum rounds as FOE's, bitwise the reference's
    (float32 banks, CWTM, n = 8)."""
    test_server_round_matches_the_reference("float16", "float32", "cwtm", 8,
                                            attack)


@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdt", BANKS)
def test_float8_momentum_is_the_compiled_reference(mdt, wdt):
    """Step 5 at float8 over 2^16 values spread from 1e-3 to past float8's
    range (so NaN too), against the reference's compiled ``beta * m + (1 -
    beta) * w`` with ``beta`` a weak-typed Python float: what the
    aggregation takes and what the bank keeps, bitwise."""
    n = 1 << 16
    rng = np.random.default_rng(7)
    m0 = (rng.normal(size=n) * rng.choice([1e-3, 1, 30, 300], size=n)
          ).astype(np.float32)
    w0 = (rng.normal(size=n) * rng.choice([1e-3, 1, 30, 900], size=n)
          ).astype(np.float32)
    mb, wb = jnp.asarray(m0).astype(mdt), jnp.asarray(w0).astype(wdt)
    beta, one_m_beta = JAlg.static_hparams(
        JAlg.AlgorithmConfig(beta=0.9))[0::2]

    def step(mb, wb):
        cdt = jnp.float8_e4m3fn
        m = beta * mb.astype(cdt) + one_m_beta * wb.astype(cdt)
        return m, m.astype(mdt)

    want_m, want_keep = jax.jit(step)(mb, wb)
    m, keep = Alg._momentum(
        torch.tensor(np.asarray(mb.astype(jnp.float32))).to(
            Alg.BANK_DTYPES[mdt]) if mdt != "float8_e4m3fn"
        else to_dtype(torch.tensor(np.asarray(mb.astype(jnp.float32))),
                      FLOAT8),
        torch.tensor(np.asarray(wb.astype(jnp.float32))).to(
            getattr(torch, wdt)), beta, one_m_beta, FLOAT8)
    assert m.dtype == FLOAT8
    np.testing.assert_array_equal(
        _bits(m.float().numpy()), _bits(np.asarray(want_m.astype(
            jnp.float32))))
    np.testing.assert_array_equal(
        _bits(to_dtype(keep, Alg.BANK_DTYPES[mdt]).float().numpy()),
        _bits(np.asarray(want_keep.astype(jnp.float32))))
    assert np.isnan(np.asarray(want_m.astype(jnp.float32))).any()


@pytest.mark.parametrize("n", [8, 13])
@pytest.mark.parametrize("dt", ["float16", "float8_e4m3fn"])
def test_plain_kernel_versions_match_the_reference_refs(dt, n):
    """The plain versions of the pairdist, CWTM and median kernels on
    float16 and float8 inputs against the reference's refs: pairdist in
    float32 (within the reference's diagonal cancellation noise: the port
    takes the Gram diagonal, the kernel's rule, so its diagonal is 0), CWTM
    and the median in the input dtype, bitwise; at n = 13 the reference's
    Pallas CWTM would pad float8 with NaN, its ref does not."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n, 700)) * rng.choice([1e-2, 1, 60],
                                                   size=(1, 1, 700))
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(dt)
    xt = to_dtype(torch.tensor(np.asarray(xj.astype(jnp.float32))),
                  getattr(torch, dt))
    f = 1 if n == 8 else 3
    got, want = pairdist_ref(xt), np.asarray(j_pairdist_ref(xj))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert (got.diagonal(dim1=-2, dim2=-1) == 0).all()
    for got, want in ((cwtm_ref(xt, f), j_cwtm_ref(xj, f)),
                      (median_ref(xt), j_median_ref(xj))):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(
            _bits(got.float().numpy()),
            _bits(np.asarray(want.astype(jnp.float32))))
        assert np.isfinite(got.float().numpy()).all()


def test_launcher_step_at_float8_compute_matches_the_reference():
    """Two steps of the launcher's train step computing RoSDHB's server
    round in float8 (reduced stablelm_3b at 1 layer, bfloat16 banks, the
    dense round with the reference's jnp compressor) against the
    reference's ``build_train_step``: the honest loss within the bfloat16
    run's bound; |R| as the reference's (a float8 scalar, from the float8
    sum of float8 squares: here every square is below float8's smallest
    subnormal, so 0 in both); the float8 direction cast to each float32
    parameter: each parameter within gamma times two of float8's finest
    subnormal steps (2^-9 each) of the reference's, at most 1% of them off
    (the bfloat16 gradients differ), and every coordinate of no selected
    block bitwise its start."""
    from test_torch_train import GAMMA, _overrides, _run_both
    from repro.core import AggregatorConfig as JAgg
    from repro.core import AttackConfig as JAtk
    from repro.core import SparsifierConfig as JSp
    from repro_torch.core import (AggregatorConfig, AttackConfig,
                                  SparsifierConfig)
    over = {"momentum_dtype": "bfloat16",
            "server_compute_dtype": "float8_e4m3fn"}
    ref, port = _run_both({**_overrides(JSp, JAgg, JAtk), **over},
                          {**_overrides(SparsifierConfig, AggregatorConfig,
                                        AttackConfig), **over},
                          steps=2, use_pallas=None, n_layers=1)
    assert port["draws_left"] == 0
    assert port["state"].server.momentum.dtype == torch.bfloat16
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    assert port["dir_norm"] == ref["dir_norm"]
    got = np.concatenate([g.reshape(-1) for g in port["params"]])
    want = np.concatenate([w.reshape(-1) for w in ref["params"]])
    p0 = np.concatenate([np.asarray(p).reshape(-1) for p in ref["p0"]])
    assert got.dtype == want.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= GAMMA * 2.0 ** -8 * 1.001
    assert (err > 0).mean() <= 0.01
    assert (want != p0).mean() > 0.01
    sel = np.zeros(port["plan"].flat_spec.padded_size // 512, bool)
    for ids in ref["ids"]:
        sel[ids] = True
    untouched = ~np.repeat(sel, 512)[:got.size]
    np.testing.assert_array_equal(got[untouched], p0[untouched])


def test_simulator_refuses_a_float8_direction_with_its_reason():
    """The reference's ``apply_direction`` raises TypePromotionError on a
    float8 direction (float8 promotes with no other float type); the
    port's Simulator raises a TypeError that says so."""
    from repro_torch.core import Simulator, quadratic_testbed
    _, port = _cfgs("float8_e4m3fn", "float32", "cwtm", 8, "alie")
    loss, params, batch, _ = quadratic_testbed(8, d=64, device="cpu")
    sim = Simulator(loss, params, port, device="cpu")
    draws = ReplayDraws("cpu", permutations=[np.arange(16)])
    with pytest.raises(TypeError, match="float8 promotes with no other"):
        sim.rollout(sim.init(draws=draws), batch, steps=1)


def test_dryrun_counts_a_float8_compute_round_on_meta():
    """The dry run takes ``--server-compute-dtype float8_e4m3fn`` and
    counts the step on ``meta`` tensors, as it does at the other dtypes:
    the dense round (the payload route is float32 compute only)."""
    from repro_torch.launch import dryrun as DR
    r = DR.run_one("stablelm_3b", "train_4k", n_layers=1, ratio=0.05,
                   server_compute_dtype="float8_e4m3fn", verbose=False)
    assert r["ok"] and r["payload_route"] is False
    assert r["step_flops"]["server"] > 0 and r["held_bytes"] > 0
