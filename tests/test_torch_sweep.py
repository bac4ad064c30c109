"""The port's grid engine (``repro_torch.core.sweep``) and scenario registry
against the reference's ``repro.core.sweep`` and
``repro.adversary.registry``: the registry letter for letter, every spec's
plan, ``bytes_to_threshold``, and whole grids on the quadratic testbed
(d = 64) with the reference's own draws replayed per seed.

Bounds: a grid lane's parameters within 8 ulp of max |w| of the
reference's lane after 8 rounds (table1-mini) or 6 (stateful-core), the
bound of the fig1-alie trajectory test (``test_torch_simulator``): the
aggregation sums in another order and the compiled reference fuses the row
statistics; per-round metrics and result rows rtol 1e-5. A grid lane
against the port's own lone rollout of its cell: bitwise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.adversary import registry as JR
from repro.core import sweep as JS
from repro_torch.adversary import registry as R
from repro_torch.core import sweep as S
from repro_torch.core.simulator import Simulator
from repro_torch.testing import ReplayDraws


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


QD = 64
SEEDS = (0, 1)


def _seed_draws(seed, steps, d, k, n, f, *, glob=True, local=False,
                normal=False, uniform=False):
    """One seed's draws along the reference's key chain
    (``simulator.py:142``, ``algorithms.py:819``): the global mask's
    permutation prefix, the per-worker ones (``split(mask_key, n)``),
    gauss's normals and ipm_greedy's coins (``atk_key``), per round."""
    key = jax.random.PRNGKey(seed)
    perms, normals, uniforms = [], [], []
    for _ in range(steps):
        key, mask_key = jax.random.split(key)
        mask_key, atk_key = jax.random.split(mask_key)
        if glob:
            perms.append(np.asarray(jax.random.permutation(mask_key, d)[:k]))
        if local:
            perms += [np.asarray(jax.random.permutation(kk, d)[:k])
                      for kk in jax.random.split(mask_key, n)]
        if normal:
            normals.append(np.asarray(jax.random.normal(atk_key, (f, d))))
        if uniform:
            k1, k2 = jax.random.split(atk_key)
            uniforms.append(np.array([jax.random.uniform(k1, ()),
                                      jax.random.uniform(k2, ())],
                                     np.float32))
    return ReplayDraws("cpu", permutations=perms, normals=normals,
                       uniforms=uniforms)


def _bank_draws(bank, steps, d, seed):
    cfg = bank.cfg
    used = {cfg.attack.bank[i] for i in bank.attack_idx}
    algos = set(cfg.algorithms())
    return _seed_draws(seed, steps, d, cfg.sparsifier.k(d), cfg.n_workers,
                       cfg.f, glob=bool(algos & {"rosdhb", "dgd"}),
                       local="dasha" in algos, normal="gauss" in used,
                       uniform="ipm_greedy" in used)


def _lone_draws(cfg, steps, d, seed):
    name, atk = cfg.name, cfg.attack.name
    return _seed_draws(seed, steps, d, cfg.sparsifier.k(d), cfg.n_workers,
                       cfg.f, glob=name in ("rosdhb", "dgd"),
                       local=name == "dasha", normal=atk == "gauss",
                       uniform=atk == "ipm_greedy")


def _testbeds(n):
    jloss, jp0, jbatch, tg = JS.quadratic_testbed(n, d=QD)
    loss, p0, batch, _ = S.quadratic_testbed(n, d=QD, targets=np.asarray(tg),
                                             device="cpu")
    return (jloss, jp0, jbatch), (loss, p0, batch), np.asarray(tg)


# ----------------------------------------------------------------------- #
# the registry and the plan
# ----------------------------------------------------------------------- #


def test_registry_is_the_references_letter_for_letter():
    assert list(R.REGISTRY) == list(JR.REGISTRY)
    assert len(R.REGISTRY) == 13
    for name, spec in R.REGISTRY.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            JR.REGISTRY[name])
    assert R.describe() == JR.describe()
    with pytest.raises(ValueError, match="known scenarios"):
        R.get_spec("table2")
    with pytest.raises(ValueError, match="byz_f"):
        R.ScenarioSpec("bad", "f too large", byz_f=(13,)).expand()


def _bank_view(bank):
    cfg = bank.cfg
    return {
        "labels": [sc.label for sc in bank.scenarios],
        "coeffs": [tuple(np.float32(c)) for c in bank.coeffs],
        "attack_idx": bank.attack_idx, "agg_idx": bank.agg_idx,
        "ratios": bank.ratios, "algo_idx": bank.algo_idx,
        "hparams": bank.hparams, "gammas": bank.gammas,
        "name": cfg.name, "bank": cfg.bank, "attack": cfg.attack.bank,
        "aggs": cfg.aggregator.bank, "f": cfg.f, "n": cfg.n_workers,
        "agg_f": cfg.aggregator.f, "ratio": cfg.sparsifier.ratio,
        "layout": dataclasses.astuple(cfg.resolved_state_layout()),
    }


@pytest.mark.parametrize("fuse,cross_algo", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("name", list(JR.REGISTRY))
def test_every_spec_plans_as_the_reference(name, fuse, cross_algo):
    cells, jcells = R.expand_scenario(name), JR.expand_scenario(name)
    assert [c.label for c in cells] == [c.label for c in jcells]
    plan = S.plan_grid(cells, fuse=fuse, cross_algo=cross_algo)
    jplan = JS.plan_grid(jcells, fuse=fuse, cross_algo=cross_algo)
    assert [sc.label for sc in plan.singles] == \
        [sc.label for sc in jplan.singles]
    assert [_bank_view(b) for b in plan.banks] == \
        [_bank_view(b) for b in jplan.banks]
    assert plan.describe() == jplan.describe()
    for b, jb in zip(plan.banks, jplan.banks):
        sp, jsp = b.scenario_params(), jb.scenario_params()
        for got, want in zip(sp, jsp):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_names_and_labels_are_checked():
    with pytest.raises(ValueError, match="unknown algorithm"):
        S.grid_scenarios(["sgd"])
    with pytest.raises(ValueError, match="unknown attack"):
        S.grid_scenarios(attacks=["linear"])
    with pytest.raises(ValueError, match="unknown aggregator"):
        S.grid_scenarios(aggregators=["trimmed"])
    cells = S.grid_scenarios()
    with pytest.raises(ValueError, match="duplicate scenario labels"):
        S.plan_grid(cells + cells)
    # a cost model partitions as the reference's does on the same cells
    from repro.core.costmodel import CostModel as JCostModel
    from repro_torch.core.costmodel import CostModel
    rates = dict(compile_s=0.0, compile_s_per_branch=0.0, cell_round_us=1.0,
                 cell_round_us_per_branch=50.0, source="partitions")
    grid = S.grid_scenarios(["rosdhb", "dasha"], ["alie", "foe"])
    jgrid = JS.grid_scenarios(["rosdhb", "dasha"], ["alie", "foe"])
    plan = S.plan_grid(grid, cost_model=CostModel(**rates), rounds=100,
                       n_seeds=2)
    jplan = JS.plan_grid(jgrid, cost_model=JCostModel(**rates), rounds=100,
                         n_seeds=2)
    assert len(plan.banks) == 2 and plan.describe() == jplan.describe()


@pytest.mark.parametrize("mode,thr", [("<=", 0.5), (">=", 0.5), ("<=", -1.0)])
@pytest.mark.parametrize("shape", [(7,), (2, 7), (3, 2, 7)])
def test_bytes_to_threshold_matches(shape, mode, thr):
    v = np.random.default_rng(len(shape)).uniform(size=shape)
    np.testing.assert_array_equal(S.bytes_to_threshold(v, 1234, thr, mode),
                                  JS.bytes_to_threshold(v, 1234, thr, mode))
    with pytest.raises(ValueError, match="mode"):
        S.bytes_to_threshold(v, 1, 0.0, "<")


# ----------------------------------------------------------------------- #
# whole grids on the quadratic testbed
# ----------------------------------------------------------------------- #


def _eval_fn_pair(tg, f):
    opt = tg[f:].mean(axis=0)
    jeval = lambda p, b: {"err": jax.numpy.linalg.norm(p["w"] - b)}  # noqa
    teval = lambda p, b: {"err": torch.linalg.vector_norm(  # noqa: E731
        p["w"] - b)}
    return jeval, teval, opt


@pytest.fixture(scope="module", params=[("table1-mini", 8),
                                        ("stateful-core", 6)])
def grid(request):
    """One registry grid in both packages: the reference's fused rollout,
    its result rows (with an eval), and the port's, on the reference's
    draws."""
    name, steps = request.param
    spec = R.get_spec(name)
    cells, jcells = spec.expand(), JR.get_spec(name).expand()
    (jloss, jp0, jbatch), (loss, p0, batch), tg = _testbeds(spec.n_workers)
    (jbank,), (bank,) = JS.plan_grid(jcells).banks, S.plan_grid(cells).banks
    jsim = JS.Simulator(jloss, jp0, jbank.cfg)
    jst, jm = JS.fused_grid_rollout(jsim, jbank.scenario_params(), SEEDS,
                                    jbatch, steps)
    sim = Simulator(loss, p0, bank.cfg, device="cpu")
    draws = [_bank_draws(bank, steps, QD, s) for s in SEEDS]
    st, m = S.fused_grid_rollout(sim, bank.scenario_params(), SEEDS, batch,
                                 steps, draws=draws)
    assert all(d.remaining == 0 for d in draws)
    jeval, teval, opt = _eval_fn_pair(tg, spec.byz_f[0])
    jrows = JS.run_scenarios(jcells, loss_fn=jloss, params0=jp0,
                             batches=jbatch, seeds=SEEDS, steps=steps,
                             eval_fn=jeval, eval_batch=opt)
    rows = S.run_scenarios(cells, loss_fn=loss, params0=p0, batches=batch,
                           seeds=SEEDS, steps=steps, eval_fn=teval,
                           eval_batch=torch.tensor(opt), device="cpu",
                           draws_fn=lambda s: _bank_draws(bank, steps, QD, s))
    return {"name": name, "steps": steps, "bank": bank, "sim": sim,
            "loss": loss, "p0": p0, "batch": batch,
            "want": np.asarray(jst.params_flat), "jm": jm,
            "got": st.params_flat.numpy(), "m": m, "state": st,
            "rows": rows, "jrows": jrows}


def test_grid_lanes_match_the_reference(grid):
    want, got = grid["want"], grid["got"]
    assert got.shape == want.shape == (grid["bank"].n_cells, len(SEEDS), QD)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    err = np.abs(got - want).max(axis=(1, 2)) / ulp
    assert (err <= 8).all(), dict(zip(
        [sc.label for sc in grid["bank"].scenarios], err))
    for k in ("loss", "grad_norm", "dir_norm"):
        np.testing.assert_allclose(grid["m"][k].numpy(),
                                   np.asarray(grid["jm"][k]), rtol=1e-5)


def test_grid_rows_match_the_reference(grid):
    rows, jrows = grid["rows"], grid["jrows"]
    assert [(r["scenario"], r["seed"]) for r in rows] == \
        [(r["scenario"], r["seed"]) for r in jrows]
    for r, jr in zip(rows, jrows):
        assert set(r) == set(jr)
        for k, v in jr.items():
            if isinstance(v, float):
                np.testing.assert_allclose(r[k], v, rtol=1e-5, err_msg=k)
            else:
                assert r[k] == v, k


def test_each_lane_equals_its_lone_rollout(grid):
    """Every cell's every seed, run alone through ``Simulator.rollout`` on
    its own draws, gives the lane's parameters and metrics bitwise."""
    bank, steps = grid["bank"], grid["steps"]
    for c, sc in enumerate(bank.scenarios):
        for s, seed in enumerate(SEEDS):
            sim = Simulator(grid["loss"], grid["p0"], sc.cfg, device="cpu")
            draws = _lone_draws(sc.cfg, steps, QD, seed)
            st, m = sim.rollout(sim.init(draws=draws), grid["batch"], steps)
            assert draws.remaining == 0
            assert torch.equal(st.params_flat,
                               torch.tensor(grid["got"][c, s])), sc.label
            assert torch.equal(m["loss"], grid["m"]["loss"][c, s])


def test_grid_state_keeps_the_lane_axis(grid):
    st, bank = grid["state"], grid["bank"]
    b = bank.n_cells * len(SEEDS)
    assert st.server.momentum.shape == (b, bank.cfg.n_workers, QD)
    assert st.server.step == grid["steps"]
    assert st.server.attack.vec.shape == (b, QD)
    assert bool((st.server.attack.step == grid["steps"]).all())
    assert st.draws.seed_of_lane == tuple(
        s for _ in range(bank.n_cells) for s in range(len(SEEDS)))


def test_fused_attack_rollout_matches_the_reference():
    (jloss, jp0, jbatch), (loss, p0, batch), _ = _testbeds(13)
    from repro.core import attacks as JA
    from repro_torch.core import attacks as A
    jcfg = dataclasses.replace(JS.grid_scenarios()[0].cfg,
                               attack=JA.AttackConfig(name="linear"))
    cfg = dataclasses.replace(S.grid_scenarios()[0].cfg,
                              attack=A.AttackConfig(name="linear"))
    names = ("alie", "signflip", "foe")
    jst, _ = JS.fused_attack_rollout(
        JS.Simulator(jloss, jp0, jcfg), [JA.AttackConfig(name=a) for a in
                                         names], (3,), jbatch, 5)
    draws = [_seed_draws(3, 5, QD, cfg.sparsifier.k(QD), 13, 3)]
    st, m = S.fused_attack_rollout(
        Simulator(loss, p0, cfg, device="cpu"),
        [A.AttackConfig(name=a) for a in names], (3,), batch, 5,
        draws=draws)
    assert st.params_flat.shape == (3, 1, QD)
    want = np.asarray(jst.params_flat)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(st.params_flat.numpy() - want).max() <= 8 * ulp
    with pytest.raises(ValueError, match="linear"):
        S.fused_attack_rollout(Simulator(loss, p0, S.grid_scenarios()[0].cfg,
                                         device="cpu"),
                               [A.AttackConfig(name="alie")], (0,), batch, 1)


# ----------------------------------------------------------------------- #
# the CLI
# ----------------------------------------------------------------------- #


def test_main_runs_table1_mini_on_the_cpu(capsys):
    rows = S.main(["--scenario", "table1-mini", "--device", "cpu",
                   "--seeds", "2", "--steps", "3"])
    assert len(rows) == 8 * 2
    assert {r["algo"] for r in rows} == {"rosdhb", "dasha", "robust_dgd",
                                         "dgd"}
    assert all(np.isfinite(r["final_loss"]) for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("scenario,algo,attack") and len(out) == 17
    S.main(["--scenario", "mixed-attacks", "--plan", "--device", "cpu"])
    assert capsys.readouterr().out.startswith(
        "18 scenarios -> 1 programs")
    S.main(["--list-scenarios"])
    assert capsys.readouterr().out.strip() == JR.describe()
    plain = S.main(["--algos", "rosdhb", "--attacks", "alie,mimic",
                    "--aggs", "median", "--seeds", "1", "--steps", "2",
                    "--kernels", "plain", "--device", "cpu", "--no-fuse"])
    assert [r["attack"] for r in plain] == ["alie", "mimic"]


def test_chaos_serve_runs_as_the_references_sweep():
    """The chaos-harness serving cell runs through the grid CLI, and its
    result rows on the reference's draws and targets match the reference's
    sweep (rtol 1e-5, the grid rows' bar)."""
    rows = S.main(["--scenario", "chaos-serve", "--device", "cpu",
                   "--seeds", "1", "--steps", "3"])
    assert [r["scenario"] for r in rows] == ["chaos-serve/rosdhb/alie/cwtm"]
    assert np.isfinite(rows[0]["final_loss"])
    steps = 5
    cells, jcells = R.expand_scenario("chaos-serve"), \
        JR.expand_scenario("chaos-serve")
    (jloss, jp0, jbatch), (loss, p0, batch), _ = _testbeds(13)
    jrows = JS.run_scenarios(jcells, loss_fn=jloss, params0=jp0,
                             batches=jbatch, seeds=SEEDS, steps=steps)
    rows = S.run_scenarios(
        cells, loss_fn=loss, params0=p0, batches=batch, seeds=SEEDS,
        steps=steps, device="cpu",
        draws_fn=lambda s: _lone_draws(cells[0].cfg, steps, QD, s))
    assert len(rows) == len(jrows) == len(SEEDS)
    for r, jr in zip(rows, jrows):
        assert set(r) == set(jr)
        for k, v in jr.items():
            if isinstance(v, float):
                np.testing.assert_allclose(r[k], v, rtol=1e-5, err_msg=k)
            else:
                assert r[k] == v, k


@pytest.mark.parametrize("argv,part", [
    (["--scenario", "transformer-table1"], "transformer testbed"),
    (["--testbed", "transformer"], "transformer testbed"),
    (["--stream"], "streamed"),
    (["--cost-model", "auto"], "cost model"),
])
def test_unported_parts_raise_naming_the_roadmap(argv, part, capsys):
    """The parts that raised before this slice ported them (``part``) now
    run on the CPU for 1 step and 1 seed: the transformer testbed
    (streamed), the streamed grid and the cost model, each printing finite
    rows."""
    rows = S.main(argv + ["--device", "cpu", "--steps", "1", "--seeds",
                          "1"])
    prefix = ("transformer-table1/" if "--scenario" in argv
              else "rosdhb/alie/cwtm")
    assert rows and all(r["scenario"].startswith(prefix) for r in rows)
    assert all(np.isfinite(r["final_loss"]) for r in rows)
    if "transformer" in " ".join(argv):
        assert all(0.0 <= r["acc"] <= 1.0 for r in rows)
    assert len(capsys.readouterr().out.splitlines()) == len(rows) + 1


@pytest.mark.parametrize("name", list(JR.REGISTRY))
def test_every_spec_plans_through_the_cli(name, capsys, tmp_path):
    """``--plan`` for every registry spec, with and without a cost model
    (``--cost-model PATH``): the reference's plan text."""
    from repro.core.costmodel import CostModel as JCostModel
    from repro_torch.core.costmodel import CostModel
    rates = dict(compile_s=0.5, compile_s_per_branch=0.1,
                 cell_round_us=10.0, cell_round_us_per_branch=20.0,
                 source="plan")
    path = CostModel(**rates).save(str(tmp_path / "model.json"))
    argv = ["--scenario", name, "--plan", "--device", "cpu", "--steps",
            "300", "--seeds", "4"]
    cells = JR.expand_scenario(name)
    S.main(argv)
    assert capsys.readouterr().out.strip() == JS.plan_grid(
        cells, rounds=300, n_seeds=4).describe()
    S.main(argv + ["--cost-model", path])
    assert capsys.readouterr().out.strip() == JS.plan_grid(
        cells, cost_model=JCostModel(**rates), rounds=300,
        n_seeds=4).describe()


def test_kernels_cuda_needs_the_card():
    with pytest.raises(ValueError, match="--device cuda"):
        S.main(["--kernels", "cuda", "--device", "cpu"])
