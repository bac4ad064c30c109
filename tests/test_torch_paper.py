"""The port's paper benches (``benchmarks/bench_torch_*.py``) against the
reference's (``benchmarks/*.py``) on the CPU, on the reference's own
targets, parameters and RandK draws (replayed along its key chain, as
``tests/test_torch_sweep.py`` does).

Bounds, stated beforehand: every row's distance (table1's ``dist_sq``, the
momentum, global-vs-local and breakdown distances) within rel 1e-5 of the
reference's: the gradients, masks and momentum are bitwise, and only the
aggregation's sums run in another order (the grid lanes' 8 ulp of max |w|
after 8 rounds, damped by the momentum and the step). fig1's
``comm_cost_to_tau``: ``rounds`` and ``comm_bytes_to_tau`` equal, and
``final_acc`` within 2/500 (two of the 500 eval images: float32
convolutions in another order feed the same robust round, ROADMAP's 1e-4
honest-loss bar). The suites' names and CSV lines equal the reference's.
"""

import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_aggregators as JAG  # noqa: E402
from benchmarks import bench_breakdown as JBD  # noqa: E402
from benchmarks import bench_fig1 as JF1  # noqa: E402
from benchmarks import bench_global_vs_local as JGL  # noqa: E402
from benchmarks import bench_momentum as JM  # noqa: E402
from benchmarks import bench_table1 as JT1  # noqa: E402
from benchmarks import common as JC  # noqa: E402
from benchmarks import bench_torch_aggregators as AG  # noqa: E402
from benchmarks import bench_torch_breakdown as BD  # noqa: E402
from benchmarks import bench_torch_common as C  # noqa: E402
from benchmarks import bench_torch_fig1 as F1  # noqa: E402
from benchmarks import bench_torch_global_vs_local as GL  # noqa: E402
from benchmarks import bench_torch_momentum as M  # noqa: E402
from benchmarks import bench_torch_run as RUN  # noqa: E402
from benchmarks import bench_torch_table1 as T1  # noqa: E402
from repro.core import (AggregatorConfig as JAggregatorConfig,  # noqa: E402
                        AlgorithmConfig as JAlgorithmConfig,
                        AttackConfig as JAttackConfig, Simulator as JSim,
                        SparsifierConfig as JSparsifierConfig,
                        quadratic_testbed as jax_quadratic,
                        rollout_over_seeds as jax_rollout_over_seeds)
from repro.models import cnn_init as jax_cnn_init  # noqa: E402
from repro_torch.testing import ReplayDraws, from_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REL = 1e-5
# the reference's lists, from its sources: benchmarks/run.py's suites in
# order, bench_table1.py's cells, bench_momentum.py's betas and seeds
SUITES = ("aggregators", "kernels", "table1", "momentum", "sweep",
          "breakdown", "global_vs_local", "fig1", "roofline")
TABLE1_CELLS = [("rosdhb", 0.1, 0.05), ("rosdhb-local", 0.1, 0.05),
                ("dasha", 0.1, 0.02), ("robust_dgd", 1.0, 0.1),
                ("dgd", 0.1, 0.05)]


def ref_draws(seed, steps, d, cfg):
    """One run's RandK prefixes along the reference's key chain
    (``simulator.py:142`` / the benches' ``split(k)``, then
    ``algorithms.py:819``): the global mask's, or one per worker
    (``split(mask_key, n)``) for local masks and dasha; robust_dgd and
    ALIE draw nothing."""
    sp = cfg.sparsifier
    local = cfg.name == "dasha" or (cfg.name == "rosdhb" and sp.local)
    glob = cfg.name in ("rosdhb", "dgd") and not sp.local
    k, n = sp.k(d), cfg.n_workers
    perm = jax.jit(lambda kk: jax.random.permutation(kk, d)[:k])
    perms_n = jax.jit(jax.vmap(lambda kk: jax.random.permutation(kk, d)[:k]))
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, mask_key = jax.random.split(key)
        mask_key, _ = jax.random.split(mask_key)
        if glob:
            out.append(np.asarray(perm(mask_key)))
        if local:
            out += list(np.asarray(perms_n(jax.random.split(mask_key, n))))
    return ReplayDraws("cpu", permutations=out)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ----------------------------------------------------------------------- #
# table1 and the momentum ablation: rollouts on the reference's draws
# ----------------------------------------------------------------------- #

T1_STEPS = 40


@pytest.fixture(scope="module")
def table1_pair():
    """The five cells at 40 rounds: the reference's loop of
    ``bench_table1.run`` (its assert aside: at 40 rounds the global mask
    has not caught up) and the port's ``table1_rows``, with the draws each
    cell consumed."""
    f = 3
    n = 10 + f
    loss_fn, params0, batch_fn, tg = jax_quadratic(n, JT1.D, spread=0.1,
                                                   seed=0)
    honest_opt = jnp.mean(tg[f:], axis=0)
    want = {}
    for name, ratio, gamma in TABLE1_CELLS:
        algo = "rosdhb" if name.startswith("rosdhb") else name
        cfg = JAlgorithmConfig(
            name=algo, n_workers=n, f=f, gamma=gamma, beta=0.9,
            sparsifier=JSparsifierConfig(kind="randk", ratio=ratio,
                                         local=name.endswith("local")),
            aggregator=(JAggregatorConfig(name="mean") if algo == "dgd"
                        else JAggregatorConfig(name="cwtm", f=f,
                                               pre_nnm=True)),
            attack=JAttackConfig(name="alie", z=1.5))
        sim = JSim(loss_fn=loss_fn, params0=params0, cfg=cfg)
        states, _ = jax_rollout_over_seeds(sim, [JT1.SEED], batch_fn,
                                           steps=T1_STEPS)
        th = states.params_flat[0, :JT1.D]
        want[name] = float(jnp.sum(jnp.square(th - honest_opt)))
    used = {}

    def draws_fn(name, cfg):
        used[name] = ref_draws(T1.SEED, T1_STEPS, T1.D, cfg)
        return used[name]

    got, rows = T1.table1_rows(T1_STEPS, device="cpu",
                               targets=np.asarray(tg), draws_fn=draws_fn)
    return want, got, rows, used


@pytest.mark.parametrize("cell", [c[0] for c in TABLE1_CELLS])
def test_table1_row_matches_the_reference(table1_pair, cell):
    want, got, rows, used = table1_pair
    assert used[cell].remaining == 0
    assert _rel(got[cell], want[cell]) <= REL, (got[cell], want[cell])
    row = next(r for r in rows if r["name"] == f"table1/{cell}/alie_f3")
    assert row["dist_sq"] == got[cell] and row["launches"] == {}


def test_table1_cells_and_constants_are_the_references():
    assert T1.CELLS == TABLE1_CELLS
    assert (T1.D, T1.STEPS, T1.SEED, T1.F) == (JT1.D, JT1.STEPS, JT1.SEED, 3)


def test_momentum_rows_match_the_reference(monkeypatch, capsys):
    steps, seeds = 40, (0, 1)
    monkeypatch.setattr(JM, "STEPS", steps)
    monkeypatch.setattr(JM, "SEEDS", seeds)
    want = JM.run()
    ref_lines = capsys.readouterr().out.splitlines()
    _, _, _, tg = jax_quadratic(13, M.D, spread=0.2, seed=0)
    cfg = T1.cell_config("rosdhb", 0.1, 0.05, 13, 3)
    draws = []

    def draws_fn(seed):
        draws.append(ref_draws(seed, steps, M.D, cfg))
        return draws[-1]

    rows = M.run(device="cpu", steps=steps, seeds=seeds,
                 targets=np.asarray(tg), draws_fn=draws_fn)
    assert all(d.remaining == 0 for d in draws) and len(draws) == 8
    assert [r["name"] for r in rows] == [l.split(",")[0] for l in ref_lines]
    for r in rows[:-1]:
        assert _rel(r["dist"], want[r["beta"]]) <= REL, (r, want)
    jratio = want[0.0] / max(min(want.values()), 1e-9)
    assert _rel(rows[-1]["no_momentum_over_best"], jratio) <= 2 * REL
    assert (M.D, M.STEPS, M.SEEDS, M.BETAS) == (JM.D, 800, (0, 1, 2),
                                                (0.0, 0.5, 0.9, 0.99))


# ----------------------------------------------------------------------- #
# the hand-written loops: global vs local masks, breakdown
# ----------------------------------------------------------------------- #


def _cfg(n, f, ratio, local):
    return T1.cell_config("rosdhb-local" if local else "rosdhb", ratio, 0.05,
                          n, f)


@pytest.mark.parametrize("ratio,local", [(0.05, False), (0.2, True)])
def test_global_vs_local_cell_matches_the_reference(ratio, local):
    steps, seed = 30, 1
    want = JGL._dist(ratio, local, steps=steps, seed=seed)
    tg = jax.random.normal(jax.random.PRNGKey(1), (12, GL.D)) * 0.2 + 1.0
    draws = ref_draws(seed, steps, GL.D, _cfg(12, 2, ratio, local))
    got = GL._dist(ratio, local, steps, seed, targets=np.asarray(tg),
                   draws=draws, device="cpu")
    assert draws.remaining == 0
    assert _rel(got, want) <= REL, (got, want)


@pytest.mark.parametrize("f,spread", [(4, 0.2), (0, 0.8)])
def test_breakdown_cell_matches_the_reference(f, spread):
    steps = 30
    want = JBD._run(13, f, spread=spread, steps=steps)
    tg = jax.random.normal(jax.random.PRNGKey(1), (13, BD.D)) * spread + 1.0
    draws = ref_draws(0, steps, BD.D, _cfg(13, f, 0.1, False))
    got = BD._run(13, f, spread, steps=steps, targets=np.asarray(tg),
                  draws=draws, device="cpu")
    assert draws.remaining == 0
    assert _rel(got, want) <= REL, (got, want)


# ----------------------------------------------------------------------- #
# fig1's protocol: comm_cost_to_tau on the CNN
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("tau", [0.85, 0.3])
def test_comm_cost_to_tau_matches_the_reference(tau):
    """At 0.85 neither reaches tau in 41 rounds; at 0.3 both cross at the
    record of round 20."""
    kw = dict(ratio=0.05, f=1, n_honest=3, per_worker=60, steps=41, tau=tau)
    want = JC.comm_cost_to_tau(**kw)
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_cnn_init(jax.random.PRNGKey(0))))
    cfg = T1.cell_config("rosdhb", 0.05, 0.05, 4, 1)
    draws = ref_draws(0, 41, 11958, cfg)
    got = C.comm_cost_to_tau(**kw, params0=params, draws=draws, device="cpu")
    assert draws.remaining == 0
    assert set(got) == set(want)
    for k in ("ratio", "f", "gamma", "rounds", "comm_bytes_to_tau"):
        assert got[k] == want[k], k
    assert abs(got["final_acc"] - want["final_acc"]) <= 2 / 500
    assert (got["rounds"], got["comm_bytes_to_tau"] < float("inf")) == \
        ((41, False) if tau == 0.85 else (21, True))


# ----------------------------------------------------------------------- #
# the launches each row states: the rules' kernels times the calls
# ----------------------------------------------------------------------- #

KERNEL_RULES = [("mean", False, True), ("cwtm", False, True),
                ("median", False, True), ("geomed", False, True),
                ("krum", False, True), ("multikrum", False, True),
                ("cwtm", True, True), ("median", True, True),
                ("mean", True, True), ("cwtm", True, False)]


@pytest.mark.parametrize("name,pre_nnm,use_kernels", KERNEL_RULES)
def test_kernel_launches_count_the_aggregators_kernel_calls(
        monkeypatch, name, pre_nnm, use_kernels):
    """``kernel_launches`` states, for the card, the calls that
    ``make_aggregator``'s rule makes of the kernel ops (counted here on
    the CPU, where the same ops run their plain versions); none on the
    CPU."""
    from repro_torch.core import AggregatorConfig, make_aggregator
    from repro_torch.core import aggregators as A
    calls = {"pairdist": 0, "cwtm": 0, "median": 0}

    def counted(kernel, fn):
        def op(*a, **kw):
            calls[kernel] += 1
            return fn(*a, **kw)
        return op

    for kernel, attr in (("pairdist", "pairdist"), ("cwtm", "cwtm_op"),
                         ("median", "median_op")):
        monkeypatch.setattr(A, attr, counted(kernel, getattr(A, attr)))
    cfg = AggregatorConfig(name=name, f=2, pre_nnm=pre_nnm,
                           use_kernels=use_kernels)
    agg = make_aggregator(cfg, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(9, 40)).astype(np.float32))
    for _ in range(3):
        agg(x)
    assert C.kernel_launches(cfg, 3, "cpu") == {}
    monkeypatch.setattr(C, "resolve_device", torch.device)
    assert C.kernel_launches(cfg, 3, "cuda") == \
        {k: v for k, v in calls.items() if v}


def test_protocol_constants_are_the_references():
    assert C.TAU == JC.TAU and C.GAMMA_BY_RATIO == JC.GAMMA_BY_RATIO


# ----------------------------------------------------------------------- #
# names and CSV lines
# ----------------------------------------------------------------------- #


def _lines(out):
    return [l for l in out.splitlines() if not l.startswith("#")]


def _fake_cost(**kw):
    r, f = kw["ratio"], kw["f"]
    hit = not (r < 1.0 and f == 5)
    return {"ratio": r, "f": f, "gamma": JC.GAMMA_BY_RATIO.get(r, 0.05),
            "comm_bytes_to_tau": (1234567.0 * r * (f + 1) if hit
                                  else float("inf")),
            "final_acc": 0.5 + r / 4, "rounds": 61 if hit else 400}


@pytest.mark.parametrize("full", [False, True])
def test_fig1_lines_equal_the_references(full, monkeypatch, capsys,
                                         tmp_path):
    """The same protocol numbers give the same CSV lines (timings aside),
    ``saving=`` column included, and rows in the port's own file."""
    monkeypatch.setattr(JF1, "comm_cost_to_tau", _fake_cost)
    JF1.run(full=full)
    want = _lines(capsys.readouterr().out)
    monkeypatch.setattr(F1, "comm_cost_to_tau", _fake_cost)
    out = tmp_path / "fig1.json"
    rows = F1.run(full=full, out=str(out), device="cpu")
    got = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == (30 if full else 4)
    for g, w in zip(got, want):
        gn, _, gd = g.split(",", 2)
        wn, _, wd = w.split(",", 2)
        assert (gn, gd) == (wn, wd)
    saved = json.loads(out.read_text())
    assert [s["rounds"] for s in saved] == [r["rounds"] for r in rows]
    assert {s["device"] for s in saved} == {"cpu"}
    assert F1.out_path(full).name == ("fig1_torch_full.json" if full
                                      else "fig1_torch_quick.json")


def test_sweep_studies_lines_equal_the_references(monkeypatch, capsys):
    """global_vs_local and breakdown: the same distances give the same CSV
    lines (timings aside), advantage and heterogeneity ratios included."""
    for ref, port, name in ((JGL, GL, "_dist"), (JBD, BD, "_run")):
        vals = iter([0.2, 0.3, 0.25, 0.4, 0.21, 0.33] * 6)
        monkeypatch.setattr(ref, name, lambda *a, **kw: next(vals))
        ref.run()
        want = _lines(capsys.readouterr().out)
        vals2 = iter([0.2, 0.3, 0.25, 0.4, 0.21, 0.33] * 6)
        monkeypatch.setattr(port, name, lambda *a, **kw: next(vals2))
        port.run(device="cpu")
        got = _lines(capsys.readouterr().out)
        assert [(g.split(",")[0], g.split(",", 2)[2]) for g in got] == \
            [(w.split(",")[0], w.split(",", 2)[2]) for w in want]


def test_aggregator_lines_equal_the_references(capsys):
    JAG.run(d=2000)
    want = _lines(capsys.readouterr().out)
    rows = AG.run(d=2000, device="cpu")
    got = _lines(capsys.readouterr().out)
    assert [g.split(",")[0] for g in got] == [w.split(",")[0] for w in want]
    assert [re.sub(r"GB/s=[0-9.]+ ", "", g.split(",", 2)[2]) for g in got] \
        == [re.sub(r"GB/s=[0-9.]+ ", "", w.split(",", 2)[2]) for w in want]
    assert [r["launches"] for r in rows] == [{}] * 6


def test_table1_names_are_the_references(monkeypatch, capsys):
    monkeypatch.setattr(JT1, "STEPS", 2)
    JT1.run()
    want = _lines(capsys.readouterr().out)
    _, rows = T1.table1_rows(2, device="cpu")
    assert [r["name"] for r in rows] == [w.split(",")[0] for w in want]
    assert all(r["derived"] == f"dist_sq={r['dist_sq']:.4g}" for r in rows)


def test_run_harness_lists_the_references_suites(monkeypatch, capsys,
                                                 tmp_path):
    source = (ROOT / "benchmarks" / "run.py").read_text()
    assert RUN.SUITES == SUITES
    assert all(f'"{s}":' in source for s in SUITES)
    # every suite is ported: sweep runs as one (cut to 4 rounds here; its
    # gates are tests/test_torch_bench_sweep.py's)
    from benchmarks import bench_torch_sweep as SWP
    monkeypatch.chdir(tmp_path)
    sweep = SWP.run
    monkeypatch.setattr(SWP, "run", lambda device=None: sweep(
        device=device, steps=4, cost_model_out=None))
    assert RUN.main(["--only", "sweep", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "# --- sweep ---" in out and "not yet ported" not in out
    assert "sweep/cross_algo_chosen_plan," in out
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [
        "BENCH_torch_sweep.json"]
    with pytest.raises(SystemExit):
        RUN.main(["--only", "table2", "--device", "cpu"])
    monkeypatch.setattr(BD, "_run", lambda *a, **kw: 0.5)
    res = RUN.run(only="breakdown", device="cpu")
    assert list(res) == ["breakdown"] and len(res["breakdown"]["rows"]) == 9
    assert res["breakdown"]["wall_s"] >= 0.0


def test_table1_ordering_holds_on_the_ports_own_draws(capsys):
    """The full bench at its 800 rounds on the CPU, assert included."""
    rows = T1.run(device="cpu")
    assert [r["rounds"] for r in rows] == [800] * 5
    d = {r["name"].split("/")[1]: r["dist_sq"] for r in rows}
    assert d["rosdhb"] <= 2 * d["rosdhb-local"]
    assert d["dgd"] == max(d.values())
