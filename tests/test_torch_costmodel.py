"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's ``repro.core.costmodel``: the same fit from the same probe
times (within 1e-12), the same fuse-or-partition decision from the same
JSON over a grid of (cells, seeds, rounds), save/load round trips, the
plan ``plan_grid(cost_model=...)`` makes, and a calibration run on the
CPU."""

import dataclasses
import json

import numpy as np
import pytest

from repro.adversary import registry as JR
from repro.core import costmodel as JCM
from repro.core import sweep as JS
from repro_torch.adversary import registry as R
from repro_torch.core import costmodel as CM
from repro_torch.core import sweep as S

PROBES = [
    dict(single_cold_s=1.7, single_warm_s=0.3, single_rows=24,
         fused_cold_s=2.9, fused_warm_s=1.1, fused_rows=84, branches=4,
         rounds=300),
    dict(single_cold_s=0.02, single_warm_s=0.019, single_rows=6,
         fused_cold_s=0.05, fused_warm_s=0.04, fused_rows=21, branches=4,
         rounds=100),
    # a warm run faster than its own first call on the other side: clamps
    dict(single_cold_s=0.5, single_warm_s=0.6, single_rows=8,
         fused_cold_s=0.4, fused_warm_s=0.1, fused_rows=16, branches=2,
         rounds=10),
]


def _pair(**fields):
    return JCM.CostModel(**fields), CM.CostModel(**fields)


@pytest.mark.parametrize("probe", PROBES)
def test_fit_is_the_references(probe):
    want = dataclasses.asdict(JCM.CostModel.fit(**probe, source="x"))
    got = dataclasses.asdict(CM.CostModel.fit(**probe, source="x"))
    # the port's one term of its own, 0 without the small probe
    assert got.pop("bank_round_us") == 0.0
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-12 * max(1.0, abs(v)), k
        else:
            assert got[k] == v, k
    with pytest.raises(ValueError, match="branches"):
        CM.CostModel.fit(**{**probe, "branches": 1})


@pytest.mark.parametrize("bank_us,row_us,branch_us", [
    (4000.0, 2.0, 5.0), (4000.0, 0.0, 0.0), (10.0, 120.0, 100.0)])
def test_fit_with_the_small_probe_gives_back_its_rates(bank_us, row_us,
                                                       branch_us):
    """Probe times made from known rates (a round of one bank costs
    ``bank_us`` whatever its rows, plus ``row_us`` a row, plus
    ``branch_us`` a row for each branch past the first): the fit gives the
    rates back, and the per-algorithm partition of the Table-1 grid is
    priced at its banks' real sum."""
    rounds, branches = 300, 4

    def warm(rows, nb=1):
        return rounds * 1e-6 * (bank_us + rows * (row_us + branch_us
                                                  * (nb - 1)))

    m = CM.CostModel.fit(single_cold_s=warm(24) + 0.1,
                         single_warm_s=warm(24), single_rows=24,
                         small_warm_s=warm(6), small_rows=6,
                         fused_cold_s=warm(84, branches) + 0.2,
                         fused_warm_s=warm(84, branches), fused_rows=84,
                         branches=branches, rounds=rounds)
    for got, want in ((m.bank_round_us, bank_us), (m.cell_round_us, row_us),
                      (m.cell_round_us_per_branch, branch_us)):
        assert abs(got - want) <= 1e-9 * max(1.0, want)
    cells = {"rosdhb": 6, "dasha": 6, "robust_dgd": 6, "dgd": 3}
    np.testing.assert_allclose(
        m.partitioned_s(cells, 4, rounds) - 4 * m.compile_s
        - m.compile_s_per_branch * 4,
        sum(warm(c * 4) for c in cells.values()), rtol=1e-9)
    np.testing.assert_allclose(
        m.fused_s(cells, 4, rounds) - m.compile_s
        - m.compile_s_per_branch * branches, warm(84, branches), rtol=1e-9)
    # a host-bound round (rows free) fuses: one bank's round, not four
    if row_us == 0.0:
        assert m.prefer_fused(cells, 4, rounds)
    with pytest.raises(ValueError, match="small_rows"):
        CM.CostModel.fit(single_cold_s=1.0, single_warm_s=1.0,
                         single_rows=24, small_warm_s=0.5, small_rows=24,
                         fused_cold_s=1.0, fused_warm_s=1.0, fused_rows=84,
                         branches=4, rounds=10)


MODELS = [dataclasses.asdict(JCM.DEFAULT_COST_MODEL),
          dict(compile_s=0.01, compile_s_per_branch=0.0, cell_round_us=40.0,
               cell_round_us_per_branch=25.0, source="b"),
          dict(compile_s=3.0, compile_s_per_branch=1.0, cell_round_us=5.0,
               cell_round_us_per_branch=0.5,
               sharded_compile_overhead_s=2.0, source="c")]


@pytest.mark.parametrize("fields", MODELS)
def test_decisions_are_the_references(fields):
    jm, m = _pair(**fields)
    for cells in ({"rosdhb": 6, "dasha": 6}, {"rosdhb": 6, "dasha": 6,
                                              "robust_dgd": 6, "dgd": 3},
                  {"rosdhb": 1, "dgd": 40}):
        for seeds in (1, 4, 32):
            for rounds in (1, 50, 300, 5000):
                for sharded in (False, True):
                    kw = dict(sharded=sharded)
                    assert m.prefer_fused(cells, seeds, rounds, **kw) == \
                        jm.prefer_fused(cells, seeds, rounds, **kw)
                    np.testing.assert_allclose(
                        m.fused_s(cells, seeds, rounds, **kw),
                        jm.fused_s(cells, seeds, rounds, **kw), rtol=1e-12)
    with pytest.raises(ValueError, match="branches"):
        m.program_s(branches=0, rows=1, rounds=1)


def test_save_load_round_trip(tmp_path):
    m = CM.CostModel(**MODELS[2])
    path = str(tmp_path / "sub" / "model.json")
    assert m.save(path) == path
    assert CM.CostModel.load(path) == m
    # the reference reads the file less the port's own term
    with open(path) as fh:
        raw = json.load(fh)
    assert raw.pop("bank_round_us") == 0.0
    with open(path, "w") as fh:
        json.dump(raw, fh)
    assert JCM.CostModel.load(path) == JCM.CostModel(**MODELS[2])
    assert CM.CostModel.load(path) == m
    assert CM.CostModel.load_or_default(str(tmp_path / "missing.json")) \
        is CM.DEFAULT_COST_MODEL
    with open(path, "w") as fh:
        json.dump({**MODELS[1], "rate": 1.0}, fh)
    with pytest.raises(ValueError, match="unknown cost-model keys"):
        CM.CostModel.load(path)


def test_the_ports_file_is_its_own():
    """The port reads and writes ``results/COST_MODEL_torch.json``, never
    the reference's file; the committed fit loads and names the card it
    was measured on."""
    assert CM.DEFAULT_PATH == "results/COST_MODEL_torch.json"
    assert CM.DEFAULT_PATH != JCM.DEFAULT_PATH
    m = CM.CostModel.load_or_default()
    assert m == CM.CostModel.load(CM.DEFAULT_PATH)
    assert "NVIDIA" in m.source
    assert min(m.compile_s, m.compile_s_per_branch, m.cell_round_us,
               m.cell_round_us_per_branch) >= 0.0


def _plan_view(plan):
    return ([[sc.label for sc in b.scenarios] for b in plan.banks],
            [b.cfg.bank for b in plan.banks],
            [sc.label for sc in plan.singles], list(plan.notes))


@pytest.mark.parametrize("fields", MODELS)
@pytest.mark.parametrize("name,seeds,rounds", [
    ("table1", 4, 300), ("table1", 1, 10), ("table1-mini", 2, 3000),
    ("stateful-core", 4, 300)])
def test_plan_with_a_cost_model_is_the_references(fields, name, seeds,
                                                  rounds):
    jm, m = _pair(**fields)
    plan = S.plan_grid(R.expand_scenario(name), cost_model=m, rounds=rounds,
                       n_seeds=seeds)
    jplan = JS.plan_grid(JR.expand_scenario(name), cost_model=jm,
                         rounds=rounds, n_seeds=seeds)
    assert _plan_view(plan) == _plan_view(jplan)
    assert plan.describe() == jplan.describe()
    with pytest.raises(ValueError, match="rounds"):
        S.plan_grid(R.expand_scenario(name), cost_model=m)


def test_calibrate_fits_a_model_on_the_cpu():
    model, probes = CM.calibrate(d=16, steps=3, seeds=(0, 1), repeats=1,
                                 device="cpu", source="cpu rehearsal")
    assert model.source == "cpu rehearsal"
    assert probes["single_rows"] == 12 and probes["fused_rows"] == 42
    assert probes["small_rows"] == 6 and probes["small_warm_s"] > 0
    assert probes["branches"] == 4 and probes["rounds"] == 3
    assert model == CM.CostModel.fit(**probes, source="cpu rehearsal")
    with pytest.raises(ValueError, match="two seeds"):
        CM.calibrate(d=16, steps=1, seeds=(0,), device="cpu")
