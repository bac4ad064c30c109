"""``benchmarks/bench_torch_sweep.py`` against the reference's
``bench_sweep``: its constants, its sections and their JSON keys (the
reference's committed ``results/BENCH_sweep.json``; the one-device
``sharded`` record of its source), its deterministic gates at tiny sizes
on the CPU (one program a grid, every cell against its per-scenario
rollout, the crossings of the fused and sequential engines, the
cross-algorithm bank against the per-algorithm partition), the launch rule
that stands for the reference's compile counts, and that it writes its own
two files (the bench's JSON and the port's cost model), never the
reference's. ``tests/test_torch_paper.py`` runs it as a suite of
``bench_torch_run``."""

import json
import sys
from pathlib import Path

import pytest

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_sweep as J  # noqa: E402
from benchmarks import bench_torch_sweep as B  # noqa: E402
from repro_torch.core import CostModel  # noqa: E402
from repro_torch.core.sweep import grid_scenarios, plan_grid  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow these small CPU rounds down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONSTANTS = ("D", "STEPS", "EVAL_EVERY", "TAU_LOSS", "SEEDS", "ATTACKS",
             "GRID_ATTACKS", "GRID_AGGS", "STATEFUL_ATTACKS", "CROSS_ALGOS",
             "CROSS_ATTACKS", "CROSS_AGGS")
STEPS = 24
# the reference's sharded section on one device (bench_sweep.py, the
# n_dev < 2 branch of _sharded_grid)
ONE_DEVICE_SHARDED = {"n_devices", "single_warm_s", "sharded_warm_s"}


def test_constants_are_the_references():
    assert {c: getattr(B, c) for c in CONSTANTS} == {
        c: getattr(J, c) for c in CONSTANTS}
    src = (ROOT / "benchmarks" / "bench_sweep.py").read_text()
    assert B.FUSION_FLOOR == 1.2 and "speedup >= 1.2" in src
    assert B.CHOSEN_SLACK == 1.25 and "best_warm * 1.25" in src


def test_bench_on_the_cpu_holds_its_gates_and_writes_only_its_files(
        monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    res = B.run(device="cpu", steps=STEPS)
    out = tmp_path / "results" / "BENCH_torch_sweep.json"
    cm = tmp_path / "results" / "COST_MODEL_torch.json"
    assert sorted(p for p in tmp_path.rglob("*") if p.is_file()) == [
        out, cm]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    CostModel.load(str(cm))
    ref = json.loads((ROOT / "results" / "BENCH_sweep.json").read_text())
    assert list(res) == list(ref)
    for name, keys in ref.items():
        want = ONE_DEVICE_SHARDED if name == "sharded" else set(keys)
        assert want <= set(res[name]), (name, want - set(res[name]))
    for name, cells in (("grid_one_program", 15), ("stateful_grid", 18)):
        rec = res[name]
        assert rec["bank_compiles"] == 1 and rec["n_cells"] == cells
        assert rec["per_scenario_compiles"] == cells
        assert rec["bank_launches"] == {"pairdist": 0, "cwtm": 0,
                                        "median": 0}
    cross = res["cross_algo_grid"]
    assert (cross["bank_compiles"], cross["per_algo_compiles"]) == (1, 4)
    assert cross["chosen"] in ("fused", "partitioned")
    assert len(cross["gate_chosen_s"]) == len(cross["gate_best_s"]) == \
        B.GATE_TURNS
    assert cross["chosen_over_best"] == B.chosen_over_best(
        cross["gate_chosen_s"], cross["gate_best_s"])
    assert res["sharded"]["n_devices"] == 1 and res["sharded"]["skipped"]
    assert len(res["attack_fusion"]["crossings"]) == len(B.ATTACKS)


def test_chosen_plan_gate_reads_the_median_ratio_of_its_turns():
    """The chosen-plan gate's arithmetic on given readings: the median over
    the turns of the chosen plan's seconds over the best static plan's in
    the same turn. Drift of the host that slows both plans in a turn
    cancels in its ratio; one slow turn of either plan moves the median no
    further than the next turn; a chosen plan 1.3x slower in every turn
    still fails the 1.25x slack."""
    assert B.CHOSEN_SLACK == 1.25 and B.GATE_TURNS == 5
    assert B.chosen_over_best([2.0, 4.0, 1.0], [2.0, 4.0, 1.0]) == 1.0
    assert B.chosen_over_best([1.0, 9.0, 1.1, 1.0, 1.05],
                              [1.0] * 5) == pytest.approx(1.05)
    assert B.chosen_over_best([1.0] * 5, [1.0, 0.1, 1.0, 0.95, 1.0]) == \
        pytest.approx(1.0)
    assert B.chosen_over_best([1.3, 1.4], [1.0, 1.0]) == pytest.approx(1.35)
    assert B.chosen_over_best([1.3] * 5, [1.0] * 5) > B.CHOSEN_SLACK
    for chosen, best in (([1.0], []), ([], [])):
        with pytest.raises(ValueError):
            B.chosen_over_best(chosen, best)


def test_the_launch_rule_counts_each_kernel_once_a_round_per_bank():
    """The bank's kernels: NNM's pairdist, CWTM and the median once a round
    whatever its lanes; geomed and dgd's mean launch nothing; a lone
    scenario its own rule's."""
    bank = plan_grid(grid_scenarios(["rosdhb"], B.GRID_ATTACKS, B.GRID_AGGS,
                                    n_honest=10, f=3)).banks[0]
    assert B.bank_kernels(bank) == ("pairdist", "cwtm", "median")
    cross = plan_grid(grid_scenarios(B.CROSS_ALGOS, B.CROSS_ATTACKS,
                                     ("cwtm",), n_honest=10, f=3)).banks[0]
    assert B.bank_kernels(cross) == ("pairdist", "cwtm")
    geo = grid_scenarios(["rosdhb"], ["alie"], ["geomed"], n_honest=10, f=3,
                         pre_nnm=False)[0].cfg
    assert B.round_kernels(geo) == ()
    dgd = grid_scenarios(["dgd"], ["alie"], ["cwtm"], n_honest=10, f=3)[0]
    assert B.round_kernels(dgd.cfg) == ()
    assert B.expected_launches(("cwtm",), 5, torch.device("cuda")) == {
        "pairdist": 0, "cwtm": 5, "median": 0}
    assert B.expected_launches(("cwtm",), 5, torch.device("cpu")) == {
        "pairdist": 0, "cwtm": 0, "median": 0}
