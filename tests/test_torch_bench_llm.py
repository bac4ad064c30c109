"""``benchmarks/bench_torch_llm.py`` against the reference's
``bench_llm``: its constants, its sections and their JSON keys (the
reference's committed ``results/BENCH_llm.json``), its deterministic gates
at tiny sizes on the CPU (streamed rollouts bitwise the materialised ones,
streamed grid rows equal, the host budget refused by ``stack_batches`` and
kept by the stream, the early exit), and that it writes its own file and
no other. The wall-clock gate runs on the card only."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_llm as J  # noqa: E402
from benchmarks import bench_torch_llm as B  # noqa: E402

CONSTANTS = ("CNN_WORKERS", "CNN_F", "CNN_ROUNDS", "EE_N", "EE_F", "EE_D",
             "EE_STEPS", "EE_CHUNK", "TF_STEPS", "TF_CHUNK", "TF_DEPTH",
             "TF_BUDGET")
# the CPU cut: one 8-round chunk of the CNN streams; 16 steps of a 1-layer,
# d_model 64 stablelm_3b (3 chunks of 4 in flight, 96 KiB) against a
# budget the 128 KiB schedule exceeds
TINY = dict(cnn_rounds=8, per_worker=40, tf_steps=16, tf_budget=112 * 1024,
            tf_layers=1, tf_d_model=64, ee_steps=96)


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow these CPU rounds down ~25x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _covers(got, want, label=""):
    """Every key of the reference's record is in the port's, two levels
    down (sections, then their cells or fields)."""
    assert set(want) <= set(got), (label, set(want) - set(got))
    for k, v in want.items():
        if isinstance(v, dict) and isinstance(got[k], dict) and label == "":
            _covers(got[k], v, k)


def test_constants_are_the_references():
    assert {c: getattr(B, c) for c in CONSTANTS} == {
        c: getattr(J, c) for c in CONSTANTS}
    assert B.EARLY_EXIT_SLACK == 1.05
    assert "1.05" in (ROOT / "benchmarks" / "bench_llm.py").read_text()


def test_bench_on_the_cpu_holds_its_gates_and_writes_only_its_file(
        monkeypatch, tmp_path, capsys, one_thread):
    monkeypatch.chdir(tmp_path)
    res = B.run(device="cpu", **TINY)
    out = tmp_path / "results" / "BENCH_torch_llm.json"
    assert [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
            if p.is_file()] == [out.relative_to(tmp_path)]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    ref = json.loads((ROOT / "results" / "BENCH_llm.json").read_text())
    assert list(res) == list(ref)
    _covers(res, ref)
    par = res["parity_gate"]
    assert par["max_abs_diff"] == 0.0 and par["execute_plan_rows_equal"]
    for key in ("rosdhb/alie", "robust_dgd/signflip", "dgd/alie"):
        assert par[key]["exact"] and par[key]["rounds"] == TINY["cnn_rounds"]
        assert par[key]["dispatches"] == 1  # the 8-round chunk streamed
    mem = res["host_memory"]
    assert mem["stack_batches_raised"] and mem["steps"] == TINY["tf_steps"]
    assert mem["materialised_est_bytes"] > mem["budget_bytes"] \
        >= mem["stream_high_water_bytes"] > 0
    ee = res["early_exit"]
    assert ee["rounds_at_exit"] < ee["steps"] == TINY["ee_steps"]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines if ln.startswith("llm/")] == [
        "llm/parity/rosdhb/alie", "llm/parity/robust_dgd/signflip",
        "llm/parity/dgd/alie", "llm/parity/execute_plan",
        "llm/host_memory/stack_refused", "llm/host_memory/stream",
        "llm/early_exit"]


def test_a_failed_gate_still_leaves_the_sections_before_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.chdir(tmp_path)

    def broken(*a, **k):
        raise AssertionError("gate")

    monkeypatch.setattr(B, "_early_exit_gate", broken)
    monkeypatch.setattr(B, "_host_memory_gate", lambda *a: {"steps": 0})
    monkeypatch.setattr(B, "_parity_gate", lambda *a: {"max_abs_diff": 0.0})
    try:
        B.run(device="cpu")
    except AssertionError:
        pass
    got = json.loads((tmp_path / "results" /
                      "BENCH_torch_llm.json").read_text())
    assert got == {"parity_gate": {"max_abs_diff": 0.0},
                   "host_memory": {"steps": 0}}
