"""``benchmarks/bench_torch_serve.py`` against the reference's
``bench_serve``: its constants, its sections and their JSON keys (the
reference's committed ``results/BENCH_serve.json``), its deterministic
gates at tiny sizes on the CPU (the served trajectory bitwise
``Simulator.rollout``'s on the replayed draws, one step built across
participation levels, every quorum's rounds served), and that it writes
its own file and no other."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_serve as J  # noqa: E402
from benchmarks import bench_torch_serve as B  # noqa: E402

CONSTANTS = ("D", "PARITY_ROUNDS", "THROUGHPUT_ROUNDS", "N_HONEST", "F")
TINY = dict(parity_rounds=6, compile_rounds=6, throughput_rounds=10)


def _covers(got, want, label=""):
    assert set(want) <= set(got), (label, set(want) - set(got))
    for k, v in want.items():
        if isinstance(v, dict) and isinstance(got[k], dict) and label == "":
            _covers(got[k], v, k)


def test_constants_and_cells_are_the_references():
    assert {c: getattr(B, c) for c in CONSTANTS} == {
        c: getattr(J, c) for c in CONSTANTS}
    jc, c = J._cfg(), B._cfg()
    assert (c.n_workers, c.f, c.aggregator.name, c.aggregator.pre_nnm,
            c.attack.name) == (jc.n_workers, jc.f, jc.aggregator.name,
                               jc.aggregator.pre_nnm, jc.attack.name)


def test_bench_on_the_cpu_holds_its_gates_and_writes_only_its_file(
        monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    res = B.run(device="cpu", **TINY)
    out = tmp_path / "results" / "BENCH_torch_serve.json"
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [out]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    ref = json.loads((ROOT / "results" / "BENCH_serve.json").read_text())
    assert list(res) == list(ref)
    _covers(res, ref)
    for cell, rec in res["parity_gate"].items():
        assert rec["exact"] and rec["max_abs_diff"] == 0.0, cell
        assert rec["step_traces"] == 1 and rec["rounds"] == 6
        assert set(ref["parity_gate"][cell]) <= set(rec)
    one = res["one_compile"]
    assert one["step_traces"] == 1 and len(one["participation_histogram"]) > 1
    for q in ("quorum13", "quorum11", "quorum7"):
        assert set(ref["throughput"][q]) <= set(res["throughput"][q])
        assert res["throughput"][q]["step_traces"] == 1
        assert res["throughput"][q]["rounds"] >= 10


@pytest.mark.parametrize("agg,pre,kernels", [
    ("cwtm", True, ("pairdist", "cwtm")), ("median", True,
                                           ("pairdist", "median")),
    ("cwtm", False, ("cwtm",)), ("geomed", True, ("pairdist",))])
def test_launch_rule_of_a_fired_round(agg, pre, kernels):
    import dataclasses
    cfg = B._cfg()
    cfg = dataclasses.replace(cfg, aggregator=dataclasses.replace(
        cfg.aggregator, name=agg, pre_nnm=pre))
    assert B.served_kernels(cfg) == kernels
    zero = {"pairdist": 0, "cwtm": 0, "median": 0}
    B.check_launches("cpu", zero, 7, cfg, torch.device("cpu"))
    want = {k: (7 if k in kernels else 0) for k in zero}
    B.check_launches("card", want, 7, cfg, torch.device("cuda"))
    with pytest.raises(AssertionError):
        B.check_launches("card", zero, 7, cfg, torch.device("cuda"))
