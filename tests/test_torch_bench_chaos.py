"""``benchmarks/bench_torch_chaos.py`` against the reference's
``bench_chaos``: its constants, its sections and their JSON keys (the
reference's committed ``results/BENCH_chaos.json``), its gates at tiny
sizes on the CPU (loopback and TCP bitwise the in-process server, every
registered scenario terminating with one step a server instance, the
kill-restart bitwise, the combined scenario's loss within rtol 0.1), and
that it writes its own file and no other."""

import json
import socket
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_chaos as J  # noqa: E402
from benchmarks import bench_torch_chaos as B  # noqa: E402
from repro_torch.serve import CHAOS_REGISTRY  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow these small CPU rounds down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONSTANTS = ("D", "PARITY_ROUNDS", "CHAOS_ROUNDS", "N_HONEST", "F",
             "LOSS_RTOL")
TINY = dict(parity_rounds=5, chaos_rounds=10)


def _covers(got, want, label=""):
    assert set(want) <= set(got), (label, set(want) - set(got))
    for k, v in want.items():
        if isinstance(v, dict) and isinstance(got[k], dict) and label == "":
            _covers(got[k], v, k)


def test_constants_are_the_references():
    assert {c: getattr(B, c) for c in CONSTANTS} == {
        c: getattr(J, c) for c in CONSTANTS}


def test_bench_on_the_cpu_holds_its_gates_and_writes_only_its_file(
        monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    res = B.run(device="cpu", **TINY)
    out = tmp_path / "results" / "BENCH_torch_chaos.json"
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [out]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    ref = json.loads((ROOT / "results" / "BENCH_chaos.json").read_text())
    assert list(res) == list(ref)
    _covers(res, ref)
    for cell, rec in res["loopback_parity"].items():
        assert rec["exact"] and rec["step_traces"] == [1], cell
    matrix = res["chaos_matrix"]
    assert set(matrix) == set(CHAOS_REGISTRY)
    for name, rec in matrix.items():
        assert rec["all_rounds_terminated"], name
        assert all(t == 1 for t in rec["step_traces"]), name
        assert set(ref["chaos_matrix"][name]) <= set(rec), name
    assert matrix["kill-restart"]["bitwise_vs_fault_free"] == 0.0
    assert matrix["combined"]["restarts"] == 1
    assert matrix["combined"]["loss_vs_fault_free_rtol"] <= B.LOSS_RTOL
    tcp = res["tcp_parity"]
    assert tcp.get("skipped") or all(r["exact"] for r in tcp.values())


def test_tcp_parity_is_recorded_as_skipped_where_sockets_are_forbidden(
        monkeypatch):
    class NoSockets:
        def __init__(self, *a, **k):
            raise PermissionError("sockets forbidden")

    monkeypatch.setattr(socket, "socket", NoSockets)
    assert B._tcp_parity(None) == {"skipped": True,
                                   "reason": "sockets forbidden"}
