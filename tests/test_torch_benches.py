"""The port's kernel and roofline benches on the CPU at tiny shapes:
``bench_torch_kernels`` (its rows, its parity gate, its output file and
only that one) against the reference's rows and shapes, and
``bench_torch_roofline`` over a dry run's JSON; both through
``bench_torch_run``."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_kernels as JK  # noqa: E402
from benchmarks import bench_torch_kernels as K  # noqa: E402
from benchmarks import bench_torch_roofline as RL  # noqa: E402
from benchmarks import bench_torch_run as RUN  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

TINY = (("table1", 6, 13, 3, 64, 2), ("cnn", 2, 13, 3, 300, 2))
REF_ROW = {"shape", "backend", "jnp_us", "dispatch_us", "speedup_vs_jnp",
           "bytes_moved", "achieved_gb_s", "roofline_floor_us",
           "roofline_bottleneck", "floor_ratio", "dispatch_parity_rel",
           "parity_ok", "gated"}


def test_shapes_and_rules_are_the_references():
    assert K.SHAPES == JK.SHAPES and K.RULES == JK.RULES


def test_kernels_bench_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "k.json"
    res = K.run(out=str(out), device="cpu", shapes=TINY, micro=(1 << 14,
                                                                 64))
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert sorted(tmp_path.iterdir()) == [out]
    assert res["card"] == "cpu" and res["hardware"] == "cpu"
    rows = res["aggregation"]
    assert list(rows) == [f"{n}{'+nnm' if p else ''}/{s[0]}" for s in TINY
                          for n, p in K.RULES]
    for row in rows.values():
        assert set(row) == REF_ROW
        assert row["parity_ok"] and row["dispatch_parity_rel"] <= 1e-5
        assert not row["gated"] and row["roofline_bottleneck"] == "memory"
    assert res["gates"] == {"ok": True, "failures": [], "perf_gated": False}
    assert res["randk_compress_ref_us"] > 0 and res["attention_ref_us"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("kernels/cwtm/table1,")
    assert any(line.startswith("kernels/randk_compress_ref/") for line in
               lines)


def test_kernels_bench_never_writes_the_references_files(monkeypatch,
                                                         tmp_path):
    monkeypatch.chdir(tmp_path)
    K.run(device="cpu", shapes=TINY[:1], micro=(1 << 12, 32))
    assert (tmp_path / "results" / "BENCH_torch_kernels.json").exists()
    assert sorted(p.name for p in tmp_path.rglob("*.json")) == [
        "BENCH_torch_kernels.json"]


def test_roofline_bench_prints_the_dry_run(tmp_path, capsys):
    path = tmp_path / "dry.json"
    D.main(["--arch", "gemma_2b", "--n-layers", "1", "--out", str(path)])
    capsys.readouterr()
    ok = RL.run(str(path), markdown=True)
    out = capsys.readouterr().out.splitlines()
    assert len(ok) == 4 and out[0].startswith("| arch | shape | mesh |")
    assert all("| 1xH100 |" in line for line in out[2:])
    RL.run(str(path))
    out = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in out] == [
        f"roofline/gemma_2b/{s}/1xH100" for s in
        ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    assert RL.run(str(tmp_path / "missing.json")) is None


def test_run_harness_runs_kernels_and_roofline(monkeypatch, capsys):
    monkeypatch.setattr(K, "SHAPES", TINY[:1])
    monkeypatch.setattr(K, "OUT", None)
    monkeypatch.setattr(K, "legacy_micro", lambda results, dev: results)
    orig = K.run
    monkeypatch.setattr(K, "run", lambda device=None: orig(
        out=None, device=device, shapes=TINY[:1]))
    res = RUN.run(only="kernels", device="cpu")
    assert list(res["kernels"]["rows"]["aggregation"]) == [
        f"{n}{'+nnm' if p else ''}/table1" for n, p in K.RULES]
    res = RUN.run(only="roofline", device="cpu")
    assert "roofline" in res
    assert "# --- roofline ---" in capsys.readouterr().out
