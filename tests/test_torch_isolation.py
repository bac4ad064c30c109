"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points run on the card unless the caller asks for the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import algorithms as JAlg
from repro_torch import device as dev_mod
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import simulator as S
from repro_torch.core import testbeds as TB
from repro_torch.kernels import cwtm, median, pairdist


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len(mods), bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20
    assert out[1].strip() == "[]"


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(p) for p in files if FORBIDDEN.search(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x\n")
    assert FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not FORBIDDEN.search("from repro_torch.core import x\n")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Alg.AlgorithmConfig(name="rosdhb", n_workers=5, f=1,
                              aggregator=G.AggregatorConfig("cwtm", f=1,
                                                            pre_nnm=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dev_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.make_aggregator(cfg.aggregator)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Alg.init_state(cfg, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.quadratic_testbed(5, d=8)
    loss, params0, batch_fn, _ = TB.quadratic_testbed(5, d=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.Simulator(loss, params0, cfg)
    sim = S.Simulator(loss, params0, cfg, device="cpu")
    state, m = sim.rollout(sim.init(0), batch_fn, steps=2)
    assert state.params_flat.device.type == "cpu"
    assert m["loss"].shape == (2,)
    x = torch.randn(2, 5, 8)
    assert pairdist.pairdist(x).shape == (2, 5, 5)
    assert cwtm.cwtm(x, 1).shape == median.median(x).shape == (2, 8)


def test_llm_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    """The LLM path's entry points (train step builder, launcher) default to
    the card; the launcher's CPU rehearsal runs the plain versions."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    spec = get_arch("stablelm_3b")
    plan = S.make_train_plan(spec, InputShape("t", 16, 8, "train"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.build_train_step(plan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.run(["--arch", "stablelm_3b", "--steps", "1"])
    with pytest.raises(KeyError, match="unknown arch"):
        TR.run(["--arch", "no_such_arch", "--device", "cpu", "--stream"])
    out = []
    res = TR.run(["--arch", "stablelm_3b", "--steps", "2", "--f", "1",
                  "--device", "cpu"], log=out.append)
    assert res["plan"].flat_spec.padded_size == 1_313_280
    assert len(res["losses"]) == 2 and out[0].startswith("[train] stablelm")
    assert res["state"].params["embed"].device.type == "cpu"


def test_serve_entry_point_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """``python -m repro_torch.launch.serve`` defaults to the card and
    raises without CUDA; ``--device cpu`` serves the reduced model."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(["--arch", "llama32_vision_11b"])
    with pytest.raises(KeyError, match="unknown arch"):
        serve.run(["--arch", "no_such_arch", "--device", "cpu"])
    out = []
    res = serve.run(["--arch", "llama32_vision_11b", "--device", "cpu",
                     "--batch", "1", "--prompt-len", "4", "--tokens", "2"],
                    log=out.append)
    assert res["tokens"].shape == (1, 2) and out[0].startswith("[serve]")
    assert res["params"]["embed"].device.type == "cpu"


def test_rosdhb_state_is_a_third_of_dasha():
    for d in (11958, 1048576):
        kw = dict(n_workers=13, f=3)
        r = Alg.server_state_bytes(Alg.AlgorithmConfig(name="rosdhb", **kw), d)
        da = Alg.server_state_bytes(Alg.AlgorithmConfig(name="dasha", **kw), d)
        assert 3 * r == da
        assert r == JAlg.server_state_bytes(
            JAlg.AlgorithmConfig(name="rosdhb", **kw), d) == 13 * d * 4


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No ``ok`` line without a card, nor from a lone copy of the script."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        if not torch.cuda.is_available():
            env["CUDA_VISIBLE_DEVICES"] = ""
        p = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        if torch.cuda.is_available() and script != lone:
            continue  # on a card the repository's copy is expected to pass
        assert p.returncode != 0
        assert '"ok"' not in p.stdout


@pytest.mark.parametrize("module", ["repro_torch.core.sweep",
                                    "repro_torch.adversary.core",
                                    "repro_torch.adversary.registry"])
def test_grid_modules_import_neither_jax_nor_repro(module):
    """The grid engine, the adversaries and the scenario registry keep their
    own copies of what they need from the reference (a fresh interpreter
    that imports only the module)."""
    code = (f"import sys, {module}\n"
            "print(sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_grid_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.core import sweep as SW
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SW.main(["--scenario", "table1-mini", "--steps", "1", "--seeds",
                 "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.make_aggregator_bank(G.AggregatorConfig(name="bank", f=1))
    rows = SW.main(["--scenario", "table1-mini", "--steps", "1", "--seeds",
                    "1", "--device", "cpu"])
    assert len(rows) == 8


BENCHES = sorted((ROOT / "benchmarks").glob("bench_torch_*.py"))
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
BENCH_IMPORT = re.compile(
    r"^\s*(?:from\s+benchmarks(?:\.(\w+))?\s+import\s+\(?([\w\s,]+)\)?"
    r"|import\s+benchmarks\.(\w+))", re.MULTILINE)


def test_benches_and_examples_import_neither_jax_nor_repro():
    """The port's paper benches and examples: no ``jax``, no ``repro``, and
    of ``benchmarks`` only the port's own ``bench_torch_*`` modules (not the
    reference's ``common.py``), in the source and in a fresh interpreter
    that imports them all."""
    assert len(BENCHES) >= 8 and len(EXAMPLES) == 4
    for p in BENCHES + EXAMPLES:
        text = p.read_text()
        assert not FORBIDDEN.search(text), p
        for sub, names, mod in BENCH_IMPORT.findall(text):
            used = [sub or mod] if (sub or mod) else [
                n.strip() for n in names.replace("\n", " ").split(",")]
            assert all(u.startswith("bench_torch_") for u in used), (p, used)
    code = (
        "import importlib, importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        f"for m in {[p.stem for p in BENCHES]!r}:\n"
        "    importlib.import_module('benchmarks.' + m)\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    s = importlib.util.spec_from_file_location('ex', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(sorted(k for k in sys.modules if k in ('jax', 'repro', "
        "'benchmarks.common') or k.startswith(('jax.', 'repro.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def _paper_entry_points():
    sys.path.insert(0, str(ROOT))
    import importlib.util
    from benchmarks import (bench_torch_aggregators, bench_torch_breakdown,
                            bench_torch_common, bench_torch_fig1,
                            bench_torch_global_vs_local,
                            bench_torch_momentum, bench_torch_run,
                            bench_torch_table1)
    points = {
        "fig1": bench_torch_fig1.run,
        "table1": bench_torch_table1.run,
        "momentum": bench_torch_momentum.run,
        "global_vs_local": bench_torch_global_vs_local.run,
        "breakdown": bench_torch_breakdown.run,
        "aggregators": bench_torch_aggregators.run,
        "comm_cost_to_tau": lambda: bench_torch_common.comm_cost_to_tau(
            ratio=0.05, f=0),
        "time_fn": lambda: bench_torch_common.time_fn(lambda: None),
        "bench_torch_run": lambda: bench_torch_run.main(["--only",
                                                         "table1"]),
    }
    for p in EXAMPLES:
        spec = importlib.util.spec_from_file_location(p.stem, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        points[p.stem] = lambda mod=mod: mod.main([])
    return points


@pytest.mark.parametrize("name", [
    "fig1", "table1", "momentum", "global_vs_local", "breakdown",
    "aggregators", "comm_cost_to_tau", "time_fn", "bench_torch_run",
    "llm_rosdhb_train_torch", "paper_mnist_torch", "quickstart_torch",
    "serve_demo_torch"])
def test_paper_entry_points_need_cuda_unless_asked_for_cpu(name,
                                                          monkeypatch):
    """Every bench and example runs on the card by default and refuses to
    run without one (``--device cpu`` / ``device="cpu"`` is the CPU path,
    which ``tests/test_torch_paper.py`` and ``test_torch_examples.py``
    run)."""
    points = _paper_entry_points()
    assert set(points) == {
        "fig1", "table1", "momentum", "global_vs_local", "breakdown",
        "aggregators", "comm_cost_to_tau", "time_fn", "bench_torch_run",
        *(p.stem for p in EXAMPLES)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        points[name]()


@pytest.mark.parametrize("module", ["repro_torch.launch.roofline",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.optim",
                                    "repro_torch.utils.dtypes",
                                    "repro_torch.sharding",
                                    "repro_torch.sharding.partitioning",
                                    "repro_torch.sharding.flatten"])
def test_roofline_dryrun_and_optim_import_neither_jax_nor_repro(module):
    """The roofline, the dry run, the optimizers, the float8 cast and the
    sharded layout (its copy of the reference's rule table) keep their own
    copies of what they need from the reference."""
    code = (f"import sys, {module}\n"
            "print(sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_kernel_bench_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """``bench_torch_kernels`` runs on the card by default and refuses to
    run without one; the dry run reckons on ``meta`` tensors, on any
    host."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_torch_kernels, bench_torch_run
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch_kernels.run(out=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch_run.main(["--only", "kernels"])
    rep = dryrun.run_one("gemma_2b", "long_500k", n_layers=1, verbose=False)
    assert rep["ok"] and rep["roofline"]["hardware"] == "h100"


@pytest.mark.parametrize("name", ["llm", "serve", "chaos", "sweep"])
def test_the_four_benches_stand_alone_and_need_cuda_unless_asked_for_cpu(
        name, monkeypatch):
    """``bench_torch_{llm,serve,chaos,sweep}``: among the benches the
    import checks above read, importing neither JAX nor the reference
    (nor its ``benchmarks.common``) in a fresh interpreter, and refusing to
    run without a card unless given ``device="cpu"``."""
    assert ROOT / "benchmarks" / f"bench_torch_{name}.py" in BENCHES
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            f"import benchmarks.bench_torch_{name}\n"
            "print(sorted(k for k in sys.modules if k in ('jax', 'repro', "
            "'benchmarks.common') or k.startswith(('jax.', 'repro.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"
    sys.path.insert(0, str(ROOT))
    import importlib
    mod = importlib.import_module(f"benchmarks.bench_torch_{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(out=None)
