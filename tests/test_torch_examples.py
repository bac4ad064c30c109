"""The port's examples (``examples/*_torch.py``): one smallest-size run each
on the CPU (``--device cpu``), with what each prints or returns held."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_both_parts(capsys):
    rows = example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: converged to the honest optimum" in out
    assert "8 scenarios -> 1 programs" in out
    assert len(rows) == 16 and "OK: one bank reproduced" in out


@pytest.mark.parametrize("argv", [["--steps", "2"],
                                  ["--steps", "2", "--seeds", "2", "--f",
                                   "1", "--local-masks"]])
def test_paper_mnist_runs_one_seed_and_lanes(argv, capsys):
    res = example("paper_mnist_torch").main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    if "--seeds" in argv:
        assert res["loss"].shape == (2, 2) and res["acc"].shape == (2,)
        assert np.isfinite(res["loss"]).all()
        assert "2-seed sweep, one rollout of 2 rounds" in out
    else:
        # eval records at round 0 and the last round
        assert res["step"] == [0, 1] and len(res["acc"]) == 2
        assert "did not reach tau within the step budget" in out


def test_llm_example_trains_the_reduced_model(capsys):
    losses = example("llm_rosdhb_train_torch").train(
        ["--steps", "2", "--seq", "16", "--batch", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "arch=qwen25_3b(reduced)" in out and "n_workers=8 f=2" in out
    # 10% of the 1,312,768 flat parameters in 128-wide blocks, per worker
    assert "uplink=131277 floats/worker" in out


@pytest.mark.parametrize("arch", ["zamba2_7b", "llama32_vision_11b"])
def test_serve_demo_decodes_as_the_launcher(arch, capsys):
    """The demo's greedy tokens are ``launch.serve``'s on the same reduced
    model, parameters and prompt."""
    from repro_torch.launch import serve
    gen = example("serve_demo_torch").main(["--arch", arch, "--tokens", "8",
                                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert gen.shape == (4, 8) and "decoded 7 steps x 4 seqs" in out
    want = serve.run(["--arch", arch, "--device", "cpu"], log=lambda m: None)
    assert torch.equal(torch.as_tensor(gen), want["tokens"])
