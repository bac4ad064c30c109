"""The steps' abstract inputs and the dry run of the port: the meta specs
of ``launch.steps`` against the reference's ``ShapeDtypeStruct`` specs on
a one-device CPU mesh (shapes and dtypes, leaf by leaf), with the bank
widening to whole Block-RandK blocks held exactly; ``dryrun.run_one`` at
one layer of a dense, an MoE, an SSM and a vlm arch; the CLI."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.launch import steps as JS
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.utils.tree import tree_leaves

# one layer, or one group where a family repeats a pattern
LAYERS = {"llama32_vision_11b": 5, "zamba2_7b": 6}


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _specs(arch):
    n_layers = LAYERS.get(arch, 1)
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.model.with_overrides(
        n_layers=n_layers))
    jspec = jget_arch(arch)
    jspec = dataclasses.replace(jspec, model=jspec.model.with_overrides(
        n_layers=n_layers))
    return spec, jspec


def _same(port, ref):
    """Leaf by leaf (the reference's leaf order), shapes and dtypes."""
    pl = [t for t in tree_leaves(port) if t is not None]
    rl = jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(r.shape)
        assert str(p.dtype).replace("torch.", "") == str(r.dtype)


def _block(cls, ratio=0.05):
    return cls.SparsifierConfig(kind="block", ratio=ratio, block_size=512)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_specs_are_the_references_with_whole_blocks(arch):
    """The train step's state and batch: the reference's, except the banks'
    width, the flat width rounded up to whole 512-wide blocks."""
    spec, jspec = _specs(arch)
    shape, jshape = INPUT_SHAPES["train_4k"], J_SHAPES["train_4k"]
    mesh = _mesh()
    for algo, attack, mdt in (("rosdhb", "alie", "bfloat16"),
                              ("dasha", "mimic", "float8_e4m3fn")):
        ov = {"name": algo, "momentum_dtype": mdt}
        plan = S.make_train_plan(spec, shape, dict(
            ov, sparsifier=_block(C), attack=A.AttackConfig(name=attack)),
            n_workers=8)
        jplan = JS.make_train_plan(jspec, jshape, mesh, dict(
            ov, sparsifier=_block(JC), attack=JA.AttackConfig(name=attack)),
            n_workers=8)
        state, batch = S.train_input_specs(plan)
        jstate, jbatch = JS.train_input_specs(jplan, mesh)
        _same(state.params, jstate.params)
        _same(batch, jbatch)
        d = jplan.flat_spec.padded_size
        assert plan.flat_spec.padded_size == d
        assert plan.bank_width == -(-d // 512) * 512
        srv, jsrv = state.server, jstate.server
        for slot in ("momentum", "mirror", "prev_grad"):
            p, r = getattr(srv, slot), getattr(jsrv, slot)
            assert (p is None) == (r is None)
            if p is not None:
                assert tuple(p.shape) == (r.shape[0], plan.bank_width)
                assert r.shape[1] == d
                assert str(p.dtype).replace("torch.", "") == str(r.dtype)
        if attack == "mimic":
            for p, r in zip(srv.attack, jsrv.attack):
                wide = r.shape == (d,)
                assert tuple(p.shape) == ((plan.bank_width,) if wide
                                          else tuple(r.shape))
                assert str(p.dtype).replace("torch.", "") == str(r.dtype)
        else:
            assert srv.attack is None and jsrv.attack is None
        assert state.step.dtype == torch.int32 and state.step.shape == ()
        _same(S.stream_batch_specs(plan, 4),
              JS.stream_batch_specs(jplan, mesh, 4))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serve_specs_are_the_references(arch, shape):
    spec, jspec = _specs(arch)
    got = S.serve_input_specs(spec, INPUT_SHAPES[shape])
    want = JS.serve_input_specs(jspec, J_SHAPES[shape], _mesh())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("arch", ["stablelm_3b", "dbrx_132b", "mamba2_1_3b",
                                  "llama32_vision_11b"])
def test_run_one_at_one_layer(arch):
    """The report's keys, the server round counted from shapes, and traced
    FLOPs no smaller than the matmul FLOPs of the shapes: the model's
    matrices (every parameter but the embedding table and the norms) times
    two a token forward and six a token in training."""
    n_layers = LAYERS.get(arch, 1)
    r = D.run_one(arch, "train_4k", n_layers=n_layers, ratio=0.05,
                  verbose=False)
    keys = {"arch", "shape", "mesh", "kind", "ok", "n_params",
            "n_params_active", "n_elements", "bank_bytes", "state_bytes",
            "state_bytes_total", "held_bytes", "state_fits",
            "model_flops", "step_flops",
            "eager_bytes", "counted", "model_counted", "roofline",
            "bank_width", "payload_route"}
    assert keys <= set(r) and r["ok"] and r["mesh"] == "1xH100"
    assert r["counted"] == "shapes" and r["model_counted"] == "traced"
    assert r["eager_bytes"]["label"] == "eager, unfused"
    assert r["payload_route"]
    assert set(r["server_pieces"]) == {"ravel", "compress", "attack",
                                       "momentum", "aggregation", "update"}
    cfg = S.make_train_plan(
        dataclasses.replace(get_arch(arch), model=get_arch(
            arch).model.with_overrides(n_layers=n_layers)),
        INPUT_SHAPES["train_4k"], n_workers=8).model
    tokens = 256 * 4096
    matrices = r["n_params"] - (cfg.vocab_size * cfg.d_model
                                if cfg.input_kind == "tokens" else 0)
    if cfg.family == "moe":  # the tokens each reach top_k experts
        matrices = r["n_params_active"] - cfg.vocab_size * cfg.d_model
    assert r["step_flops"]["model"] >= 6 * matrices * tokens
    sb = r["state_bytes"]
    assert sb["params"] == 4 * r["n_elements"]
    assert sb["working_copy"] == 2 * r["n_elements"]
    assert sb["banks"] == r["bank_bytes"] == 8 * r["bank_width"] * 2
    assert r["held_bytes"] == sb["params"] + sb["banks"] + sb["attack"]
    assert r["state_fits"] == (r["state_bytes_total"] <= 80e9)
    assert r["roofline"]["hardware"] == "h100"
    assert r["roofline"]["collective_s"] == 0.0
    s = D.run_one(arch, "decode_32k", n_layers=n_layers, verbose=False)
    assert s["kind"] == "decode" and s["state_bytes"]["caches"] > 0
    assert s["step_flops"]["server"] == 0.0
    assert s["step_flops"]["model"] >= 2 * (s["n_params_active"] - (
        cfg.vocab_size * cfg.d_model if cfg.input_kind == "tokens"
        else 0)) * 128


@pytest.mark.parametrize("mdt", ["float32", "float8_e4m3fn"])
def test_server_round_counts_are_the_kernels_work(mdt):
    """The payload route's kernel pieces are ``roofline``'s counts of the
    kernels' work, the counts their bounds on the card take."""
    plan = S.make_train_plan(
        dataclasses.replace(get_arch("gemma_2b"), model=get_arch(
            "gemma_2b").model.with_overrides(n_layers=1)),
        INPUT_SHAPES["train_4k"], {"momentum_dtype": mdt, "sparsifier":
                                   C.SparsifierConfig(kind="block",
                                                      ratio=0.05,
                                                      block_size=512)})
    pieces = D.server_counts(plan)["pieces"]
    n, d = plan.n_workers, plan.bank_width
    kb = max(1, round(0.05 * (d // 512)))
    w = 4 if mdt == "float32" else 1
    want = {"compress": R.compress_work(n, kb, 512, w, kb),
            "momentum": R.momentum_work(n, d, kb, 512, w, w, kb, w != 4),
            "aggregation": R.sorted_weight_work(1, n, d, 4)}
    for name, (nbytes, ops) in want.items():
        assert pieces[name] == {"bytes": float(nbytes), "flops": float(ops)}


def test_cli_writes_the_reports(tmp_path):
    out = tmp_path / "d.json"
    D.main(["--arch", "qwen25_3b", "--shape", "long_500k", "--n-layers",
            "1", "--momentum-dtype", "float8_e4m3fn", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["hardware"] == "h100" and len(rep["reports"]) == 1
    assert rep["reports"][0]["ok"]
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen25_3b", "--shape", "long_500k",
                "--server-compute-dtype", "float8_e4m3fn"])
