#!/usr/bin/env python3
"""The streamed rollout pipeline of the PyTorch port (counterpart of
``benchmarks/bench_llm.py``).

Three gated sections, written to ``results/BENCH_torch_llm.json`` after
each one:

  parity_gate      CNN grid, ONE shared pre-stacked batch array feeding
                   both paths: ``rollout_streaming`` must reproduce
                   ``rollout`` bit for bit (max_abs_diff == 0.0 on params
                   and every per-round metric), and a streamed
                   ``execute_plan`` must return identical result rows.
  host_memory      reduced stablelm_3b through the launch path
                   (``make_train_plan`` + ``build_chunked_train_step``):
                   materialising the batch schedule under the host budget
                   must RAISE (``stack_batches``'s guard) while the
                   ``ChunkPrefetcher`` run completes the same schedule with
                   high_water_bytes <= budget.
  early_exit       warmed wall-clock: a tau-crossing streaming run against
                   the fixed-length streaming run of the same trajectory;
                   it must exit early, and on the card be no slower than
                   the fixed run x 1.05 (a wall-clock gate: on the card
                   only).

Everything runs on the card unless ``--device cpu``. The named arguments
of :func:`run` cut the sections' sizes; the defaults are the reference's::

    python3 benchmarks/bench_torch_llm.py [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.bench_torch_common import emit, run_sections  # noqa: E402
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,  # noqa: E402
                              AttackConfig, Simulator, SparsifierConfig,
                              stack_batches)
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.device import (DeviceLike, resolve_device,  # noqa: E402
                                synchronize)

OUT = "results/BENCH_torch_llm.json"

# CNN parity grid (kept small: the gate is exactness, not scale)
CNN_WORKERS, CNN_F, CNN_ROUNDS = 9, 2, 24
# quadratic early-exit timing
EE_N, EE_F, EE_D, EE_STEPS, EE_CHUNK = 13, 3, 256, 384, 32
# transformer memory gate
TF_STEPS, TF_CHUNK, TF_DEPTH = 48, 4, 2
TF_BUDGET = 128 * 1024  # host bytes the materialised schedule must exceed
#: The early-exit run's allowance over the fixed run (wall clock).
EARLY_EXIT_SLACK = 1.05


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _parity_gate(dev: torch.device, rounds: int = CNN_ROUNDS,
                 per_worker: int = 200) -> dict:
    """Streaming == materialised on the MNIST-CNN grid, bit for bit."""
    from repro_torch.data import SyntheticMNIST
    from repro_torch.models import cnn_init, cnn_loss

    # the card's convolutions are bitwise repeatable only when cuDNN is
    # held to its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    ds = SyntheticMNIST(n_workers=CNN_WORKERS, per_worker=per_worker, seed=0)
    params0 = cnn_init(0)
    # ONE pre-stacked array shared by both paths (the batch function is
    # stateful, so the stream must not re-pull from it)
    batches = stack_batches(ds.worker_batches(32), rounds)
    out = {}
    worst = 0.0
    for algo, attack in (("rosdhb", "alie"), ("robust_dgd", "signflip"),
                         ("dgd", "alie")):
        agg = "mean" if algo == "dgd" else "cwtm"
        cfg = AlgorithmConfig(
            name=algo, n_workers=CNN_WORKERS, f=CNN_F, gamma=0.05, beta=0.9,
            sparsifier=SparsifierConfig(
                kind="randk", ratio=1.0 if algo == "robust_dgd" else 0.1),
            aggregator=AggregatorConfig(name=agg, f=CNN_F,
                                        pre_nnm=(agg != "mean")),
            attack=AttackConfig(name=attack,
                                z=1.5 if attack == "alie" else None))
        sim = Simulator(cnn_loss, params0, cfg, device=dev)
        st_ref, ms_ref = sim.rollout(sim.init(0), batches)
        st_s, ms_s, info = sim.rollout_streaming(
            sim.init(0), batches, chunk_size=8, prefetch_depth=2)
        diff = _max_abs_diff(st_s.params_flat, st_ref.params_flat)
        mdiff = max(_max_abs_diff(ms_s[k], ms_ref[k]) for k in ms_ref)
        worst = max(worst, diff, mdiff)
        key = f"{algo}/{attack}"
        out[key] = {"rounds": info["rounds_run"], "max_abs_diff": diff,
                    "metric_max_abs_diff": mdiff, "exact": diff == 0.0,
                    "dispatches": info["dispatches"]}
        emit(f"llm/parity/{key}", 0.0,
             f"max_abs_diff={diff} dispatches={info['dispatches']}")
        assert diff == 0.0 and mdiff == 0.0, \
            f"streaming parity broken for {key}: {diff} / {mdiff}"

    # the fused grid path must stream to the same rows
    scen = SW.grid_scenarios(["rosdhb", "dgd"], ["alie"], ["cwtm"],
                             n_honest=CNN_WORKERS - CNN_F, f=CNN_F, ratio=0.1)
    plan = SW.plan_grid(scen)
    ref_rows = SW.execute_plan(plan, loss_fn=cnn_loss, params0=params0,
                               batches=batches, seeds=[0], shard=False,
                               device=dev)
    got_rows = SW.execute_plan(plan, loss_fn=cnn_loss, params0=params0,
                               batches=batches, seeds=[0], shard=False,
                               device=dev, streaming=True,
                               stream_chunk_size=8, prefetch_depth=2)
    rows_equal = ref_rows == got_rows
    emit("llm/parity/execute_plan", 0.0, f"rows_equal={rows_equal}")
    assert rows_equal, "streamed execute_plan rows differ"
    out["execute_plan_rows_equal"] = rows_equal
    out["max_abs_diff"] = worst
    return out


def _host_memory_gate(dev: torch.device, steps: int = TF_STEPS,
                      budget: int = TF_BUDGET, n_layers: int = 2,
                      d_model: int = 256) -> dict:
    """Reduced stablelm_3b via the launch path: the O(steps) materialisation
    refuses the budget, the stream completes under it."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchSpec, InputShape
    from repro_torch.core import algorithms as alg
    from repro_torch.data import ChunkPrefetcher
    from repro_torch.launch.steps import (TrainState,
                                          build_chunked_train_step,
                                          make_train_plan)
    from repro_torch.models import model_init
    from repro_torch.testing import TorchDraws

    spec = get_arch("stablelm_3b")
    spec = ArchSpec(model=spec.model.reduced(n_layers=n_layers,
                                             d_model=d_model)
                    .with_overrides(vocab_size=512),
                    citation=spec.citation)
    shape = InputShape("host_train", 128, 16, "train")
    overrides = {
        "name": "rosdhb", "gamma": 1e-3, "f": 2,
        "sparsifier": SparsifierConfig(kind="block", ratio=0.05,
                                       block_size=512),
        "aggregator": AggregatorConfig(name="cwtm", f=2),
        "attack": AttackConfig(name="alie"),
    }
    plan = make_train_plan(spec, shape, overrides, n_workers=8)
    cfg = plan.model
    lb = shape.global_batch // plan.n_workers

    def batch_fn(t):
        gen = np.random.default_rng((0, int(t)))
        toks = gen.integers(0, cfg.vocab_size,
                            (plan.n_workers, lb, shape.seq_len))
        toks[..., 1::2] = (toks[..., 0::2] + 1) % cfg.vocab_size
        return {"tokens": np.asarray(toks, np.int32)}

    # the materialised path must refuse this budget...
    try:
        stack_batches(batch_fn, steps, max_bytes=budget)
        raised = False
    except ValueError as e:
        raised = True
        assert "rollout_streaming" in str(e)
    est_bytes = steps * int(sum(
        np.asarray(v).nbytes for v in batch_fn(0).values()))
    emit("llm/host_memory/stack_refused", 0.0,
         f"raised={raised} est={est_bytes} budget={budget}")
    assert raised, (
        f"stack_batches fit {est_bytes} B under {budget} B — grow "
        "the steps so the materialised schedule exceeds the budget")

    # ...while the stream finishes the SAME schedule inside it
    state = TrainState(
        params=model_init(cfg, torch.Generator(device=dev).manual_seed(0)),
        server=alg.init_state(plan.algo, plan.bank_width, device=dev),
        step=0, draws=TorchDraws(1, dev))
    chunk_step = build_chunked_train_step(plan, TF_CHUNK, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    steps_run = 0
    with ChunkPrefetcher(batch_fn, steps, TF_CHUNK, TF_DEPTH,
                         device=dev) as pf:
        while True:
            chunks = pf.take(1)
            if not chunks:
                break
            state, metrics = chunk_step(state, chunks[0])
            steps_run += TF_CHUNK
        synchronize(dev)
        high_water = pf.high_water_bytes
        chunk_bytes = pf.chunk_bytes
    elapsed = time.perf_counter() - t0
    final_loss = float(metrics["loss"][-1])

    rounds_per_s = steps_run / elapsed
    emit("llm/host_memory/stream", elapsed * 1e6 / steps_run,
         f"high_water={high_water} budget={budget} "
         f"rounds/s={rounds_per_s:.2f} loss={final_loss:.3f}")
    assert steps_run == steps
    assert 0 < high_water <= budget, \
        f"stream breached the host budget: {high_water} > {budget}"
    assert np.isfinite(final_loss)
    return {
        "model": cfg.name, "d": int(plan.flat_spec.padded_size),
        "n_workers": plan.n_workers, "steps": steps_run,
        "chunk_size": TF_CHUNK, "prefetch_depth": TF_DEPTH,
        "materialised_est_bytes": est_bytes, "budget_bytes": budget,
        "stack_batches_raised": raised,
        "stream_high_water_bytes": int(high_water),
        "chunk_bytes": int(chunk_bytes),
        "rounds_per_sec": rounds_per_s, "final_loss": final_loss,
    }


def _early_exit_gate(dev: torch.device, steps: int = EE_STEPS) -> dict:
    """tau-crossing streaming run vs fixed-length streaming run, warmed."""
    loss_fn, params0, batch_fn, _ = SW.quadratic_testbed(EE_N, EE_D,
                                                         device=dev)
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=EE_N, f=EE_F, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.2),
        aggregator=AggregatorConfig(name="cwtm", f=EE_F, pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5))
    sim = Simulator(loss_fn, params0, cfg, device=dev)
    batches = stack_batches(batch_fn, steps)
    _, ms_ref = sim.rollout(sim.init(0), batches)
    loss_ref = ms_ref["loss"].cpu().numpy()
    tau = float(loss_ref[steps // 4])  # crossed a quarter of the way in

    def run(tau_):
        synchronize(dev)
        t0 = time.perf_counter()
        _, _, info = sim.rollout_streaming(
            sim.init(0), batches, chunk_size=EE_CHUNK, prefetch_depth=4,
            tau=tau_, tau_metric="loss", tau_mode="<=")
        synchronize(dev)
        return time.perf_counter() - t0, info

    run(tau)          # warm both paths
    run(None)
    t_early = min(run(tau)[0] for _ in range(3))
    t_full = min(run(None)[0] for _ in range(3))
    _, info = run(tau)
    speedup = t_full / t_early
    emit("llm/early_exit", t_early * 1e6,
         f"rounds={info['rounds_run']}/{steps} "
         f"full={t_full * 1e6:.0f}us speedup={speedup:.2f}x")
    assert info["early_exit"] and info["rounds_run"] < steps
    if dev.type == "cuda":
        assert t_early <= t_full * EARLY_EXIT_SLACK, (
            f"early exit slower than fixed length: {t_early:.4f}s vs "
            f"{t_full:.4f}s")
    return {
        "steps": steps, "chunk_size": EE_CHUNK, "tau": tau,
        "rounds_at_exit": info["rounds_run"],
        "early_s": t_early, "full_s": t_full, "speedup": speedup,
    }


def run(out: Optional[str] = OUT, device: DeviceLike = None, *,
        cnn_rounds: int = CNN_ROUNDS, per_worker: int = 200,
        tf_steps: int = TF_STEPS, tf_budget: int = TF_BUDGET,
        tf_layers: int = 2, tf_d_model: int = 256,
        ee_steps: int = EE_STEPS) -> dict:
    """The three sections on ``device`` (default the card), the JSON
    rewritten to ``out`` after each. ``cnn_rounds``, ``per_worker``,
    ``tf_steps`` (with ``tf_budget``, which the schedule must exceed),
    ``tf_layers`` and ``tf_d_model`` (the reduced stablelm_3b's) and
    ``ee_steps`` cut the sections; the defaults are the reference's."""
    dev = resolve_device(device)
    torch.zeros(1, device=dev)  # backend init outside all timings
    det = torch.backends.cudnn.deterministic  # the parity gate sets it
    try:
        return run_sections((
            ("parity_gate", lambda: _parity_gate(dev, cnn_rounds,
                                                 per_worker)),
            ("host_memory", lambda: _host_memory_gate(
                dev, tf_steps, tf_budget, tf_layers, tf_d_model)),
            ("early_exit", lambda: _early_exit_gate(dev, ee_steps)),
        ), out)
    finally:
        torch.backends.cudnn.deterministic = det


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    run(out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
