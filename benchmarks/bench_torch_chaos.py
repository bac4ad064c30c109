#!/usr/bin/env python3
"""The fault-injected serving stack of the PyTorch port
(``repro_torch.serve.chaos``; counterpart of ``benchmarks/bench_chaos.py``).

Three gated sections, written to ``results/BENCH_torch_chaos.json`` after
each one:

  loopback_parity  fault-free chaos over the loopback transport vs the
                   in-process server on the serve bench's parity cells: the
                   framed byte path (encode -> CRC -> decode) must be
                   bit-for-bit invisible (max_abs_diff == 0.0), and each
                   server must build its step exactly once.
  chaos_matrix     every registered chaos scenario at n=13, f=3 Byzantine
                   (ALIE vs CWTM+NNM). Gates: every driven round
                   terminates, no unresolved liveness-watchdog fires,
                   step_traces == 1 per server instance (restarts
                   included), kill-restart resumes bit-for-bit, and the
                   combined-fault scenario lands its final honest loss
                   within rtol 0.1 of the fault-free run.
  tcp_parity       fault-free chaos over real TCP sockets: the same bitwise
                   parity gate; skipped (recorded, not failed) where the
                   sandbox forbids sockets.

Everything runs on the card unless ``--device cpu``. The named arguments
of :func:`run` cut the sections' sizes; the defaults are the reference's::

    python3 benchmarks/bench_torch_chaos.py [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Optional

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.bench_torch_common import emit, run_sections  # noqa: E402
from repro_torch.core.sweep import (grid_scenarios,  # noqa: E402
                                    quadratic_testbed)
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.serve import (CHAOS_REGISTRY,  # noqa: E402
                               ByzantineRobustServer, ClientPool,
                               ServeConfig, get_chaos, run_chaos,
                               run_service)
from repro_torch.utils import tree as T  # noqa: E402

OUT = "results/BENCH_torch_chaos.json"

D = 256
PARITY_ROUNDS = 30
CHAOS_ROUNDS = 30
N_HONEST, F = 10, 3
LOSS_RTOL = 0.1


def _cfg(algo="rosdhb", attack="alie", agg="cwtm", **kw):
    return grid_scenarios((algo,), (attack,), (agg,),
                          n_honest=N_HONEST, f=F, **kw)[0].cfg


def _honest_loss(flat, targets, spec, f):
    w = np.asarray(flat)[:spec.size]
    t = np.asarray(targets)[f:]
    return float(0.5 * np.mean(np.sum((w[None, :] - t) ** 2, axis=1)))


def _transport_parity(dev: torch.device, transport: str,
                      rounds: int = PARITY_ROUNDS) -> dict:
    """Fault-free chaos over ``transport`` vs the in-process server: the
    transport boundary must be bit-for-bit invisible."""
    out = {}
    chaos = dataclasses.replace(get_chaos("fault-free"),
                                transport=transport)
    for algo, attack, agg in (("rosdhb", "alie", "cwtm"),
                              ("rosdhb", "foe", "median"),
                              ("robust_dgd", "signflip", "cwtm")):
        cfg = _cfg(algo, attack, agg)
        loss_fn, params0, batch_fn, _ = quadratic_testbed(cfg.n_workers, d=D,
                                                          device=dev)
        server = ByzantineRobustServer(cfg, params0, ServeConfig(), seed=0,
                                       device=dev)
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, device=dev)
        run_service(server, pool, rounds)
        res = run_chaos(cfg, params0, batch_fn, loss_fn, chaos, rounds,
                        seed=0, device=dev)
        diff = float(np.max(np.abs(
            res.final_params - server.params_flat.cpu().numpy())))
        key = f"{algo}/{attack}/{agg}"
        out[key] = {"rounds": rounds, "max_abs_diff": diff,
                    "exact": diff == 0.0, "step_traces": res.step_traces}
        emit(f"chaos/parity/{transport}/{key}", 0.0,
             f"max_abs_diff={diff} traces={res.step_traces}")
        assert diff == 0.0, (
            f"{transport} transport parity broken for {key}: {diff}")
        assert res.step_traces == [1]
    return out


def _tcp_parity(dev: torch.device, rounds: int = PARITY_ROUNDS) -> dict:
    """Same gate over real sockets; a sandbox that forbids sockets gets a
    recorded skip, not a failure."""
    try:
        import socket
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            probe.bind(("127.0.0.1", 0))
        finally:
            probe.close()
    except OSError as e:
        emit("chaos/parity/tcp", 0.0, f"SKIPPED: {e}")
        return {"skipped": True, "reason": str(e)}
    return _transport_parity(dev, "tcp", rounds)


def _chaos_matrix(dev: torch.device, rounds: int = CHAOS_ROUNDS) -> dict:
    """Every registered scenario against the f=3-of-13 ALIE cell, with the
    combined-fault loss gate and the kill-restart bitwise gate."""
    cfg = _cfg()
    loss_fn, params0, batch_fn, targets = quadratic_testbed(cfg.n_workers,
                                                            d=D, device=dev)
    spec = T.make_flat_spec(params0)
    targets = targets.cpu().numpy()
    out = {}
    finals = {}
    base_loss = None
    for name in CHAOS_REGISTRY:
        res = run_chaos(cfg, params0, batch_fn, loss_fn, get_chaos(name),
                        rounds, seed=0, device=dev)
        loss = _honest_loss(res.final_params, targets, spec, F)
        finals[name] = res.final_params
        last = res.summaries[-1]
        rec = {
            "rounds_driven": res.rounds_driven,
            "rounds_applied": sum(s["rounds"] for s in res.summaries),
            "all_rounds_terminated": res.all_rounds_terminated(),
            "restarts": res.restarts,
            "step_traces": res.step_traces,
            "final_honest_loss": loss,
            "injected_faults": res.injected,
            "client_stats": res.client_stats,
            "ingest_decisions": last["ingest_decisions"],
            "quorum_histogram": last["quorum_histogram"],
            "quorum_transitions": last["quorum_transitions"],
            "watchdog": [s["watchdog"] for s in res.summaries],
            "fault_budget_events": [e for s in res.summaries
                                    for e in s["fault_budget_events"]],
            "updates_per_sec": last["updates_per_sec"],
            "latency_p50_ms": last["latency_p50_ms"],
            "latency_p99_ms": last["latency_p99_ms"],
        }
        if name == "fault-free":
            base_loss = loss
        elif base_loss is not None:
            rec["loss_vs_fault_free_rtol"] = (
                abs(loss - base_loss) / max(abs(base_loss), 1e-12))
        out[name] = rec
        emit(f"chaos/scenario/{name}", 0.0,
             f"loss={loss:.4f} restarts={res.restarts} "
             f"injected={sum(res.injected.values())} "
             f"traces={res.step_traces} "
             f"terminated={res.all_rounds_terminated()}")
        # liveness + single-step gates hold for EVERY scenario
        assert res.all_rounds_terminated(), (
            f"chaos scenario {name!r}: rounds failed to terminate "
            f"({len(res.results)}/{res.rounds_driven}, "
            f"{res.unresolved_watchdogs} unresolved watchdog fires)")
        assert all(t == 1 for t in res.step_traces), (
            f"chaos scenario {name!r} rebuilt the step: {res.step_traces}")

    # gate: the combined-fault scenario converges like the fault-free run
    combined = out["combined"]
    emit("chaos/gate/combined_loss", 0.0,
         f"loss={combined['final_honest_loss']:.4f} "
         f"fault_free={base_loss:.4f} "
         f"rtol={combined['loss_vs_fault_free_rtol']:.4f}")
    assert combined["loss_vs_fault_free_rtol"] <= LOSS_RTOL, (
        f"combined-fault loss {combined['final_honest_loss']} drifted "
        f"beyond rtol {LOSS_RTOL} of fault-free {base_loss}")
    assert combined["restarts"] == 1

    # gate: a mid-round crash + restore on a CLEAN transport is bitwise
    # invisible: the same final parameters as never having crashed
    kr_diff = float(np.max(np.abs(finals["kill-restart"]
                                  - finals["fault-free"])))
    out["kill-restart"]["bitwise_vs_fault_free"] = kr_diff
    emit("chaos/gate/kill_restart_bitwise", 0.0, f"max_abs_diff={kr_diff}")
    assert kr_diff == 0.0, (
        f"mid-round kill-and-restart diverged from the uncrashed "
        f"trajectory: max_abs_diff={kr_diff}")
    return out


def run(out: Optional[str] = OUT, device: DeviceLike = None, *,
        parity_rounds: int = PARITY_ROUNDS,
        chaos_rounds: int = CHAOS_ROUNDS) -> dict:
    """The three sections on ``device`` (default the card), the JSON
    rewritten to ``out`` after each. ``parity_rounds`` and
    ``chaos_rounds`` cut the sections; the defaults are the
    reference's."""
    dev = resolve_device(device)
    torch.zeros(1, device=dev)  # backend init outside all timings
    return run_sections((
        ("loopback_parity", lambda: _transport_parity(dev, "loopback",
                                                      parity_rounds)),
        ("chaos_matrix", lambda: _chaos_matrix(dev, chaos_rounds)),
        ("tcp_parity", lambda: _tcp_parity(dev, parity_rounds)),
    ), out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    run(out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
