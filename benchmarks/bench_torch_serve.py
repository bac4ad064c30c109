#!/usr/bin/env python3
"""The streaming Byzantine-robust parameter server of the PyTorch port
(counterpart of ``benchmarks/bench_serve.py``).

Three gated sections, written to ``results/BENCH_torch_serve.json`` after
each one:

  parity_gate   full participation + zero timeout: the served parameter
                trajectory must equal ``Simulator.rollout``'s bit for bit
                on the same per-round draws (the pool's draws, recorded and
                replayed into the simulator).
  one_compile   ONE server driven by full / dropping / late client pools:
                the server builds its aggregate-and-apply step exactly once
                across every participation level it sees
                (``step_traces == 1``), and on the card launches its
                kernels once a fired round.
  throughput    quorum sweep at n=13, f=3: sustained updates/sec and
                rounds/sec, p50/p99 round latency, participation and
                staleness histograms from ``ServeMetrics``.

Everything runs on the card unless ``--device cpu``. The named arguments
of :func:`run` cut the sections' sizes; the defaults are the reference's::

    python3 benchmarks/bench_torch_serve.py [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from benchmarks.bench_torch_common import (emit,  # noqa: E402
                                           launches_since, run_sections)
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import Simulator  # noqa: E402
from repro_torch.core.sweep import (grid_scenarios,  # noqa: E402
                                    quadratic_testbed)
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.serve import (ByzantineRobustServer,  # noqa: E402
                               ClientBehavior, ClientPool, ServeConfig,
                               ServeMetrics, run_service)
from repro_torch.testing import (RecordingDraws, ReplayDraws,  # noqa: E402
                                 SeedWordDraws)

OUT = "results/BENCH_torch_serve.json"

D = 256
PARITY_ROUNDS = 30
THROUGHPUT_ROUNDS = 120
N_HONEST, F = 10, 3


def _cfg(algo="rosdhb", attack="alie", agg="cwtm", **kw):
    return grid_scenarios((algo,), (attack,), (agg,),
                          n_honest=N_HONEST, f=F, **kw)[0].cfg


def served_kernels(cfg) -> tuple:
    """The kernels one fired round of ``cfg`` launches on the card: NNM's
    pairdist and the rule's own (CWTM or the median)."""
    agg = cfg.aggregator
    rule = (agg.name,) if agg.name in ("cwtm", "median") else ()
    return (("pairdist",) if agg.pre_nnm else ()) + rule


def check_launches(label: str, launches: dict, fired: int, cfg,
                   dev: torch.device) -> None:
    """One launch a fired round of each kernel of :func:`served_kernels`
    on the card, none off it."""
    kernels = served_kernels(cfg)
    want = {k: fired if dev.type == "cuda" and k in kernels else 0
            for k in ("pairdist", "cwtm", "median")}
    got = {k: launches[k] for k in want}
    assert got == want, f"{label}: launches {got}, expected {want}"


class _Recorder:
    """The pool's per-round draws from the announcements' seed words, kept
    to replay into ``Simulator.rollout``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rounds = []

    def __call__(self, ann):
        rec = RecordingDraws(SeedWordDraws(ann.mask_key, ann.atk_key,
                                           self.device))
        self.rounds.append(rec)
        return rec

    def replay(self) -> ReplayDraws:
        return ReplayDraws(
            self.device,
            permutations=[p for r in self.rounds for p in r.permutations],
            uniforms=[u for r in self.rounds for u in r.uniforms],
            normals=[z for r in self.rounds for z in r.normals])


def _parity_gate(dev: torch.device, rounds: int = PARITY_ROUNDS) -> dict:
    """Serve vs simulator, bit for bit, across algorithm/attack/aggregator
    variety."""
    out = {}
    for algo, attack, agg in (("rosdhb", "alie", "cwtm"),
                              ("rosdhb", "foe", "median"),
                              ("robust_dgd", "signflip", "cwtm")):
        cfg = _cfg(algo, attack, agg)
        loss_fn, params0, batch_fn, _ = quadratic_testbed(cfg.n_workers, d=D,
                                                          device=dev)
        rec = _Recorder(dev)
        server = ByzantineRobustServer(cfg, params0, ServeConfig(), seed=0,
                                       device=dev)
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, device=dev,
                          draws_for=rec)
        mark = K.launches()
        run_service(server, pool, rounds)
        launches = launches_since(mark)
        sim = Simulator(loss_fn, params0, cfg, device=dev)
        final, _ = sim.rollout(sim.init(draws=rec.replay()), batch_fn,
                               rounds)
        diff = float((final.params_flat - server.params_flat).abs().max())
        key = f"{algo}/{attack}/{agg}"
        out[key] = {"rounds": rounds, "max_abs_diff": diff,
                    "exact": diff == 0.0,
                    "step_traces": server.step_traces,
                    "launches": launches}
        emit(f"serve/parity/{key}", 0.0,
             f"max_abs_diff={diff} traces={server.step_traces}")
        assert diff == 0.0, f"serve/sim parity broken for {key}: {diff}"
        assert server.step_traces == 1
        check_launches(f"serve/parity/{key}", launches, rounds, cfg, dev)
    return out


def _one_compile_gate(dev: torch.device, rounds: int = 20) -> dict:
    """One server, three pool behaviours (full, 30% drop, byzantine always
    late), timeout-fired partial rounds included: step_traces must stay
    1."""
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = quadratic_testbed(cfg.n_workers, d=D,
                                                      device=dev)
    serve = ServeConfig(quorum=2 * F + 1, timeout_s=0.05,
                        staleness_window=2, stale_policy="discount")
    server = ByzantineRobustServer(cfg, params0, serve, seed=0, device=dev)
    behaviours = {
        "full": None,
        "drop30": ClientBehavior(drop_prob=0.3, seed=1),
        "byz_late": ClientBehavior(stragglers=tuple(range(F)),
                                   straggle_rounds=1, seed=2),
    }
    mark = K.launches()
    for name, beh in behaviours.items():
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=beh,
                          device=dev)
        run_service(server, pool, rounds, stop=False)
    server.stop()
    launches = launches_since(mark)
    part = server.metrics.participation_histogram()
    levels = sorted(part)
    emit("serve/one_compile", 0.0,
         f"traces={server.step_traces} participation_levels={levels}")
    assert server.step_traces == 1, (
        f"step rebuilt across participation levels: {server.step_traces}")
    assert len(levels) > 1, "bench never exercised partial participation"
    check_launches("serve/one_compile", launches,
                   server.metrics.summary()["rounds"], cfg, dev)
    return {"step_traces": server.step_traces,
            "participation_histogram": part,
            "staleness_histogram": server.metrics.staleness_histogram(),
            "launches": launches}


def _throughput_sweep(dev: torch.device,
                      rounds: int = THROUGHPUT_ROUNDS) -> dict:
    """Sustained service rate vs quorum (the buffer's firing size) at n=13,
    f=3 (all quorums >= 2f+1), with two permanent stragglers delivering one
    round late. A short warmup excludes the first step from the latency
    tail."""
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = quadratic_testbed(cfg.n_workers, d=D,
                                                      device=dev)
    out = {}
    for quorum in (13, 11, 7):
        serve = ServeConfig(quorum=quorum, timeout_s=0.25,
                            staleness_window=1, stale_policy="discount")
        server = ByzantineRobustServer(cfg, params0, serve, seed=0,
                                       device=dev)
        beh = ClientBehavior(stragglers=(11, 12), straggle_rounds=1, seed=0)
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=beh,
                          device=dev)
        run_service(server, pool, 5, stop=False)   # first step + settle
        server.metrics = ServeMetrics()
        run_service(server, pool, rounds)
        s = server.metrics.summary()
        s["step_traces"] = server.step_traces
        s["final_honest_loss"] = float(pool.last_losses[F:].mean())
        out[f"quorum{quorum}"] = s
        emit(f"serve/throughput/quorum{quorum}",
             s["latency_p50_ms"] * 1e3,
             f"updates/s={s['updates_per_sec']:.0f} "
             f"rounds/s={s['rounds_per_sec']:.1f} "
             f"p50={s['latency_p50_ms']:.2f}ms "
             f"p99={s['latency_p99_ms']:.2f}ms")
        assert server.step_traces == 1
        # the clock can fire extra rounds beyond the driven ones from
        # leftover stale updates: continuous batching, not an error
        assert s["rounds"] >= rounds
    return out


def run(out: Optional[str] = OUT, device: DeviceLike = None, *,
        parity_rounds: int = PARITY_ROUNDS, compile_rounds: int = 20,
        throughput_rounds: int = THROUGHPUT_ROUNDS) -> dict:
    """The three sections on ``device`` (default the card), the JSON
    rewritten to ``out`` after each. ``parity_rounds``, ``compile_rounds``
    (each pool behaviour's rounds) and ``throughput_rounds`` cut the
    sections; the defaults are the reference's."""
    dev = resolve_device(device)
    torch.zeros(1, device=dev)  # backend init outside all timings
    return run_sections((
        ("parity_gate", lambda: _parity_gate(dev, parity_rounds)),
        ("one_compile", lambda: _one_compile_gate(dev, compile_rounds)),
        ("throughput", lambda: _throughput_sweep(dev, throughput_rounds)),
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
