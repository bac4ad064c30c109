"""Quickstart on the PyTorch port (counterpart of ``examples/quickstart.py``):
RoSDHB in 40 lines, then Table 1 as ONE bank of lanes.

Part 1 — the algorithm itself: ten workers (two Byzantine, running ALIE)
minimise heterogeneous quadratics; the server sees only 10% of each gradient
per round (global RandK), keeps a Polyak momentum per worker, and aggregates
with NNM+CWTM (on the card: the pairdist and CWTM kernels).

Part 2 — the paper's headline comparison: the ``table1-mini`` registry
scenario (all four algorithms x {alie, foe} x CWTM+NNM) plans to a
single cross-algorithm bank — the algorithm choice, its hyperparameters,
the attack, and the aggregator are all per-lane values of one bank, whose
lanes run together every round (``repro_torch.core.sweep``).

The reference runs on a host mesh and compiles one XLA program; the port
runs on one device, with no mesh and no pjit: PyTorch runs the rounds
eagerly. The targets come from a ``torch.Generator``, the masks from
``TorchDraws``. On the card by default::

    python3 examples/quickstart_torch.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.adversary import registry  # noqa: E402
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,  # noqa: E402
                              AttackConfig, SparsifierConfig, apply_direction,
                              init_state, make_aggregator, quadratic_testbed,
                              server_round)
from repro_torch.core.sweep import plan_grid, run_scenarios  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.testing import TorchDraws  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(p.parse_args(argv).device)

    # ------------------------------------------------------------------
    # Part 1: one RoSDHB training run, step by step
    # ------------------------------------------------------------------

    D, N, F = 64, 10, 2

    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=N, f=F, gamma=0.1, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.1),  # send 10% of d
        aggregator=AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5),
    )

    targets = (torch.randn((N, D), generator=torch.Generator().manual_seed(0))
               * 0.1 + 1.0).to(dev)
    honest_opt = torch.mean(targets[F:], dim=0)

    theta = torch.zeros(D, device=dev)
    state = init_state(cfg, D, device=dev)
    draws = TorchDraws(1, dev)
    agg = make_aggregator(cfg.aggregator, device=dev)

    for t in range(800):
        grads = theta[None, :] - targets          # worker i's local gradient
        direction, state, aux = server_round(cfg, state, grads, draws,
                                             agg=agg)
        theta = apply_direction(theta, direction, cfg.gamma)
        if t % 200 == 0 or t == 799:
            print(f"round {t:4d}  dist-to-honest-opt="
                  f"{float(torch.linalg.vector_norm(theta - honest_opt)):.4f}"
                  f"  uplink floats/worker={aux['payload_floats_per_worker']}"
                  f" (of {D})")

    assert float(torch.linalg.vector_norm(theta - honest_opt)) < 0.3
    print("OK: converged to the honest optimum under attack at 10x "
          "compression.")

    # ------------------------------------------------------------------
    # Part 2: a Table-1 mini-grid — 4 algorithms x 2 attacks, ONE bank
    # ------------------------------------------------------------------

    spec = registry.get_spec("table1-mini")
    scenarios = spec.expand()
    plan = plan_grid(scenarios)
    print(f"\n{plan.describe()}")
    assert plan.n_programs == 1, "the whole cross-algorithm grid is one bank"

    loss_fn, params0, batch_fn, _ = quadratic_testbed(spec.n_workers, D,
                                                      device=dev)
    rows = run_scenarios(scenarios, loss_fn=loss_fn, params0=params0,
                         batches=batch_fn, seeds=[0, 1], steps=300,
                         shard=False, device=dev)

    print(f"\n{'scenario':<42} {'final_loss':>10} {'comm_MB':>8}")
    by_label = {}
    for r in rows:
        acc = by_label.setdefault(r["scenario"],
                                  {"loss": 0.0, "mb": 0.0, "k": 0})
        acc["loss"] += r["final_loss"]
        acc["mb"] = r["comm_bytes"] / 1e6
        acc["k"] += 1
    for label, acc in by_label.items():
        print(f"{label:<42} {acc['loss'] / acc['k']:>10.4f} "
              f"{acc['mb']:>8.2f}")

    # the robust+compressed corner (rosdhb) should beat the non-robust corner
    # (dgd, which FoE wrecks), at ~10x less uplink than robust_dgd
    def mean_loss(algo):
        return sum(r["final_loss"] for r in rows if r["algo"] == algo) / max(
            1, sum(1 for r in rows if r["algo"] == algo))

    assert mean_loss("rosdhb") < mean_loss("dgd")
    rosdhb_mb = next(r["comm_bytes"] for r in rows if r["algo"] == "rosdhb")
    robust_mb = next(r["comm_bytes"] for r in rows
                     if r["algo"] == "robust_dgd")
    assert rosdhb_mb * 5 < robust_mb
    print("\nOK: one bank reproduced the Table-1 comparison "
          f"({len(rows)} cells).")
    return rows


if __name__ == "__main__":
    main()
