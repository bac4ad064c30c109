"""End-to-end run reproducing the paper's Section-4 experiment on the
PyTorch port (counterpart of ``examples/paper_mnist.py``).

Trains the ~12k-parameter CNN on the (synthetic, offline) MNIST-like dataset
with 10 honest workers plus f Byzantine workers running ALIE, trimmed-mean
aggregation (on the card: the CWTM kernel), and RandK at a chosen
compression ratio; reports accuracy and cumulative communication until the
tau = 0.85 threshold — the protocol behind Figure 1.

A single seed runs ``Simulator.run`` (an eval record every 20 rounds and
the last, the history cut at the first record past tau); with ``--seeds N``
all N trajectories run as the lanes of one rollout
(``repro_torch.core.sweep.rollout_over_seeds``) and mean +- std accuracy is
reported. The reference compiles its scans on a host mesh; the port runs
the rounds eagerly on one device, with no mesh and no pjit. On the card by
default::

    python3 examples/paper_mnist_torch.py --ratio 0.05 --f 5
    python3 examples/paper_mnist_torch.py --ratio 0.05 --f 5 --seeds 4
    python3 examples/paper_mnist_torch.py --steps 2 --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (AggregatorConfig, AlgorithmConfig,  # noqa: E402
                              AttackConfig, Simulator, SparsifierConfig)
from repro_torch.core.sweep import (eval_over_seeds,  # noqa: E402
                                    rollout_over_seeds)
from repro_torch.data import SyntheticMNIST  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import cnn_accuracy, cnn_init, cnn_loss  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ratio", type=float, default=0.05, help="k/d")
    p.add_argument("--f", type=int, default=5, help="# Byzantine workers")
    p.add_argument("--attack", default="alie")
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--algo", default="rosdhb",
                   choices=["rosdhb", "dasha", "robust_dgd", "dgd"])
    p.add_argument("--local-masks", action="store_true",
                   help="RoSDHB-Local (uncoordinated sparsification)")
    p.add_argument("--seeds", type=int, default=1,
                   help=">1 runs all seeds as the lanes of one rollout")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # learning rates tuned per ratio at f=0 (the paper's tuning protocol)
    gamma_by_ratio = {0.01: 0.01, 0.05: 0.05, 0.1: 0.05, 0.3: 0.1,
                      0.5: 0.1, 1.0: 0.2}
    gamma = args.gamma or gamma_by_ratio.get(args.ratio, 0.05)
    n = 10 + args.f

    ds = SyntheticMNIST(n_workers=n, per_worker=2000, seed=0)
    cfg = AlgorithmConfig(
        name=args.algo, n_workers=n, f=args.f, gamma=gamma, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=args.ratio,
                                    local=args.local_masks),
        aggregator=AggregatorConfig(name="cwtm", f=max(args.f, 1)),
        attack=AttackConfig(name=args.attack))
    sim = Simulator(loss_fn=cnn_loss, params0=cnn_init(0), cfg=cfg,
                    eval_fn=lambda p, b: {"acc": cnn_accuracy(p, b)},
                    device=dev)

    print(f"algo={args.algo} n={n} f={args.f} attack={args.attack} "
          f"k/d={args.ratio} gamma={gamma} "
          f"uplink/round={sim.payload_bytes_per_round()/1e3:.1f}KB "
          f"device={dev}")

    if args.seeds > 1:
        seeds = list(range(args.seeds))
        states, metrics = rollout_over_seeds(sim, seeds,
                                             ds.worker_batches(60),
                                             steps=args.steps)
        accs = eval_over_seeds(sim, states, ds.eval_batch)["acc"]
        accs = accs.cpu().numpy()
        loss = metrics["loss"].cpu().numpy()
        total_mb = sim.payload_bytes_per_round() * args.steps / 1e6
        print(f"{args.seeds}-seed sweep, one rollout of {args.steps} "
              f"rounds over {args.seeds} lanes ({total_mb:.2f} MB uplink "
              "each):")
        print(f"  final loss {loss[:, -1].mean():.3f}+-{loss[:, -1].std():.3f}"
              f"  final acc {accs.mean():.3f}+-{accs.std():.3f}")
        return {"loss": loss, "acc": accs}

    st = sim.init()
    st, hist = sim.run(
        st, ds.worker_batches(60), steps=args.steps, eval_every=20,
        eval_batch=ds.eval_batch,
        stop_fn=lambda m: m.get("acc", 0.0) >= 0.85)
    for i in range(len(hist["step"])):
        print(f"round {hist['step'][i]:4d}  loss={hist['loss'][i]:.3f}  "
              f"acc={hist['acc'][i]:.3f}  "
              f"comm={hist['comm_bytes'][i]/1e6:.2f}MB")
    if hist["acc"] and hist["acc"][-1] >= 0.85:
        print(f"reached tau=0.85 with {hist['comm_bytes'][-1]/1e6:.2f} MB "
              f"total uplink")
    else:
        print("did not reach tau within the step budget")
    return hist


if __name__ == "__main__":
    main()
