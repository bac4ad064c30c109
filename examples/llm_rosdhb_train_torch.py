"""LLM-scale RoSDHB path on the PyTorch port (counterpart of
``examples/llm_rosdhb_train.py``): trains a reduced qwen-family transformer
(~3M params) for a few hundred steps with the SAME train step the launcher
(``python -m repro_torch.launch.train``) uses — per-worker gradients into
the ``[n, D]`` bank, the momentum bank, Byzantine overwrite, CWTM.

The reference runs its pjit train step on a host mesh with a
coordinate-sharded bank; the port runs ``launch.steps.build_train_step`` on
one device (the workers one after the other, the naive flatten), with no
mesh and no pjit. On the card by default::

    python3 examples/llm_rosdhb_train_torch.py --steps 60 [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ArchSpec, InputShape  # noqa: E402
from repro_torch.core import (AggregatorConfig, AttackConfig,  # noqa: E402
                              SparsifierConfig)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import (TrainState,  # noqa: E402
                                      build_train_step, make_train_plan)
from repro_torch.models import model_init  # noqa: E402
from repro_torch.testing import TorchDraws  # noqa: E402


def train(argv=None):
    """Parse ``argv`` and train; returns the honest loss of every step."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="qwen25_3b")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--n-workers", type=int, default=8)
    p.add_argument("--f", type=int, default=2)
    p.add_argument("--ratio", type=float, default=0.1)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    spec = get_arch(args.arch)
    reduced = ArchSpec(model=spec.model.reduced(n_layers=2, d_model=256)
                       .with_overrides(vocab_size=512),
                       citation=spec.citation)
    shape = InputShape("host_train", args.seq, args.batch, "train")

    plan = make_train_plan(
        reduced, shape, n_workers=args.n_workers,
        algo_overrides={
            "f": args.f, "gamma": 0.5,
            "sparsifier": SparsifierConfig(kind="block", ratio=args.ratio,
                                           block_size=128),
            "aggregator": AggregatorConfig(name="cwtm", f=args.f),
            "attack": AttackConfig(name="alie"),
            "momentum_dtype": "float32",
        })
    step = build_train_step(plan, device=dev)
    cfg = plan.model

    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    state = TrainState(
        params=params,
        server=alg.init_state(plan.algo, plan.bank_width, device=dev),
        step=0, draws=TorchDraws(1, dev))

    rng = np.random.default_rng(0)
    lb = shape.global_batch // plan.n_workers
    print(f"arch={args.arch}(reduced) d={plan.flat_spec.padded_size} "
          f"params, n_workers={plan.n_workers} f={args.f} k/d={args.ratio} "
          f"device={dev}")
    t0 = time.time()
    losses = []
    for t in range(args.steps):
        toks = rng.integers(0, cfg.vocab_size,
                            (plan.n_workers, lb, args.seq))
        toks[..., 1::2] = (toks[..., 0::2] + 1) % cfg.vocab_size
        batch = {"tokens": torch.as_tensor(toks.astype(np.int32),
                                           device=dev)}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if t % 10 == 0 or t == args.steps - 1:
            print(f"step {t:4d} loss={losses[-1]:.4f} "
                  f"|R|={float(metrics['dir_norm']):.3f} "
                  f"uplink={int(metrics['payload_floats_per_worker'])} "
                  f"floats/worker ({time.time()-t0:.1f}s)")
    return losses


def main(argv=None):
    losses = train(argv)
    assert losses[-1] < 6.1
    print("OK: loss decreasing under ALIE with 10x-compressed uplink.")
    return losses


if __name__ == "__main__":
    main()
