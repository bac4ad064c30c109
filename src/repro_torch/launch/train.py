"""Training launcher (counterpart of ``repro.launch.train``): RoSDHB on a
decoder of any family of the model zoo (dense, audio, vlm, moe, ssm,
hybrid), the workers simulated one after the other on one device.

On the card it builds the arch at full width; one H100 cannot hold the
reference's TPU shape, so the cuts are flags: ``--n-layers`` (depth),
``--n-workers`` and ``--global-batch``. The path ``chip_smoke.py`` drives::

    python -m repro_torch.launch.train --arch stablelm_3b --steps 8 \\
        --n-layers 2 --n-workers 8 --global-batch 8 --f 1 --ratio 0.05

With ``--device cpu`` it reduces the model as the reference's CPU branch
does (2 layers, d_model 256, vocab 512, seq 128, 16 sequences over 8
workers) and runs the kernels' plain versions: a rehearsal of the path.
The sparsifier is Block-RandK (``kind="block"``, 512-wide blocks, global
unless ``--local-masks``), the aggregator CWTM, the server banks float32
unless ``--momentum-dtype bfloat16``. As the reference's launcher:
``--algo dasha`` runs Byz-DASHA-PAGE; ``--stream`` draws each step's batch
from ``np.random.default_rng((seed, t))``, feeds ``--chunk-size`` steps at a
time through a ``ChunkPrefetcher`` of depth ``--prefetch-depth`` (the
remainder one step at a time) and prints the host high-water mark;
``--checkpoint PATH`` saves ``{"params": ...}`` with the step count at the
end.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.core import AggregatorConfig, AttackConfig, SparsifierConfig
from repro_torch.core import algorithms as alg
from repro_torch.data.stream import ChunkPrefetcher
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import (TrainState, build_chunked_train_step,
                                      build_train_step, make_train_plan)
from repro_torch.models import model_init
from repro_torch.testing import TorchDraws


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k", choices=list(INPUT_SHAPES))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--algo", default="rosdhb",
                   choices=["rosdhb", "dasha", "robust_dgd", "dgd"])
    p.add_argument("--ratio", type=float, default=0.05)
    p.add_argument("--f", type=int, default=None)
    p.add_argument("--attack", default="alie")
    p.add_argument("--gamma", type=float, default=1e-3)
    p.add_argument("--local-masks", action="store_true")
    p.add_argument("--momentum-dtype", default="float32",
                   choices=list(alg.BANK_DTYPES))
    p.add_argument("--server-compute-dtype", default="float32",
                   choices=list(alg.COMPUTE_DTYPES),
                   help="dtype of RoSDHB's momentum and aggregation (the "
                        "reference's AlgorithmConfig.server_compute_dtype; "
                        "below float32 the round takes the dense wire)")
    p.add_argument("--checkpoint", default=None,
                   help="save the final parameters here (.npz + .meta.json)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream", action="store_true",
                   help="feed batches through the prefetched ring buffer "
                        "(repro_torch.data.stream), --chunk-size steps per "
                        "chunk")
    p.add_argument("--chunk-size", type=int, default=8)
    p.add_argument("--prefetch-depth", type=int, default=2)
    # what one card forces: the cuts, and the device
    p.add_argument("--n-layers", type=int, default=None,
                   help="cut the depth (default: the arch's)")
    p.add_argument("--n-workers", type=int, default=None,
                   help="simulated workers (default 8, the reference's "
                        "host-mode count)")
    p.add_argument("--global-batch", type=int, default=None,
                   help="sequences per round over all workers (default: "
                        "the shape's)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (reduced rehearsal)")
    return p.parse_args(argv)


def make_batch(gen: np.random.Generator, vocab: int, n_workers: int,
               local_batch: int, seq_len: int) -> np.ndarray:
    """The reference's synthetic batch: random tokens, each odd position
    the previous one plus 1 (so the next token is half predictable)."""
    toks = gen.integers(0, vocab, (n_workers, local_batch, seq_len))
    toks[..., 1::2] = (toks[..., 0::2] + 1) % vocab
    return np.asarray(toks, np.int32)


def make_model_batch(gen: np.random.Generator, cfg, n_workers: int,
                     local_batch: int, seq_len: int) -> Dict[str, np.ndarray]:
    """The reference's ``make_batch`` for ``cfg``: ``tokens`` from
    :func:`make_batch`; embedding-input models take ``embeddings`` ``[n, lb,
    S, d_model]`` (normal draws after the tokens) and the tokens as
    ``targets``; the vlm adds ``image_embeddings`` ``[n, lb, T_img,
    d_model]``."""
    toks = make_batch(gen, cfg.vocab_size, n_workers, local_batch, seq_len)
    batch = {"tokens": toks}
    if cfg.input_kind != "tokens":
        batch = {"embeddings": np.asarray(gen.normal(size=(
                     n_workers, local_batch, seq_len, cfg.d_model)),
                     np.float32),
                 "targets": toks % cfg.vocab_size}
    if cfg.family == "vlm":
        batch["image_embeddings"] = np.asarray(gen.normal(size=(
            n_workers, local_batch, cfg.n_image_tokens, cfg.d_model)),
            np.float32)
    return batch


def setup(args: argparse.Namespace, *, plain: bool = False,
          dtype: Optional[str] = None) -> Dict:
    """Plan, step function, initial state and batch source for ``args``.
    ``plain`` runs the kernels' plain versions on the same device (the
    dense mask multiply, the plain CWTM sort, ``causal_attention``): the
    comparison path. ``dtype`` replaces the model's compute dtype, the
    activations' (float32: the LLM cut's float32 train step); the
    reference's launcher has no flag for it, so this one has none either.
    ``batch_fn()`` draws the per-step schedule's next
    batch; ``batch_at(t)`` is the streamed schedule's numpy batch of step
    ``t``."""
    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    n = args.n_workers or 8
    if dev.type == "cuda":
        model = spec.model
        shape = INPUT_SHAPES[args.shape]
    else:
        # the reference's CPU branch: reduced model, host shape
        model = spec.model.reduced(n_layers=2, d_model=256).with_overrides(
            vocab_size=512)
        shape = InputShape("host_train", 128, 16, "train")
    if args.n_layers is not None:
        model = model.with_overrides(n_layers=args.n_layers)
    if dtype is not None:
        model = model.with_overrides(dtype=dtype)
    if args.global_batch is not None:
        shape = InputShape(shape.name, shape.seq_len, args.global_batch,
                           shape.kind)
    if plain:
        model = model.with_overrides(use_flash_attention=False)
    spec = ArchSpec(model=model, citation=spec.citation,
                    rosdhb_ratio=spec.rosdhb_ratio)
    overrides = {
        "name": args.algo, "gamma": args.gamma,
        "momentum_dtype": args.momentum_dtype,
        "server_compute_dtype": args.server_compute_dtype,
        "sparsifier": SparsifierConfig(
            kind="block", ratio=args.ratio, block_size=512,
            local=args.local_masks, use_kernels=not plain),
        "attack": AttackConfig(name=args.attack),
    }
    if args.f is not None:
        overrides["f"] = args.f
        overrides["aggregator"] = AggregatorConfig(
            name="cwtm", f=max(args.f, 1), use_kernels=not plain)
    elif plain:
        overrides["aggregator"] = AggregatorConfig(
            name="cwtm", f=max(1, n // 8), use_kernels=False)
    plan = make_train_plan(spec, shape, overrides, n_workers=n)
    cfg = plan.model
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = TrainState(
        params=model_init(cfg, gen),
        server=alg.init_state(plan.algo, plan.bank_width,
                              device=dev),
        step=0, draws=TorchDraws(args.seed + 1, dev))
    rng = np.random.default_rng(args.seed)

    def batch_fn():
        return {k: torch.from_numpy(v).to(dev) for k, v in make_model_batch(
            rng, cfg, n, plan.local_batch, shape.seq_len).items()}

    def batch_at(t: int) -> Dict[str, np.ndarray]:
        return make_model_batch(np.random.default_rng((args.seed, t)), cfg,
                                n, plan.local_batch, shape.seq_len)

    return {"plan": plan, "step": build_train_step(plan, device=dev),
            "state": state, "batch_fn": batch_fn, "batch_at": batch_at,
            "device": dev}


def run(argv: Optional[List[str]] = None, *, plain: bool = False,
        log=print, dtype: Optional[str] = None) -> Dict:
    """Parse ``argv``, train ``--steps`` rounds and print the reference's
    step lines. Returns the per-step honest loss and |R|, the wall ms of
    each step (of each chunk with ``--stream``; host clock around work that
    ends in a device synchronise), the peak device memory, the stream's
    host high-water bytes, the device bytes the setup left allocated (the
    state held between steps: parameters, server banks, the adversary's
    memory) and the session (plan, step function, final state,
    batches). ``plain`` and ``dtype``: :func:`setup`'s."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if on_card else None
    s = setup(args, plain=plain, dtype=dtype)
    # the returned dict gives the initial state up: a round that allocates
    # its banks anew (dasha) would otherwise keep it alive beside every
    # step's
    plan, step, state, dev = s["plan"], s["step"], s.pop("state"), \
        s["device"]
    held = (torch.cuda.memory_allocated(dev) - before) if on_card else None
    log(f"[train] {plan.model.name} layers={plan.model.n_layers} "
        f"D={plan.flat_spec.padded_size:,} n_workers={plan.n_workers} "
        f"f={plan.algo.f} algo={plan.algo.name} k/d={args.ratio} "
        f"seq={plan.shape.seq_len} local_batch={plan.local_batch} "
        f"momentum={plan.algo.momentum_dtype} device={dev}"
        + (f" stream chunk={args.chunk_size} depth={args.prefetch_depth}"
           if args.stream else ""))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, step_ms = [], [], []
    out = {}
    t0 = time.time()

    def record(metrics, t, ms):
        losses.extend(torch.atleast_1d(metrics["loss"]).tolist())
        norms.extend(torch.atleast_1d(metrics["dir_norm"]).tolist())
        step_ms.append(ms)
        if args.stream or t % 5 == 0 or t == args.steps - 1:
            log(f"[train] step {t:4d} loss={losses[-1]:.4f}"
                f" |R|={norms[-1]:.3f} ({time.time() - t0:.1f}s)")

    def timed(fn, *a):
        synchronize(dev)
        t1 = time.perf_counter()
        res = fn(*a)
        synchronize(dev)
        return res, (time.perf_counter() - t1) * 1e3

    first = 0
    if args.stream:
        chunk_step = build_chunked_train_step(plan, args.chunk_size,
                                              device=dev)
        with ChunkPrefetcher(s["batch_at"], args.steps, args.chunk_size,
                             args.prefetch_depth, device=dev) as pf:
            while True:
                chunks = pf.take(1)
                if not chunks:
                    break
                (state, metrics), ms = timed(chunk_step, state, chunks[0])
                first += args.chunk_size
                record(metrics, first - 1, ms)
            out["host_high_water_bytes"] = pf.high_water_bytes
            log(f"[train] host high-water: {pf.high_water_bytes:,} B "
                f"({pf.high_water_chunks} chunks)")
        batch_for = lambda t: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                               for k, v in s["batch_at"](t).items()}
    else:
        batch_for = lambda t: s["batch_fn"]()  # noqa: E731
    for t in range(first, args.steps):
        (state, metrics), ms = timed(step, state, batch_for(t))
        record(metrics, t, ms)
    if args.checkpoint:
        ckpt.save(args.checkpoint, {"params": state.params}, step=args.steps)
        log(f"[train] checkpoint -> {args.checkpoint}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    s["state"] = state
    return {**s, **out, "losses": losses, "dir_norms": norms,
            "step_ms": step_ms, "peak_bytes": peak, "held_bytes": held}


def main(argv: Optional[List[str]] = None) -> int:
    # at D ~ 1e9 a step allocates its float32 momenta (30.6 GiB at 8 x
    # 1.03e9) beside the banks; the caching allocator's split blocks leave
    # no room for it unless its segments can grow
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
