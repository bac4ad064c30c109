"""Serving launcher (counterpart of ``repro.launch.serve``): a batched
prefill, then greedy decode over preallocated KV caches, one token a step
(``models.make_decode_step``).

On the card it builds the arch at full width and depth; what one card
forces is a flag: ``--n-layers`` cuts the depth (mistral_large_123b's 88
layers hold ~490 GB of float32 weights). With ``--device cpu`` it reduces
the model as the reference's CPU branch does (2 layers, d_model 256, vocab
512, float32). The prompts are the reference's: ``np.random.default_rng(0)``
tokens (frame embeddings for embedding-input models), then the vlm's image
embeddings; the parameters are drawn from a generator seeded with 0::

    python -m repro_torch.launch.serve --arch llama32_vision_11b
    python -m repro_torch.launch.serve --arch musicgen_medium --device cpu

It prints the prefill time, the decode time a step (one token for each of
the batch's sequences), tokens/s and the peak device memory.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import (cache_init, forward, logits_fn,
                                make_decode_step, model_init)
from repro_torch.models.config import ModelConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=8,
                   help="tokens generated a sequence: one from the prefill, "
                        "then one a decode step")
    # what one card forces: the cut, and the device
    p.add_argument("--n-layers", type=int, default=None,
                   help="cut the depth (default: the arch's)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (reduced rehearsal)")
    return p.parse_args(argv)


def model_config(args: argparse.Namespace, dev: torch.device) -> ModelConfig:
    """The arch's model on the card, the reference's reduced CPU model on
    the CPU; ``--n-layers`` cuts either."""
    cfg = get_arch(args.arch).model
    if dev.type != "cuda":
        cfg = cfg.reduced(n_layers=2, d_model=256).with_overrides(
            vocab_size=512, dtype="float32")
    if args.n_layers is not None:
        cfg = cfg.with_overrides(n_layers=args.n_layers)
    return cfg


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The reference's prompt draws, in its order."""
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = np.asarray(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)), np.int32)
    else:
        out["embeddings"] = np.asarray(
            rng.normal(size=(batch, prompt_len, cfg.d_model)), np.float32)
    if cfg.family == "vlm":
        out["image_embeddings"] = np.asarray(
            rng.normal(size=(batch, cfg.n_image_tokens, cfg.d_model)),
            np.float32)
    return out


@torch.no_grad()
def run(argv: Optional[List[str]] = None, *, params=None, log=print) -> Dict:
    """Parse ``argv``, prefill the prompts and decode ``--tokens - 1`` steps.
    ``params`` serves a given tree in place of the seeded draw (tests carry
    the reference's across).

    Returns the generated ``tokens [B, --tokens]``, the prefill's hidden
    states, ``prefill_ms`` and ``decode_ms`` (host clock around work that
    ends in a device synchronise; ``decode_ms`` over all steps),
    ``decode_ms_per_step``, ``tokens_per_s`` (decoded tokens over
    ``decode_ms``), the peak device memory (``None`` on the CPU) and the
    session (``cfg``, ``params``, the prompt ``batch``, the ``caches``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args, dev)
    b, s = args.batch, args.prompt_len
    if args.tokens < 1:
        raise ValueError(f"--tokens must be at least 1, got {args.tokens}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_prompt(
        cfg, b, s, np.random.default_rng(0)).items()}
    caches = cache_init(cfg, b, s + args.tokens, device=dev)
    log(f"[serve] {cfg.name} family={cfg.family} layers={cfg.n_layers} "
        f"d_model={cfg.d_model} dtype={cfg.dtype} batch={b} prompt={s} "
        f"tokens={args.tokens} device={dev}")

    synchronize(dev)
    t0 = time.perf_counter()
    hidden, caches, _ = forward(params, cfg, batch, mode="prefill", pos=0,
                                caches=caches)
    tok = torch.argmax(logits_fn(params, cfg, hidden[:, -1:]), -1)
    synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    log(f"[serve] prefill [{b}x{s}] {prefill_ms:.3f} ms")

    decode_step = make_decode_step(cfg, batch.get("image_embeddings"))
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        tok, caches = decode_step(params, tok, caches, s + i)
        toks.append(tok)
    synchronize(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    steps = args.tokens - 1
    per_step = decode_ms / steps if steps else None
    tps = steps * b / (decode_ms / 1e3) if steps else None
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)
    if steps:
        log(f"[serve] decoded {steps * b} tokens in {decode_ms:.3f} ms "
            f"({per_step:.3f} ms a step, {tps:.1f} tokens/s)")
    if peak is not None:
        log(f"[serve] peak device memory {peak:.1f} MiB")
    return {"tokens": torch.cat(toks, dim=1), "prefill_hidden": hidden,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_ms_per_step": per_step, "tokens_per_s": tps,
            "peak_mib": peak, "cfg": cfg, "params": params, "batch": batch,
            "caches": caches, "device": dev}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
