"""Batched serving demo on the PyTorch port (counterpart of
``examples/serve_demo.py``): prefill a batch of prompts then decode tokens
with the same decode step the serving launcher
(``python -m repro_torch.launch.serve``) uses (KV/SSM caches written in
place, greedy sampling), with a reduced model.

The reference runs on a host mesh; the port runs on one device, with no
mesh and no pjit. On the card by default::

    python3 examples/serve_demo_torch.py --arch zamba2_7b --tokens 16 \\
        [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.launch.serve import make_prompt  # noqa: E402
from repro_torch.models import (cache_init, forward, logits_fn,  # noqa: E402
                                make_decode_step, model_init)


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="zamba2_7b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    spec = get_arch(args.arch)
    cfg = spec.model.reduced(n_layers=2, d_model=256).with_overrides(
        vocab_size=512, dtype="float32")
    max_len = args.prompt_len + args.tokens

    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    b, s = args.batch, args.prompt_len
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_prompt(
        cfg, b, s, np.random.default_rng(0)).items()}

    caches = cache_init(cfg, b, max_len, device=dev)
    synchronize(dev)
    t0 = time.time()
    hidden, caches, _ = forward(params, cfg, batch, mode="prefill",
                                pos=0, caches=caches)
    last = torch.argmax(logits_fn(params, cfg, hidden[:, -1:]), -1)
    synchronize(dev)
    print(f"prefill [{b}x{s}] in {time.time()-t0:.2f}s "
          f"(family={cfg.family}, cache kinds="
          f"{sorted(k for k, v in caches.items() if v is not None)}, "
          f"device={dev})")

    # the serving launcher's decode step (repro_torch.models.make_decode_step)
    decode_one = make_decode_step(cfg, batch.get("image_embeddings"))

    tok = last
    out = [tok[:, 0].cpu().numpy()]
    t0 = time.time()
    for i in range(args.tokens - 1):
        tok, caches = decode_one(params, tok, caches, s + i)
        out.append(tok[:, 0].cpu().numpy())
    synchronize(dev)
    dt = time.time() - t0
    gen = np.stack(out, 1)
    print(f"decoded {args.tokens - 1} steps x {b} seqs in {dt:.2f}s "
          f"({(args.tokens - 1) * b / max(dt, 1e-9):.1f} tok/s)")
    print("sampled ids[0]:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
