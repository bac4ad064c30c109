"""One greedy decode step, shared by the serving entry points (counterpart
of ``repro.models.decode``).

The reference jits the step once with the position as a traced scalar; the
port runs eagerly, so the position is a Python int and nothing recompiles.
The caches are written in place: a step allocates no cache memory.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.transformer import forward, logits_fn


def one_hot(tok: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(tok, n)``: float32 rows ``[..., n]``, all zero for
    an id outside ``[0, n)`` (``torch.nn.functional.one_hot`` raises
    there; musicgen's ids run to 2047 against d_model 1536)."""
    return (tok[..., None] == torch.arange(n, device=tok.device)).float()


def make_decode_step(cfg, image_embeddings: Optional[torch.Tensor] = None
                     ) -> Callable:
    """The single-token greedy decode step for ``cfg``:
    ``decode_step(params, tok, caches, pos) -> (next_tok, caches)`` with
    ``tok [B, 1]`` the tokens at absolute position ``pos``. Embedding-input
    models take the one-hot rows of the tokens as their embeddings, as the
    reference does. For the vlm pass the prompt's ``image_embeddings``
    here."""

    @torch.no_grad()
    def decode_step(params, tok, caches, pos):
        if cfg.input_kind == "tokens":
            db = {"tokens": tok}
        else:
            db = {"embeddings": one_hot(tok, cfg.d_model)}
        if cfg.family == "vlm":
            db["image_embeddings"] = image_embeddings
        h, caches, _ = forward(params, cfg, db, mode="decode", pos=pos,
                               caches=caches)
        return torch.argmax(logits_fn(params, cfg, h), -1), caches

    return decode_step
