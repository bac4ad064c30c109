"""The RoSDHB train step for the LLM path and the serve step (counterpart
of ``repro.launch.steps``, host mode).

``build_train_step`` wires the paper's algorithm into the decoder:

  1. per-worker loss and gradient with respect to a bf16 copy of the f32
     master parameters, one worker after the other (a Python loop: the
     kernels are ``ctypes`` calls inside ``autograd.Function``s, which
     ``torch.func.vmap`` cannot map, and the loop keeps one worker's
     activations alive at a time);
  2. each gradient raveled in the wire dtype (``momentum_dtype``, as the
     reference) and the plan's layout (``TrainPlan.flatten``: the sharded
     layout of ``repro_torch.sharding`` where the worker count is the
     one-card layout's data extent, 1, else the naive flatten, as the
     reference chooses), rows widened to whole Block-RandK blocks
     (``TrainPlan.bank_width``): for RoSDHB on a global mask into one row
     compressed at once into the worker's payload row (the streamed step:
     no ``[n, D]`` bank), else into its row of the ``[n, D]`` bank;
  3. ``core.algorithms.payload_round`` on the payload, or
     ``server_round`` on the bank: the round's masks, the Block-RandK
     wire, the Byzantine overwrite, the per-worker momentum (on the
     payload, the momentum kernel) and the robust aggregation;
  4. ``p - gamma * d`` in place on the master parameters (the step
     consumes its state).

``build_chunked_train_step`` runs ``chunk_size`` such steps over one chunk
of stacked batches (the streamed launcher's unit). ``build_serve_step`` is
a prefill or a decode step of the model for an input shape. The
reference's ``TrainState`` carries a PRNG key; the port's carries the draws
provider the server round takes its masks from.

:func:`train_input_specs`, :func:`stream_batch_specs` and
:func:`serve_input_specs` are the steps' abstract inputs for the dry run
(``launch.dryrun``): ``meta`` tensors of the reference's shapes and dtypes,
with no shardings and no mesh (one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchSpec, InputShape, model_for_shape
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as A
from repro_torch.core import attacks as ATK
from repro_torch.core import compression as C
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import flatten as SF
from repro_torch.sharding import partitioning as SP
from repro_torch.utils import tree as T
from repro_torch.utils.dtypes import vector_norm


class TrainState(NamedTuple):
    params: Any              # model parameter tree (f32 master)
    server: A.ServerState    # RoSDHB momentum bank [n_workers, Dp]
    step: int
    draws: Any               # draws provider of the server rounds


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """What the launcher needs to build a train step: the model, the
    algorithm, the flat layout of the parameters and the worker split.

    ``flatten``: ``'sharded'`` (``flat_spec`` a
    ``sharding.ShardedFlatSpec``) or ``'naive'`` (a ``utils.tree.FlatSpec``,
    padded to 8)."""

    arch: ArchSpec
    shape: InputShape
    model: ModelConfig
    algo: A.AlgorithmConfig
    flat_spec: Any
    n_workers: int
    local_batch: int
    flatten: str = "naive"

    @property
    def bank_width(self) -> int:
        """Columns of the ``[n, D]`` server banks: the flat width, rounded up
        to whole blocks under Block-RandK. The added columns are zero in
        every row, and the round draws the same blocks (``ceil(D /
        block_size)`` of them) and gives the same first D columns as over
        the flat width; a whole number of blocks lets the kernels' payload
        route take any D (the reference takes its dense round where D is
        not a multiple of the block)."""
        d, sp = self.flat_spec.padded_size, self.algo.sparsifier
        if sp.kind != "block":
            return d
        return -(-d // sp.block_size) * sp.block_size


def make_train_plan(spec: ArchSpec, shape: InputShape,
                    algo_overrides: Optional[Dict] = None,
                    n_workers: int = 8) -> TrainPlan:
    """The reference's plan on the one-card layout (``data`` 1, ``model``
    1): ``n_workers`` workers, the sharded layout where the worker count is
    the layout's data extent (1) and the naive flatten padded to a
    multiple of 8 otherwise (the reference's host mode), and the
    reference's defaults (f = max(1, n//8), gamma 1e-3, beta 0.9,
    ``block_hash`` at the arch's ratio with 512-wide blocks, CWTM, ALIE,
    bfloat16 server banks)."""
    cfg = model_for_shape(spec, shape)
    n = n_workers
    if shape.global_batch % n:
        raise ValueError(f"global_batch {shape.global_batch} not divisible "
                         f"by n_workers {n}")
    abstract = tf.model_init(cfg, None, device="meta")
    if n == SP.n_workers():
        flatten, flat_spec = "sharded", SF.make_sharded_flat_spec(abstract)
    else:
        # the worker axis is not the layout's data extent: the bank
        # transforms do not apply, as in the reference's host mode
        flatten, flat_spec = "naive", T.make_flat_spec(abstract, pad_to=8)
    ov = dict(algo_overrides or {})
    algo = A.AlgorithmConfig(
        name=ov.pop("name", "rosdhb"),
        n_workers=n,
        f=ov.pop("f", max(1, n // 8)),
        gamma=ov.pop("gamma", 1e-3),
        beta=ov.pop("beta", 0.9),
        sparsifier=ov.pop("sparsifier", C.SparsifierConfig(
            kind="block_hash", ratio=spec.rosdhb_ratio, block_size=512)),
        aggregator=ov.pop("aggregator", G.AggregatorConfig(
            name="cwtm", f=max(1, n // 8))),
        attack=ov.pop("attack", ATK.AttackConfig(name="alie")),
        momentum_dtype=ov.pop("momentum_dtype", "bfloat16"),
        **ov,
    )
    return TrainPlan(spec, shape, cfg, algo, flat_spec, n,
                     shape.global_batch // n, flatten)


def build_train_step(plan: TrainPlan, device: DeviceLike = None):
    """``train_step(state, batch) -> (state, metrics)`` on ``device``
    (default the card). Each leaf of ``batch`` leads with ``[n_workers,
    local_batch]`` (``tokens [.., seq]``, or ``embeddings`` and
    ``targets``; the vlm's ``image_embeddings``); metrics are ``loss``
    (mean honest loss, rows ``f:``), ``dir_norm`` (|R|) and
    ``payload_floats_per_worker``.

    Where the round streams its payload (``algorithms.streams_payload``:
    RoSDHB on a global Block-RandK mask, the reference's launcher's round)
    the step draws the round's block ids first, then for each worker in
    turn computes its gradient, ravels it into one row of the wire dtype
    (allocated once the gradient exists) and compresses the row into the
    worker's payload row (``compression.compress_rows``), and runs the
    round on the finished payload (``algorithms.payload_round``): no ``[n,
    D]`` bank exists, and the numbers are the bank round's (the reference
    compresses before the Byzantine overwrite too). Every other round
    takes the ``[n, D]`` bank (``algorithms.server_round``).

    The step consumes its state: the round updates the momentum bank in
    place (as ``server_round`` does) and the step updates the master
    parameters in place, so the returned state holds the same tensors. A
    caller that reuses a state passes a copy (every tensor cloned)."""
    dev = resolve_device(device)
    cfg, fspec, algo = plan.model, plan.flat_spec, plan.algo
    agg = G.make_aggregator(algo.aggregator, device=dev)
    n, d = plan.n_workers, plan.bank_width
    sp = algo.sparsifier
    stream = A.streams_payload(algo, d)
    wire_dtype = A.BANK_DTYPES[algo.momentum_dtype]
    ravel, unravel = ((SF.ravel_into, SF.bank_to_param_tree)
                      if plan.flatten == "sharded"
                      else (T.tree_ravel_into, T.tree_unravel))

    def worker_grads(params, batch, w):
        # (1) mixed precision, as the reference: differentiate with respect
        # to a bf16 cast of the f32 master parameters, cast anew for each
        # worker so that no copy is held while a gradient is raveled
        half = [(p.to(torch.bfloat16) if p.dtype == torch.float32 else p)
                .detach().requires_grad_() for p in T.tree_leaves(params)]
        loss = tf.lm_loss(T.tree_unflatten(fspec.treedef, half), cfg,
                          {k: v[w] for k, v in batch.items()})
        return loss.detach(), list(torch.autograd.grad(loss, half))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        losses = []
        if stream:
            ids = C.block_ids(state.draws, n, d, sp)
            payload = torch.empty((n, C.payload_width(d, sp)),
                                  dtype=wire_dtype, device=dev)
        else:
            bank = torch.empty((n, d), dtype=wire_dtype, device=dev)
        for w in range(n):
            loss, grads = worker_grads(state.params, batch, w)
            losses.append(loss)
            # (2) the gradient raveled in the wire dtype: into the worker's
            # row of the bank, or into one row compressed at once into the
            # worker's payload row
            if stream:
                row = torch.empty(d, dtype=wire_dtype, device=dev)
                ravel(grads, row, fspec)
                del grads
                C.compress_rows(row[None], ids, sp, out=payload[w:w + 1])
                del row
            else:
                ravel(grads, bank[w], fspec)
                del grads
        # (3) the paper's steps 1-6
        if stream:
            direction, server, _ = A.payload_round(
                algo, state.server, payload, ids, d, state.draws, agg=agg)
            del payload
        else:
            direction, server, _ = A.server_round(algo, state.server, bank,
                                                  state.draws, agg=agg)
            del bank
        # (4) step 7 in place on the master parameters, one fused
        # multiply-add a leaf (the direction's leaves are views of it)
        for p, r in zip(T.tree_leaves(state.params),
                        T.tree_leaves(unravel(direction, fspec))):
            p.add_(r.to(p.dtype), alpha=-algo.gamma)
        metrics = {
            "loss": torch.stack(losses)[algo.f:].mean(),
            "dir_norm": vector_norm(direction),
            "payload_floats_per_worker": float(C.payload_floats(
                fspec.padded_size, algo.sparsifier)),
        }
        return TrainState(state.params, server, state.step + 1,
                          state.draws), metrics

    return train_step


def build_chunked_train_step(plan: TrainPlan, chunk_size: int,
                             device: DeviceLike = None):
    """``chunk_size`` rounds of :func:`build_train_step` per call:
    ``chunk_step(state, chunk) -> (state, metrics)`` with ``chunk`` leaves
    ``[chunk_size, n_workers, ...]`` and every metric stacked to
    ``[chunk_size]`` (the reference scans the step over the chunk; PyTorch
    runs eagerly, so this is a loop)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    step = build_train_step(plan, device=device)

    def chunk_step(state: TrainState, chunk: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        per_step = []
        for t in range(chunk_size):
            state, m = step(state, {k: v[t] for k, v in chunk.items()})
            per_step.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]) for m in
                                       per_step]) for k in per_step[0]}

    return chunk_step


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def build_serve_step(spec: ArchSpec, shape: InputShape):
    """Prefill or decode step of ``spec`` under ``shape``'s policy
    (``model_for_shape``: ``long_500k`` gets the sliding window, so a ring
    cache). Signatures, as the reference's:

    * prefill: ``(params, batch, caches) -> (logits of the last position,
      caches)``;
    * decode: ``(params, batch, caches, pos) -> (logits, caches)``.

    The caches (``models.cache_init``) are written in place."""
    cfg = model_for_shape(spec, shape)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch, caches):
            hidden, caches, _ = tf.forward(params, cfg, batch,
                                           mode="prefill", pos=0,
                                           caches=caches)
            return tf.logits_fn(params, cfg, hidden[:, -1:]), caches
        return prefill_step

    @torch.no_grad()
    def decode_step(params, batch, caches, pos):
        hidden, caches, _ = tf.forward(params, cfg, batch, mode="decode",
                                       pos=pos, caches=caches)
        return tf.logits_fn(params, cfg, hidden), caches
    return decode_step


# --------------------------------------------------------------------------
# abstract inputs (meta tensors) for the dry run: no allocation
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _attack_state_specs(algo: A.AlgorithmConfig, d: int):
    """Abstract ``adversary.AttackState`` matching ``A.init_state``: the
    ``[d]`` memory slots, the scalars and the round counter; ``None`` for
    the attacks that keep no memory (``adversary.needs_attack_state``)."""
    from repro_torch.adversary import core as adv
    if not adv.needs_attack_state(algo.attack.name, algo.f):
        return None
    return adv.init_attack_state(d, device="meta")


def train_input_specs(plan: TrainPlan) -> Tuple[TrainState, Dict]:
    """``(state, batch)`` of :func:`build_train_step` as meta tensors: the
    float32 master parameters, the server state of ``A.init_state`` (the
    momentum bank always, dasha's mirrors and float32 previous gradients
    where the resolved layout carries them, the adversary's memory where
    the attack keeps one), the step, and the batch of
    :func:`_train_batch_specs`. The state's ``draws`` is ``None``.

    One difference from the reference's specs: the ``[n, D]`` banks here
    are ``plan.bank_width`` wide, the flat width rounded up to whole
    Block-RandK blocks (``TrainPlan.bank_width``), where the reference's
    are ``flat_spec.padded_size`` wide."""
    params = tf.model_init(plan.model, None, device="meta")
    n, d = plan.n_workers, plan.bank_width
    mdt = A.BANK_DTYPES[plan.algo.momentum_dtype]
    layout = plan.algo.resolved_state_layout()
    bank = _meta((n, d), mdt)
    server = A.ServerState(
        momentum=bank, mirror=_meta((n, d), mdt) if layout.mirror else None,
        prev_grad=(_meta((n, d), torch.float32) if layout.prev_grad
                   else None),
        step=_meta((), torch.int32),
        attack=_attack_state_specs(plan.algo, d))
    state = TrainState(params=params, server=server,
                       step=_meta((), torch.int32), draws=None)
    return state, _train_batch_specs(plan.model, plan)


def _train_batch_specs(cfg: ModelConfig, plan: TrainPlan) -> Dict:
    """The batch of one train step: ``[n_workers, local_batch, seq]``
    tokens (or embeddings and targets), and the vlm's image embeddings."""
    n, lb, s = plan.n_workers, plan.local_batch, plan.shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.input_kind == "tokens":
        batch["tokens"] = _meta((n, lb, s), torch.int32)
    else:
        batch["embeddings"] = _meta((n, lb, s, cfg.d_model), dtype)
        batch["targets"] = _meta((n, lb, s), torch.int32)
    if cfg.family == "vlm":
        batch["image_embeddings"] = _meta(
            (n, lb, cfg.n_image_tokens, cfg.d_model), dtype)
    return batch


def stream_batch_specs(plan: TrainPlan, chunk_size: int) -> Dict:
    """The abstract ``[chunk_size, ...]`` batch chunk of
    :func:`build_chunked_train_step`: the per-step batch with a leading
    round axis."""
    return {k: _meta((chunk_size,) + tuple(v.shape), v.dtype)
            for k, v in _train_batch_specs(plan.model, plan).items()}


def serve_input_specs(spec: ArchSpec, shape: InputShape) -> Tuple:
    """Abstract ``(params, batch, caches)`` of the prefill step, ``(params,
    batch, caches, pos)`` of the decode step (:func:`build_serve_step`), as
    meta tensors; ``pos`` is a meta int32 scalar (the step takes a Python
    int)."""
    cfg = model_for_shape(spec, shape)
    params = tf.model_init(cfg, None, device="meta")
    b = shape.global_batch
    dtype = getattr(torch, cfg.dtype)
    if shape.kind == "prefill":
        s = max_len = shape.seq_len
    else:
        s, max_len = 1, shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.input_kind == "tokens":
        batch["tokens"] = _meta((b, s), torch.int32)
    else:
        batch["embeddings"] = _meta((b, s, cfg.d_model), dtype)
    if cfg.family == "vlm":
        batch["image_embeddings"] = _meta((b, cfg.n_image_tokens,
                                           cfg.d_model), dtype)
    caches = tf.cache_init(cfg, b, max_len, dtype, device="meta")
    if shape.kind == "prefill":
        return params, batch, caches
    return params, batch, caches, _meta((), torch.int32)
