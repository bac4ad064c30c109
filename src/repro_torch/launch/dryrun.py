"""Dry run of the train and serve steps on one card (counterpart of
``repro.launch.dryrun``).

For an (architecture, input shape) pair it builds the plan and the steps'
abstract inputs (``launch.steps.train_input_specs``,
``serve_input_specs``) as ``meta`` tensors, with no mesh, and reports:

* the parameter counts: the analytic ``count_params`` (all and active, as
  the reference; it leaves out the norms) and the built model's elements;
* the server banks' bytes (``core.algorithms.server_state_bytes``) and the
  state one card holds: the float32 master parameters, the step's bf16
  working copy of them, the banks (and the adversary's memory), the batch,
  on train shapes the step's own transients (:func:`step_transients`: the
  gradient bank, or on the streamed route the payload, one raveled row,
  one worker's gradients and the round's direction) and, on serve shapes,
  the caches; of these, ``held_bytes``: what a run holds between steps
  (the parameters, the banks and the adversary's memory; on serve shapes
  the parameters and the caches); ``state_bytes_total``: what the step
  holds at its fullest (on train shapes the held state, the batch and the
  most of the transients held at once); ``state_fits``: whether that fits
  the card's 80 GB. That is a floor, not the step's peak: the activations
  and the round's smaller temporaries come on top (``chip_smoke.py``
  prints the peak the card reads beside it at the cuts it runs), so a
  state that does not fit rules a pair out and one that fits does not
  rule it in;
* ``model_flops`` and the FLOPs of one step, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the step run on meta
  tensors (the model's loss and gradient of one worker, times the
  workers; or the prefill or decode step), plus the server round;
* the step's eager bytes: every aten operation's inputs and outputs, as
  PyTorch runs them one by one (views move nothing), unfused;
* the :class:`roofline.Roofline` of those terms against
  ``detect_hardware(--hardware)`` (the H100 by default).

The model runs on meta as it runs on the card, except that meta tensors
take the plain attention (``layers.causal_attention``, the flash kernels
take CUDA tensors only): the same FLOPs, and the scores' bytes the kernel
never writes. The server round's kernels take CPU or CUDA tensors only, so
the round is counted from its shapes (``"counted": "shapes"``): the ravel
into the bank, compress, the attack, the momentum, the aggregation
(``roofline.aggregation_roofline``) and the update. No model of the port
calls ``.item()`` or another data-dependent operation on this path, so
nothing else is counted from shapes.

FLOPs and bytes do not depend on the device, so the dry run runs on the
CPU::

    python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json

Options: ``--algo rosdhb|dasha|robust_dgd|dgd`` (train shapes; default
rosdhb), ``--momentum-dtype bfloat16|float32|float16|float8_e4m3fn``,
``--server-compute-dtype``, ``--ratio`` (Block-RandK k/d), ``--hardware``
(a ``roofline.KNOWN_HARDWARE`` name), and ``--n-layers``, ``--n-workers``
and ``--global-batch`` for the cuts the card runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.configs.base import ArchSpec, InputShape, model_for_shape
from repro_torch.core import algorithms as A
from repro_torch.core import compression as C
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.models import transformer as tf
from repro_torch.utils import tree as T

#: The card's memory: 80 GB of HBM3 (NVIDIA's H100 data sheet).
CARD_BYTES = 80e9


class EagerBytes(TorchDispatchMode):
    """Counts each aten operation's input and output bytes (an in-place
    operation's tensor as read and written), views and metadata operations
    as nothing: the bytes an eager, unfused run moves."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.__name__ not in _FREE:
            self.bytes += sum(t.nbytes for t in _pt_leaves((args, kwargs,
                                                            out))
                              if isinstance(t, torch.Tensor))
            self.ops += 1
        return out


#: aten operations that make or describe a tensor without moving its data.
_FREE = {"empty.memory_format", "empty_strided.default", "detach.default",
         "lift_fresh.default", "_local_scalar_dense.default",
         "sym_size.int", "sym_stride.int", "sym_numel.default",
         "sym_storage_offset.default", "is_same_size.default"}


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in T.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _spec(arch_id: str, n_layers: Optional[int]) -> ArchSpec:
    spec = get_arch(arch_id)
    if n_layers is None:
        return spec
    return dataclasses.replace(spec, model=spec.model.with_overrides(
        n_layers=n_layers))


def _shape(name: str, global_batch: Optional[int]) -> InputShape:
    shape = INPUT_SHAPES[name]
    if global_batch is None:
        return shape
    return dataclasses.replace(shape, global_batch=global_batch)


def trace_train(plan: S.TrainPlan, state, batch) -> Dict:
    """FLOPs and eager bytes of one worker's bf16 working copy, loss and
    gradient on meta tensors, and the counts of the whole step's model
    part (times the workers)."""
    fc, nb = FlopCounterMode(display=False), EagerBytes()
    with fc, nb:
        half = [(p.to(torch.bfloat16) if p.dtype == torch.float32 else p)
                .detach().requires_grad_()
                for p in T.tree_leaves(state.params)]
        tree = T.tree_unflatten(plan.flat_spec.treedef, half)
        loss = tf.lm_loss(tree, plan.model, {k: v[0] for k, v in
                                             batch.items()})
        torch.autograd.grad(loss, half)
    n = plan.n_workers
    return {"flops": fc.get_total_flops() * n, "bytes": nb.bytes * n,
            "ops": nb.ops * n, "workers_traced": 1}


def server_counts(plan: S.TrainPlan) -> Dict:
    """FLOPs and bytes of the server round and the update, from shapes:
    each input read once and each output written once, piece by piece;
    the kernels' pieces are ``roofline``'s counts of their work (the ones
    the kernels' bounds take). The gradients come as bf16 (the working
    copy's) and are raveled into the ``[n, D]`` wire bank (the banks'
    dtype)."""
    algo, sp = plan.algo, plan.algo.sparsifier
    n, f, d = plan.n_workers, algo.f, plan.bank_width
    p = plan.flat_spec.size
    w = A.BANK_DTYPES[algo.momentum_dtype].itemsize  # wire and banks
    pieces: Dict[str, Dict[str, float]] = {}

    def put(name, nbytes, flops=0.0):
        pieces[name] = {"bytes": float(nbytes), "flops": float(flops)}

    put("ravel", n * p * 2 + n * d * w)
    if algo.name == "dasha":
        # m = g + (1-a)(m' - g'), x = (m - m') + b(m' - h'), h = h' + C(x)
        put("dasha_wire", n * d * (w + 3 * 4 + 2 * w) + n * d * (4 + 2 * w),
            8 * n * d)
        put("compress", 2 * n * d * 4, n * d)
        put("attack", n * d * 4 + f * d * 4, 3 * n * d)
    elif A._payload_route(algo, d):
        bs = sp.block_size
        kb = max(1, int(round(sp.ratio * (d // bs))))  # global ids
        put("compress", *R.compress_work(n, kb, bs, w, kb))
        put("attack", (n + f) * kb * bs * w, 3 * n * kb * bs)
        # by windows (algorithms._payload_window) the same bytes: the
        # windows partition the bank and its float32 momenta, and their
        # CWTM launches the aggregation's
        put("momentum", *R.momentum_work(n, d, kb, bs, w, w, kb, w != 4))
    else:  # the dense wire: every value of the bank moves
        put("compress", 2 * n * d * w, n * d)
        put("attack", n * d * w + f * d * w, 3 * n * d)
        if algo.name == "rosdhb":
            put("momentum", 3 * n * d * w + (n * d * 4 if w != 4 else 0),
                2 * n * d)
    if algo.name != "dgd":  # the plan's CWTM on float32 rows
        put("aggregation", *R.sorted_weight_work(1, n, d, 4))
    else:
        put("aggregation", n * d * 4 + d * 4, n * d)
    put("update", 3 * p * 4, 2 * p)
    return {"flops": sum(v["flops"] for v in pieces.values()),
            "bytes": sum(v["bytes"] for v in pieces.values()),
            "pieces": pieces}


def step_transients(plan: S.TrainPlan, half: int) -> tuple:
    """What the train step (``launch.steps.build_train_step``) allocates
    beside the held state, from shapes: ``(pieces, the most of them held at
    once)``. ``half``: one worker's bf16 working copy (and so its bf16
    gradients). On the streamed route (``algorithms.streams_payload``) the
    round's ``payload``, one worker's ``gradients`` and then either its
    working copy (until the gradient exists) or its raveled ``row`` in the
    wire dtype, and, in the round, the float32 ``direction`` and a
    window's float32 ``momenta`` (banks narrower than float32); on the bank
    route the ``[n, D]`` ``gradient_bank``, the working copy and one
    worker's gradients. Activations and the round's smaller temporaries
    come on top: the sum is a floor of the step's peak."""
    algo, sp = plan.algo, plan.algo.sparsifier
    n, d = plan.n_workers, plan.bank_width
    wire = A.BANK_DTYPES[algo.momentum_dtype].itemsize
    if not A.streams_payload(algo, d):
        pieces = {"gradient_bank": n * d * wire, "gradients": half}
        return pieces, pieces["gradient_bank"] + half + half
    window = A._payload_window(algo, d) * sp.block_size
    pieces = {"payload": n * C.payload_width(d, sp) * wire,
              "gradients": half, "row": d * wire, "direction": d * 4,
              "momenta": n * window * 4 if wire != 4 else 0}
    return pieces, pieces["payload"] + max(
        half + half, half + pieces["row"],
        pieces["direction"] + pieces["momenta"])


def trace_serve(spec: ArchSpec, shape: InputShape, args) -> Dict:
    """FLOPs and eager bytes of one prefill or decode step on meta
    tensors."""
    step = S.build_serve_step(spec, shape)
    call = args[:3] + ((shape.seq_len - 1,) if shape.kind == "decode"
                       else ())
    fc, nb = FlopCounterMode(display=False), EagerBytes()
    with fc, nb:
        step(*call)
    return {"flops": fc.get_total_flops(), "bytes": nb.bytes,
            "ops": nb.ops}


def run_one(arch_id: str, shape_name: str, *, algo: str = "rosdhb",
            momentum_dtype: str = "bfloat16",
            server_compute_dtype: str = "float32",
            ratio: Optional[float] = None, hardware: Optional[str] = "h100",
            n_layers: Optional[int] = None, n_workers: int = 8,
            global_batch: Optional[int] = None,
            verbose: bool = True) -> Dict:
    """Build and count one (arch, shape) pair on meta; returns the report.
    ``n_layers``, ``n_workers`` and ``global_batch`` cut the pair to what
    a run on the card takes (``launch.train``'s flags)."""
    hw = R.detect_hardware(hardware)
    spec = _spec(arch_id, n_layers)
    shape = _shape(shape_name, global_batch)
    cfg = model_for_shape(spec, shape)
    t0 = time.perf_counter()
    report: Dict = {"arch": arch_id, "shape": shape_name,
                    "mesh": f"1x{hw.name.upper()}", "n_chips": 1,
                    "kind": shape.kind, "n_layers": cfg.n_layers,
                    "global_batch": shape.global_batch,
                    "seq_len": shape.seq_len,
                    "algo": algo if shape.kind == "train" else None}
    if shape.kind == "train":
        overrides = {"name": algo, "momentum_dtype": momentum_dtype,
                     "server_compute_dtype": server_compute_dtype}
        if ratio is not None:
            overrides["sparsifier"] = C.SparsifierConfig(
                kind="block", ratio=ratio, block_size=512)
        plan = S.make_train_plan(spec, shape, overrides, n_workers=n_workers)
        state, batch = S.train_input_specs(plan)
        params = state.params
        model = trace_train(plan, state, batch)
        server = server_counts(plan)
        bank_bytes = A.server_state_bytes(plan.algo, plan.bank_width)
        half = sum(t.numel() * 2 for t in T.tree_leaves(params)
                   if t.dtype == torch.float32)
        state_bytes = {"params": _nbytes(params), "working_copy": half,
                       "banks": bank_bytes,
                       "attack": _nbytes(state.server.attack),
                       "batch": _nbytes(batch)}
        held = (state_bytes["params"] + bank_bytes
                + state_bytes["attack"])
        # the step's floor: the held state, the batch and the most of the
        # step's transients it holds at once
        step_bytes, transient = step_transients(plan, half)
        state_bytes.update(step_bytes)
        total = held + state_bytes["batch"] + transient
        report.update(n_workers=plan.n_workers, local_batch=plan.local_batch,
                      momentum_dtype=momentum_dtype,
                      server_compute_dtype=server_compute_dtype,
                      flat_size=plan.flat_spec.size,
                      bank_width=plan.bank_width, bank_bytes=bank_bytes,
                      payload_route=A._payload_route(plan.algo,
                                                     plan.bank_width),
                      streamed=A.streams_payload(plan.algo,
                                                 plan.bank_width))
    else:
        args = S.serve_input_specs(spec, shape)
        params, batch, caches = args[:3]
        model = trace_serve(spec, shape, args)
        server = {"flops": 0.0, "bytes": 0.0, "pieces": {}}
        state_bytes = {"params": _nbytes(params), "batch": _nbytes(batch),
                       "caches": _nbytes(caches)}
        held = state_bytes["params"] + state_bytes["caches"]
        total = sum(state_bytes.values())
    mf = R.model_flops(cfg, shape)
    rf = R.Roofline(flops_per_chip=model["flops"] + server["flops"],
                    hbm_bytes_per_chip=model["bytes"] + server["bytes"],
                    wire_bytes_per_chip=0.0, model_flops_total=mf,
                    n_chips=1, spec=hw)
    report.update({
        "ok": True,
        "n_params": R.count_params(cfg),
        "n_params_active": R.count_params(cfg, active_only=True),
        "n_elements": T.tree_size(params),
        "state_bytes": state_bytes, "state_bytes_total": total,
        "held_bytes": held, "card_bytes": CARD_BYTES,
        "state_fits": total <= CARD_BYTES,
        "model_flops": mf,
        "step_flops": {"model": model["flops"], "server": server["flops"]},
        "eager_bytes": {"model": model["bytes"], "server": server["bytes"],
                        "label": "eager, unfused"},
        "aten_ops": model["ops"],
        "counted": "shapes",
        "model_counted": "traced",
        "server_pieces": server["pieces"],
        "count_s": time.perf_counter() - t0,
        "roofline": rf.as_dict(),
    })
    if verbose:
        print(f"[dryrun] {arch_id:22s} {shape_name:12s} {report['mesh']} OK "
              f"state={total / 2**30:8.2f}GiB "
              f"state_fits={report['state_fits']!s:5s} "
              f"compute={rf.compute_s * 1e3:11.3f}ms "
              f"mem={rf.memory_s * 1e3:11.3f}ms -> {rf.bottleneck} "
              f"({report['count_s']:.1f}s)", flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--algo", default="rosdhb",
                   choices=["rosdhb", "dasha", "robust_dgd", "dgd"])
    p.add_argument("--momentum-dtype", default="bfloat16",
                   choices=list(A.BANK_DTYPES))
    p.add_argument("--server-compute-dtype", default="float32",
                   choices=list(A.COMPUTE_DTYPES))
    p.add_argument("--ratio", type=float, default=None)
    p.add_argument("--hardware", default="h100",
                   choices=sorted(R.KNOWN_HARDWARE))
    p.add_argument("--n-layers", type=int, default=None)
    p.add_argument("--n-workers", type=int, default=8)
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    reports, failures = [], 0
    for arch in archs:
        for shape in shapes:
            try:
                reports.append(run_one(
                    arch, shape, algo=args.algo,
                    momentum_dtype=args.momentum_dtype,
                    server_compute_dtype=args.server_compute_dtype,
                    ratio=args.ratio, hardware=args.hardware,
                    n_layers=args.n_layers, n_workers=args.n_workers,
                    global_batch=args.global_batch))
            except Exception as e:  # noqa: BLE001 - reported per pair
                failures += 1
                print(f"[dryrun] {arch} {shape} FAILED: {e}")
                traceback.print_exc()
                reports.append({"arch": arch, "shape": shape,
                                "mesh": f"1x{args.hardware.upper()}",
                                "ok": False, "error": str(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"hardware": args.hardware,
                       "reckoned_on": "meta tensors (shapes), not a card",
                       "reports": reports}, f, indent=1)
        print(f"[dryrun] wrote {len(reports)} reports to {args.out}")
    print(f"[dryrun] {len(reports) - failures}/{len(reports)} OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
