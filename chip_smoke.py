#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Usage, from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no ``ok`` line):

1. the card's name and power limit, from ``nvidia-smi``;
2. build every CUDA kernel of the port (``nvcc``, all sources at once);
3. kernels: pairdist, CWTM and median against their plain PyTorch versions
   at awkward shapes and at the main path's shapes ``[1, 13, 11958]`` (the
   CNN), ``[1, 13, 1048576]`` (the quadratic testbed) and
   ``[8, 13, 1048576]``; times of the kernel, the plain version and a
   PyTorch library call beside the least time the card could take;
4. main path, CNN: the ``fig1-alie`` RoSDHB cell (n=13, f=3, global RandK
   at 0.1, ALIE z=1.5, NNM+CWTM, beta=0.9, gamma=0.05) on the paper's CNN at
   full width (D = 11,958) for 30 rounds through ``Simulator``; the launch
   counts of pairdist and CWTM must equal the rounds, the honest loss must
   fall, and the first rounds must agree with the same rounds on the CPU;
5. main path, quadratic: the same cell at d = 1,048,576 for 10 rounds, the
   kernel path against the plain path on the same card, and the distance
   to the honest optimum must fall.

TF32 is off for matmuls and cuDNN convolutions throughout: the parity bars
are float32 ones. The last line is ``{"ok": true, "device": {...}}``; the
two before it are the ``{"kernels": [...]}`` record and the card's name and
power limit, after a ``{"summary": ...}`` line of the main-path numbers.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth and float32 outside
# the tensor cores. Both kernels are bound by bytes at the path's shapes.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

AWKWARD = [(3, 13, 3, 300), (2, 7, 0, 130), (4, 5, 2, 257),
           (1, 19, 9, 128), (5, 4, 1, 64), (2, 16, 3, 1024)]
PATH_SHAPES = [(1, 13, 11958), (1, 13, 1048576), (8, 13, 1048576)]
F = 3  # fig1-alie: f = 3 Byzantine workers, CWTM trims max(f, 1) = 3

KERNELS = {
    "pairdist": {"source": "src/repro_torch/csrc/pairdist.cu",
                 "replaces": "src/repro/kernels/pairdist/pairdist.py:29"},
    "cwtm": {"source": "src/repro_torch/csrc/sorted_weight.cu",
             "replaces": "src/repro/kernels/cwtm/cwtm.py:77"},
    "median": {"source": "src/repro_torch/csrc/sorted_weight.cu",
               "replaces": "src/repro/kernels/median/median.py:34"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------------- #
# kernels
# ----------------------------------------------------------------------- #


def bound_ms(name: str, shape, itemsize: int) -> tuple:
    """Least time for the function on these inputs: each input byte read
    once and each output byte written once at the HBM rate, against the
    operations at the float32 rate; the larger wins."""
    from repro_torch.kernels.cwtm.cwtm import n_pad_of, sort_network_compares
    b, n, d = shape
    if name == "pairdist":
        nbytes = b * n * d * itemsize + b * n * n * 4
        ops = b * d * n * (n + 1)  # n(n+1)/2 multiply-adds per coordinate
    else:
        nbytes = b * n * d * itemsize + b * d * itemsize
        ops = b * d * (2 * sort_network_compares(n_pad_of(n)) + 2 * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_case(torch, name: str, shape, f: int, dtype, timed: bool,
                seed: int) -> dict:
    from repro_torch.kernels.cwtm import cwtm_cuda, cwtm_ref
    from repro_torch.kernels.median import median_cuda, median_ref
    from repro_torch.kernels.pairdist import pairdist_cuda, pairdist_ref
    b, n, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    if name == "pairdist":
        kern, plain = (lambda: pairdist_cuda(x)), (lambda: pairdist_ref(x))
        lib = lambda: torch.cdist(x.float(), x.float())  # noqa: E731
    elif name == "cwtm":
        kern, plain = (lambda: cwtm_cuda(x, f)), (lambda: cwtm_ref(x, f))
        lib = None  # no single PyTorch call computes a trimmed mean
    else:
        kern, plain = (lambda: median_cuda(x)), (lambda: median_ref(x))
        # torch.median returns the lower middle: the same function for odd n
        lib = ((lambda: torch.median(x, dim=1).values) if n % 2 else None)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if name == "pairdist":
        scale = float((x.float() ** 2).sum(-1).max())
        tol = 1e-5 * scale
        ok = tuple(got.shape) == (b, n, n) and err <= tol
        diag = got.diagonal(dim1=1, dim2=2)
        ok = ok and bool((diag == 0).all())
        rule = f"|d| <= 1e-5 * max sq = {tol:.3g}, diagonal exactly 0"
    elif name == "cwtm":
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        rule = f"rtol = atol = {tol:g}"
    else:
        tol = 1e-6 if dtype == torch.float32 else 5e-2
        ok = bool(torch.allclose(got.float(), want.float(), rtol=0.0,
                                 atol=tol))
        rule = f"atol {tol:g}"
    rec = {"name": name, "shape": list(shape), "f": f,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tolerance": rule, "ok": ok}
    if timed:
        reps = 20 if b * n * d < 50_000_000 else 5
        rec["ms"] = time_ms(torch, kern, reps)
        rec["plain_ms"] = time_ms(torch, plain, reps)
        rec["library_ms"] = time_ms(torch, lib, reps) if lib else None
        rec["bound_ms"], rec["bound_by"] = bound_ms(name, shape,
                                                    x.element_size())
    return rec


def kernel_phase(torch) -> dict:
    results = {k: [] for k in KERNELS}
    failures = []
    for name in KERNELS:
        cases = []
        for (b, n, f, d) in AWKWARD:
            dtypes = [torch.float32] + ([torch.bfloat16]
                                        if name != "pairdist" else [])
            for dt in dtypes:
                cases.append(((b, n, d), f, dt, False))
        for shape in PATH_SHAPES:
            cases.append((shape, F, torch.float32, True))
        for i, (shape, f, dt, timed) in enumerate(cases):
            rec = kernel_case(torch, name, shape, f, dt, timed, seed=100 + i)
            results[name].append(rec)
            line = (f"kernel {name:8s} {str(tuple(shape)):22s} "
                    f"{rec['dtype']:8s} f={f} max_abs_err={rec['max_abs_err']:.3g}"
                    f" ({rec['tolerance']}) {'ok' if rec['ok'] else 'FAIL'}")
            if timed:
                lib = rec["library_ms"]
                line += (f" | kernel_ms={rec['ms']:.5f} plain_ms="
                         f"{rec['plain_ms']:.5f} library_ms="
                         f"{'null' if lib is None else f'{lib:.5f}'}"
                         f" bound_us={rec['bound_ms'] * 1e3:.3f}"
                         f" ({rec['bound_by']})")
            log(line)
            if not rec["ok"]:
                failures.append(f"{name} {shape} {rec['dtype']}")
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return results


# ----------------------------------------------------------------------- #
# main path
# ----------------------------------------------------------------------- #


def fig1_alie(use_kernels: bool = True):
    """The fig1-alie registry cell (``grid_scenarios`` defaults)."""
    from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                                  AttackConfig, SparsifierConfig)
    return AlgorithmConfig(
        name="rosdhb", n_workers=13, f=F, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=AggregatorConfig(name="cwtm", f=max(F, 1), pre_nnm=True,
                                    use_kernels=use_kernels),
        attack=AttackConfig(name="alie", z=1.5))


def replay_indices(steps: int, d: int, k: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.permutation(d)[:k] for _ in range(steps)]


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def profile_rounds(torch, sim, state, batch_fn, start: int,
                   n: int = 5) -> dict:
    """Device busy share and device time by kernel over ``n`` steady CNN
    rounds, from ``torch.profiler`` (CUPTI). The wall time includes the
    profiler's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(start, start + n):
            state, _ = sim.round(state, batch_fn(t))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"rounds": n, "wall_ms_per_round": wall_us / n / 1e3,
           "device_busy_ms_per_round": busy / n / 1e3,
           "device_events": len(spans),
           "idle_share": (1.0 - busy / wall_us) if spans else None,
           "top": [{"name": k[:80], "ms_per_round": v[0] / n / 1e3,
                    "calls_per_round": v[1] / n} for k, v in top]}
    if not spans:
        log("cnn profile: the profiler saw no device events (device time "
            "not measured)")
        return out
    log(f"cnn profile over {n} rounds: wall {out['wall_ms_per_round']:.3f} "
        f"ms/round (profiler on), device busy "
        f"{out['device_busy_ms_per_round']:.3f} ms/round, idle share "
        f"{out['idle_share']:.3f}")
    for row in out["top"]:
        log(f"  {row['ms_per_round'] * 1e3:9.2f} us/round "
            f"{row['calls_per_round']:5.1f} calls  {row['name']}")
    return out


def cnn_phase(torch, device: str = "cuda", rounds: int = 30,
              check_rounds: int = 3, per_worker: int = 800) -> dict:
    """The CNN main path on ``device`` (``cpu`` only to rehearse the
    script's logic; the kernels run only on the card)."""
    from repro_torch import kernels as K
    from repro_torch.core import Simulator, mnist_testbed
    from repro_torch.testing import ReplayDraws

    cfg = fig1_alie()
    loss_fn, params0, batch_fn, eval_fn, eval_batch = mnist_testbed(
        13, per_worker=per_worker, batch=60, seed=0, device=device)
    sim = Simulator(loss_fn, params0, cfg, eval_fn=eval_fn, device=device)
    log(f"cnn: D = {sim.d}, k = {cfg.sparsifier.k(sim.d)}")
    state = sim.init(seed=0)
    K.reset_launches()
    losses, round_ms = [], []
    for t in range(rounds):
        sync(torch, device)
        t0 = time.perf_counter()
        state, m = sim.round(state, batch_fn(t))
        sync(torch, device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = K.launches()
    acc = float(eval_fn(sim.params(state),
                        sim._on_device(eval_batch))["acc"])
    for t, (l, ms) in enumerate(zip(losses, round_ms)):
        log(f"cnn round {t:3d} honest_loss={l:.6f} ms={ms:.3f}")
    steady = sorted(round_ms[1:])[len(round_ms[1:]) // 2]
    log(f"cnn: launches {launches}, first round {round_ms[0]:.3f} ms, "
        f"median round {steady:.3f} ms, eval acc {acc:.4f}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"cnn: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"cnn: honest loss did not fall: {losses}")
    expected = rounds if device == "cuda" else 0
    for k in ("pairdist", "cwtm"):
        if launches[k] != expected:
            raise AssertionError(f"cnn: {k} launched {launches[k]} times "
                                 f"in {rounds} rounds")

    prof = (profile_rounds(torch, sim, state, batch_fn, rounds)
            if device == "cuda" else None)

    # the same first rounds on the CPU (plain versions), same draws
    k = cfg.sparsifier.k(sim.d)
    curves = {}
    for dev in (device, "cpu"):
        loss_fn, params0, batch_fn, _, _ = mnist_testbed(
            13, per_worker=per_worker, batch=60, seed=0, device=dev)
        s = Simulator(loss_fn, params0, cfg, device=dev)
        st = s.init(draws=ReplayDraws(
            dev, permutations=replay_indices(check_rounds, s.d, k, 7)))
        st, ms = s.rollout(st, batch_fn, steps=check_rounds)
        curves[dev] = [float(v) for v in ms["loss"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves[device],
                                                 curves["cpu"]))
    log(f"cnn: card vs cpu honest loss over {check_rounds} rounds, max rel "
        f"diff {rel:.3g} (bound 1e-4: float32 convolutions and sums in "
        f"other orders, no TF32)")
    if rel > 1e-4:
        raise AssertionError(f"cnn: card and cpu disagree: {curves}")
    return {"rounds": rounds, "launches": launches, "losses": losses,
            "round_ms": round_ms, "median_round_ms": steady, "acc": acc,
            "cpu_rel_diff": rel, "profile": prof}


def quadratic_phase(torch, device: str = "cuda", d: int = 1048576,
                    rounds: int = 10) -> dict:
    from repro_torch import kernels as K
    from repro_torch.core import Simulator, quadratic_testbed

    out = {}
    finals = {}
    for use_kernels in (True, False):
        cfg = fig1_alie(use_kernels)
        loss_fn, params0, batch_fn, tg = quadratic_testbed(13, d=d, seed=0,
                                                           device=device)
        sim = Simulator(loss_fn, params0, cfg, device=device)
        state = sim.init(seed=0)
        opt = tg[F:].mean(dim=0)
        dist0 = float(torch.linalg.vector_norm(state.params_flat - opt))
        K.reset_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        round_ms = []
        for t in range(rounds):
            sync(torch, device)
            t0 = time.perf_counter()
            state, _ = sim.round(state, batch_fn(t))
            sync(torch, device)
            round_ms.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(round_ms[1:])[len(round_ms[1:]) // 2]
        peak = (torch.cuda.max_memory_allocated() / 2**20
                if device == "cuda" else float("nan"))
        launches = K.launches()
        dist = float(torch.linalg.vector_norm(state.params_flat - opt))
        tag = "kernel" if use_kernels else "plain"
        log(f"quadratic d={d} {tag}: first round {round_ms[0]:.3f} ms, "
            f"median round {wall:.3f} ms, peak device "
            f"memory {peak:.1f} MiB, distance to the honest optimum "
            f"{dist0:.4f} -> {dist:.4f}, launches {launches}")
        if not dist < dist0:
            raise AssertionError(f"quadratic {tag}: distance did not fall")
        expected = rounds if use_kernels and device == "cuda" else 0
        if launches["pairdist"] != expected or launches["cwtm"] != expected:
            raise AssertionError(f"quadratic: launches {launches} != "
                                 f"{rounds} rounds")
        finals[tag] = state.params_flat
        out[tag] = {"ms_per_round": wall, "dist0": dist0, "dist": dist,
                    "launches": launches, "peak_mib": peak}
    diff = float((finals["kernel"] - finals["plain"]).abs().max())
    scale = float(finals["plain"].abs().max())
    log(f"quadratic: kernel vs plain path after {rounds} rounds, max |d| "
        f"{diff:.3g} of max |w| {scale:.4f} (bound 1e-5 relative: the "
        f"paths differ only in float32 summation order inside the "
        f"aggregation, about 1e-7 relative a round)")
    if diff > 1e-5 * scale:
        raise AssertionError("quadratic: kernel and plain paths disagree")
    out["max_abs_diff"] = diff
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall")
    for name, (secs, report) in build.BUILD_LOG.items():
        log(f"build {name}: {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {line.strip()}")

    results = kernel_phase(torch)
    cnn = cnn_phase(torch)
    quad = quadratic_phase(torch)
    record = {"kernels": []}
    for name, meta in KERNELS.items():
        recs = [r for r in results[name] if "ms" in r]
        head = recs[0]  # the CNN path's shape
        record["kernels"].append({
            "name": name, "route": "cuda", **meta,
            "launches": cnn["launches"][name],
            "launches_quadratic": quad["kernel"]["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "max_abs_err")} for r in recs]})
    log(json.dumps({"summary": {
        "cnn": {k: cnn[k] for k in ("rounds", "median_round_ms", "acc",
                                    "cpu_rel_diff", "profile")},
        "quadratic": {k: {m: quad[k][m] for m in ("ms_per_round",
                                                  "peak_mib")}
                      for k in ("kernel", "plain")}}}))
    log(json.dumps(record))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
