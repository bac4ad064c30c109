#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Usage, from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no ``ok`` line):

1. the card's name and power limit, from ``nvidia-smi``;
2. build every CUDA kernel of the port (``nvcc``, one process per source,
   all started together);
3. kernels: pairdist, CWTM and median against their plain PyTorch versions
   at awkward shapes, at the edges of pairdist's launch plan and of the
   sorted-rank kernel's block sizes, and at the main paths' shapes
   ``[1, 13, 11958]`` (the CNN), ``[1, 13, 1048576]`` (the quadratic
   testbed), ``[8, 13, 1048576]``, for CWTM ``[1, 8, 416179200]`` (the
   LLM step), ``[1, 8, 59784192]`` (the audio train step), the families'
   train steps' ``[1, 8, 1026698240]``, ``[1, 8, 257647616]`` and ``[1, 8,
   902776320]`` and the grid's ``[36, 13, 11958]`` (pairdist) and
   ``[18, 13, 11958]`` (CWTM, median), where each is timed as a loop (CUDA events) and by the host
   (``perf_counter``), beside ``torch.cdist`` or ``torch.median``; pairdist
   is bitwise equal across two launches, symmetric with an exact zero
   diagonal, and leaves its ticket counters at zero; then the wrappers'
   host cost piece by piece; Block-RandK
   compress and decompress bitwise against theirs at awkward shapes and at
   the LLM step's ``[8, 416179200]`` with 40,642 blocks of 512 and the
   audio train step's ``[8, 59784192]`` with 5,838, compress alone at the
   families' train steps' banks and at one row of dbrx_132b's ``[1,
   4492216320]`` float8 bank (the streamed step compresses a worker's row
   at a time; 64-bit offsets past 2^32 bytes); the
   momentum update (``momentum_scatter``) bitwise against its plain
   version at awkward shapes (global and local ids, float32 and bfloat16
   banks, beta 0, 0.9 and 0.99, one block and every block, banks holding
   -0.0), at the LLM step's bank in float32 and in bfloat16, at the
   audio train step's in float32 and at the families' train steps' banks
   in their dtypes; compress, decompress and the momentum update in
   float16 and float8_e4m3fn banks bitwise against their plain versions
   at awkward shapes and at the LLM step's bank (timed), values past
   float8's 448 among them, and the momentum kernel's float8 store held
   bit for bit to the reference's cast (``utils.dtypes.to_float8``: NaN
   past 464, for +-inf and for NaN) at its edges; one RoSDHB
   server round at ``[8, 416179200]`` on the payload route against the
   dense round (momentum bitwise, direction within rtol 1e-5); flash
   attention forward and backward against the plain version in float32 at
   awkward shapes (ragged lengths, GQA, MQA, windows, offsets, head dims
   64/80/128/256, the Hopper kernels' tile edges), at transformer-table1's
   folded ``[288, 32, 2, 64]``, at the audio train step's ``[1, 4096, 24,
   64]``, at zamba2's ``[1, 4096, 32, 112]`` (unpadded), at gemma_2b's
   ``[1, 4096, 8, 256]`` with one kv head (dk/dv split 9 ways, dq from
   dS^T), at the vlm's, qwen25_3b's, mistral's and dbrx_132b's ``[1,
   4096, 48, 128]`` (8 kv heads) and at the LLM step's
   ``[1, 4096, 32, 80]``, and where the bf16 dk/dv blocks split
   (``FLASH_SPLIT``, 112 among them), two backward runs bitwise equal in
   every bf16 case; the float32 kernels (``csrc/flash_attention_f32.cu``)
   on every awkward case, at head dim 112 unpadded, on the dk/dv split's awkward
   shapes and, timed, at zamba2's (112, unpadded), gemma_2b's (its dk/dv
   blocks split), the vlm's ``[1, 4096, 32, 128]`` (8 kv heads) and the
   LLM step's shapes, within 1e-5 of the plain version's largest entry
   (their launches on their own counters), two backward runs bitwise equal
   in every case, beside the float64 errors of both (dk's among them) at
   the timed shapes; the flash kernels' ptxas registers and no spill at any head
   dim, the bf16 kernels' SASS must hold ``wgmma`` (HGMMA) and TMA
   (UTMALDG) and no WMMA (HMMA), the float32 kernels' FFMA and no HGMMA,
   HMMA or tf32 instruction. Times of the kernel, the plain version and a
   PyTorch library call beside the least time the card could take;
4. main path, CNN: the ``fig1-alie`` RoSDHB cell (n=13, f=3, global RandK
   at 0.1, ALIE z=1.5, NNM+CWTM, beta=0.9, gamma=0.05) on the paper's CNN at
   full width (D = 11,958) for 30 rounds through ``Simulator``; the launch
   counts of pairdist and CWTM must equal the rounds, the honest loss must
   fall, and the first rounds must agree with the same rounds on the CPU;
5. main path, quadratic: the same cell at d = 1,048,576 for 10 rounds, with
   RoSDHB and then with dasha (Byz-DASHA-PAGE), each the kernel path
   against the plain path on the same card, and the distance to the honest
   optimum must fall;
6. main path, LLM: ``repro_torch.launch.train`` on full-width stablelm_3b
   cut to 2 layers (D = 416,179,200), seq 4096, n = 8 workers of one
   sequence, f = 1, ALIE, CWTM, global Block-RandK at 0.05, for 8 steps on
   the payload route; every step's honest loss, |R| and time, the peak
   device memory and a profiled window; the launch counts (flash forward
   and backward = layers x workers x steps, compress = workers x steps
   (the streamed step compresses each worker's row as its gradient
   exists), momentum_scatter = CWTM = steps, decompress = 0), a finite
   falling loss, and the first 2
   steps against the plain path. Then the launcher's options: 2 steps with
   ``--local-masks`` (the dense wire: decompress = 2), 4 steps with
   ``--momentum-dtype bfloat16``, 2 steps each with ``--momentum-dtype
   float16`` and ``float8_e4m3fn`` (compress 16, momentum_scatter and
   CWTM once a window), 2
   steps each of ``--algo dasha`` at ``float32``, ``bfloat16`` and
   ``float8_e4m3fn`` banks (the round by column slices, each slice's new
   banks written over the old: CWTM once a slice, 25 a step, no
   Block-RandK kernel; its peak memory and payload printed beside
   RoSDHB's), each within rel 5e-3 (loss) and 2e-2 (|R|) of the plain path
   at its dtype, and 8 steps with
   ``--stream --chunk-size
   4 --prefetch-depth 2 --checkpoint``, bitwise equal to a per-step run over
   the same ``(seed, t)`` batches, its checkpoint restored bitwise; then
   the cut at model dtype float32 (``launch.train.run(dtype="float32")``):
   2 steps with the float32 flash kernels 16 times a step each way and
   the bf16 ones not at all, finite losses, against 2 plain steps within
   the same bounds, step ms and peak memory;
7. the Table-1 grid engine (``repro_torch.core.sweep``): the ``table1``
   product (rosdhb, dasha, robust_dgd, dgd x alie, foe, signflip x cwtm,
   median; dgd takes the mean: 21 cells) on the CNN, 2 seeds, as 42 lanes
   of one bank: the plan and the kernels' batched shapes (pairdist over 36
   lanes, CWTM and the median over 18), every lane's first 3 rounds against
   the CPU's plain path (rel 1e-4) and against the plain path on the card,
   100 timed rounds (ms a round, lane-rounds/s, peak memory, one launch of
   each kernel a round, the fused eval's accuracy, the result rows with
   bytes to an honest loss of 1), every rosdhb lane's honest loss finite and
   falling, three lanes against their lone ``Simulator.rollout`` (1e-5 of
   max |w|) and a profiled window; then ``mimic-iid`` on the CNN (4 lanes,
   30 rounds) and ``mixed-attacks`` on the quadratic testbed (36 lanes, 20
   rounds), kernel path against plain path (1e-5 of max |w|), one launch
   a branch a round whatever the lane count (``python3 chip_smoke.py grid``
   runs this phase alone);
8. the streaming parameter server (``repro_torch.serve``) at d =
   1,048,576: ``fig1-alie`` served in process for 20 rounds, each round's
   parameters bitwise ``Simulator.rollout``'s on the same draws, one
   pairdist and one CWTM launch a round; the ``rosdhb/foe/median`` cell
   (one median launch a round), kernel path against plain path (1e-5 of
   max |w|); the loopback and TCP transports bitwise the in-process server;
   30 rounds of partial participation (drop 0.2, late 0.1, staleness window
   2, timeout 50 ms) with one pairdist and one CWTM launch per fired round,
   a falling honest loss and a spread participation histogram, then the
   same behaviour driven lock-step, kernel path against plain path; the
   ``combined`` chaos scenario over TCP (every round terminated, a step
   built per server instance, injected faults, client retries) and the
   kill-restart resuming bitwise; bfloat16 server arithmetic, kernel path
   against plain path; rounds/s, updates/s, round latency, step time and
   peak memory of each transport, and one round split into its host pieces
   (``python3 chip_smoke.py serve`` runs this phase alone);
9. streamed rollouts (``Simulator.rollout_streaming``), the transformer
   testbed and the cost model: ``fig1-alie`` on the CNN for 100 rounds
   (chunks of 16, 2 prefetched, a 4-round tail), pre-stacked and then from
   a pure batch function through the prefetch thread, each bitwise
   ``Simulator.rollout`` with one pairdist and one CWTM launch a round; the
   time and bytes to accuracy 0.85 with one eval a 10-round chunk (capped
   at 600 rounds), its metrics bitwise the prefix of a fixed run whose
   per-chunk eval first reaches 0.85 where the stream stopped; the
   ``table1`` grid streamed (42 lanes, 40 rounds, chunks of 8) bitwise the
   materialised grid, one launch of each kernel a round; the
   ``transformer-table1`` spec streamed through ``run_scenarios`` (8 lanes
   of 9 workers, 16 rounds, chunks of 4): one flash forward and one
   backward launch a layer a round over all lanes and workers (the fused
   eval adds one forward a layer), one pairdist and one CWTM a round, and
   every lane's first 2 rounds against the plain path on the card and on
   the CPU (rel 5e-3 loss); the host-memory gate (``stack_batches`` of 48
   rounds under 128 KiB refused, the stream completing under it); and the
   cost model's calibration (``python3 chip_smoke.py stream`` runs this
   phase alone);
10. prefill and greedy decode (``repro_torch.launch.serve``, batch 4,
   prompt 32, 8 tokens): llama32_vision_11b at full width and depth in
   bfloat16 (prefill ms, decode ms a step, tokens/s, peak memory), the
   prefill's and each decode step's hidden states against the train-mode
   forward over the same teacher-forced sequence (the flash kernel: one
   launch a self-attention layer, 32) within 5e-2 of max |h| and the same
   greedy tokens again; the same at full width cut to one group (5 layers)
   in float32 within 1e-4, its train-mode forward on the float32 flash
   kernel (4 launches, one a self-attention layer); qwen25_3b at full depth under ``long_500k`` (the
   8,192-slot ring) through a 9,216-token prompt and 16 decode steps
   against the windowed train-mode forward; gemma_2b, musicgen_medium and
   mistral_large_123b (4 layers), timed and held the same way;
   musicgen_medium's train path through ``repro_torch.launch.train`` (2
   layers, seq 4096, 8 workers, f = 1, 4 steps: flash forward and backward
   64 each, compress 32, ``momentum_scatter`` and CWTM 4), its first 2 steps
   against the plain path (``python3 chip_smoke.py decode`` runs this
   phase alone, with its profiled decode steps);
11. the MoE, MLA, SSM and hybrid families (``families``): dbrx_132b at full
   width cut to 4 layers, deepseek_v2_lite_16b, mamba2_1_3b and zamba2_7b
   at full depth, served through ``repro_torch.launch.serve`` in bfloat16
   (prefill ms, decode ms a step, tokens/s, peak memory; the tokens
   reproduced bit for bit; prefill and each decode step against the
   train-mode forward within 5e-2 of max |h|, the MoE ones replaying the
   serve run's expert choices, with the choices the train-mode forward
   would flip reported; zamba2's at full depth within 1.5 times its own
   bfloat16 floor measured in the same call, the floor within 0.1 of max
   |h|, see ``FAMILY_BF16_FLOOR``; flash forward launches 4, 0, 0 and 13, the
   last at head dim 112; mamba2's and zamba2's gap
   logged block by block, ``FAMILY_LAYER_GAPS``); the cuts of ``FAMILY_CUTS``
   (float32 within 1e-4, zamba2 at full depth among them; zamba2 at 7
   layers in bfloat16 within 5e-2); mamba2_1_3b through a 4,100-token
   prompt (16 chunks of 256 and a padded 17th) and 16 steps; the train
   paths of deepseek_v2_lite_16b (2 layers, bfloat16 banks), mamba2_1_3b
   (2 layers), zamba2_7b (6 layers, bfloat16 banks) and gemma_2b (2
   layers, bfloat16 banks: head dim 256, one kv head), the vlm (5 layers,
   float8 and bfloat16 banks), qwen25_3b, mistral_large_123b (1 layer,
   float8 banks) and dbrx_132b (1 layer, float8 banks: the streamed step
   holds no gradient bank, so it fits one card) through
   ``repro_torch.launch.train`` (seq 4096, 8 workers, f = 1, 4 steps:
   compress once a worker, ``momentum_scatter`` and CWTM once a window,
   decompress 0, flash forward and backward 32 each for zamba2, 64 each
   for gemma_2b), each peak and held MiB beside the dry run's reckoning,
   their first 2 steps against
   the plain path; then profiled decode steps of llama32_vision_11b,
   musicgen_medium and the four families' models;
12. the paper's experiments (``paper``; it runs after the stream phase):
   ``benchmarks/bench_torch_run.py`` on the card, i.e. fig1 quick (bytes
   to accuracy 0.85 on the CNN, ratios 0.05 and 1.0 x f 0 and 5, 400
   rounds), table1 (the five quadratic cells, 800 rounds, and its
   ordering assert), the beta ablation, global against local masks, the
   breakdown and heterogeneity sweeps and the aggregator rules at ``[20,
   1000000]``, every CSV row printed with each suite's wall time; every
   row finite (fig1's never-reached bytes and a blown-up breakdown
   distance excepted, as in the reference's protocol) with one pairdist
   and one CWTM launch a round on the NNM+CWTM cells, none on dgd's mean,
   one CWTM a round on fig1's cells, each row's count from its rules'
   kernels times its rounds; then pairdist, CWTM and the median against
   their plain versions at every shape the suites give them, the six
   aggregator rules at ``[20, 1000000]`` against the CPU's, and, card
   against the port's CPU path on the same targets and draws, table1's
   five rows, beta 0.9's three lanes, a global_vs_local and a breakdown
   cell at 100 rounds (rel 1e-4) and fig1's (0.05, 5) cell at 20
   (``python3 chip_smoke.py paper`` runs this phase alone);
13. the reference's four remaining benches (``benches``; after the paper
   phase): ``benchmarks/bench_torch_{llm,serve,chaos,sweep}.py`` with
   their gates (streamed rollouts bitwise, the host budget, the early exit
   no slower than the fixed run x 1.05; the served trajectory bitwise the
   simulator's, one step a server; loopback and TCP bitwise, every chaos
   scenario terminating, the kill-restart bitwise, the combined loss
   within rtol 0.1; attack fusion at least 1.2x sequential runs, one
   launch of each kernel a round for a whole bank, the cost model's plan
   the measured-best within 1.25x), each JSON and the sweep's cost model
   written to ``build/chip_smoke/``, each bench's kernels launched
   (``python3 chip_smoke.py benches`` runs this phase alone);
14. the roofline (``roofline``): ``repro_torch.launch.roofline.
   detect_hardware()`` must read ``h100``; the device-to-device copy
   bandwidth beside the published 3.35 TB/s (a reading, not a bound; every
   bound of this script takes the published peaks of that module);
   ``benchmarks/bench_torch_kernels.py`` with its gates (parity rel 1e-5,
   the kernel path at least 0.95x the plain rules at Table-1's shape and
   faster at d >= 1e6), its JSON written to ``build/chip_smoke/``; and
   the dry run (``repro_torch.launch.dryrun.run_one``) at the LLM step's
   cut at each bank dtype, dasha's two cuts and the families' train cuts:
   each predicted
   held state (parameters, banks, the adversary's memory) within rel
   1e-2 of the device bytes the run's setup left allocated, and each
   predicted state no larger than the peak memory the run read (``python3
   chip_smoke.py roofline`` runs this phase alone, with one LLM step for
   its readings);
15. the device µs and device kernels per call of pairdist, CWTM, median,
   the flash forward and backward (at ``[1, 4096, 32, 80]``, ``[1, 4096,
   24, 64]``, zamba2's ``[1, 4096, 32, 112]``, gemma_2b's ``[1, 4096, 8,
   256]``, the vlm's ``[1, 4096, 32, 128]`` and transformer-table1's
   folded ``[288, 32, 2, 64]``; the float32 kernels at their four timed
   shapes) and their
   library calls (SDPA, with ``enable_gqa`` on one kv head), and of compress,
   decompress and ``momentum_scatter`` at the LLM step's ``[8,
   416179200]`` and at the families' train paths' banks, from the
   profiler, which runs last (it slows the launches that follow it);
   pairdist must be one device kernel a call (a case whose window lost a
   kernel event is read again, and both readings are kept).

TF32 is off for matmuls and cuDNN convolutions throughout: the parity bars
are float32 ones. The last line is ``{"ok": true, "device": {...}}``; the
two before it are the ``{"kernels": [...]}`` record and the card's name and
power limit, after a ``{"summary": ...}`` line of the main-path numbers.

``python3 chip_smoke.py --flash-ab A.cu [B.cu ...]`` times other versions
of ``csrc/flash_attention.cu`` or ``csrc/flash_attention_f32.cu`` (by the
entries each defines) against the tree's in turns, beside SDPA
(:func:`flash_ab`; a partial run, exit 3, its records also in
``build/chip_smoke/flash_ab.json``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def peak_rates() -> dict:
    """One H100's published peaks, from ``repro_torch.launch.roofline`` (the
    one source of them): HBM bytes/s, float32 operations/s outside the
    tensor cores and dense bf16 operations/s on them. The bounds below
    take these; the sort and pairdist kernels are bound by bytes at the
    paths' shapes."""
    from repro_torch.launch.roofline import H100, H100_F32_FLOPS
    return {"bytes": H100.hbm_bw, "f32": H100_F32_FLOPS,
            "bf16": H100.peak_flops}


AWKWARD = [(3, 13, 3, 300), (2, 7, 0, 130), (4, 5, 2, 257),
           (1, 19, 9, 128), (5, 4, 1, 64), (2, 16, 3, 1024)]
PATH_SHAPES = [(1, 13, 11958), (1, 13, 1048576), (8, 13, 1048576)]
F = 3  # fig1-alie: f = 3 Byzantine workers, CWTM trims max(f, 1) = 3
# pairdist's launch plan at its edges (``pairdist_plan`` on 132 SMs), as
# (B, n, d, dtype, reference): d below one tile (one CTA), exactly one
# cluster's span (16 CTAs of one tile) and one column past it, n = 1 and
# n = 64, rows of 129 tiles and more (clusters of 8 and the ticket; B = 3
# with odd d, which takes 4-byte copies and the zero column), bfloat16 with
# odd d (plain loads) and with 16-, 8- and 4-byte copies. At [1, 13,
# 1048576] in bfloat16 the float32 plain version (cuBLAS's product) is
# itself farther than 1e-5 max sq from the float64 distances on an H100,
# and the kernel is not: that case is held to the float64 version at the
# same bar, and the line prints how far the plain version is.
PAIRDIST_EDGES = [(1, 13, 100, "float32", "plain"),
                  (1, 13, 4096, "float32", "plain"),
                  (1, 13, 4097, "float32", "plain"),
                  (2, 1, 77, "float32", "plain"),
                  (2, 64, 999, "float32", "plain"),
                  (1, 64, 40000, "float32", "plain"),
                  (1, 13, 33024, "float32", "plain"),
                  (3, 13, 33025, "float32", "plain"),
                  (3, 13, 33025, "bfloat16", "plain"),
                  (2, 13, 11957, "bfloat16", "plain"),
                  (1, 13, 11958, "bfloat16", "plain"),
                  (2, 7, 130, "bfloat16", "plain"),
                  (1, 13, 1048576, "bfloat16", "float64")]
# The sorted-rank kernel at each block size: 64 threads (the CNN's shape
# and the awkward ones), 128 at [1, 13, 20000], 256 at the quadratic's.
SORT_EDGES = [(1, 13, 3, 20000), (2, 64, 20, 999), (1, 1, 0, 77)]
# The table1 grid on the CNN, 21 cells x 2 seeds as lanes of one bank: NNM
# over the 36 lanes whose rule composes it (every algorithm but dgd), then
# CWTM and the median over 18 lanes each.
GRID_SHAPES = {"pairdist": (36, 13, 11958), "cwtm": (18, 13, 11958),
               "median": (18, 13, 11958)}

KERNELS = {
    "pairdist": {"source": "src/repro_torch/csrc/pairdist.cu",
                 "replaces": "src/repro/kernels/pairdist/pairdist.py:29"},
    "cwtm": {"source": "src/repro_torch/csrc/sorted_weight.cu",
             "replaces": "src/repro/kernels/cwtm/cwtm.py:77"},
    "median": {"source": "src/repro_torch/csrc/sorted_weight.cu",
               "replaces": "src/repro/kernels/median/median.py:34"},
    "block_compress": {"source": "src/repro_torch/csrc/randk.cu",
                       "replaces": "src/repro/kernels/randk/randk.py:34"},
    "block_decompress": {"source": "src/repro_torch/csrc/randk.cu",
                         "replaces": "src/repro/kernels/randk/randk.py:67"},
    "momentum_scatter": {"source": "src/repro_torch/csrc/randk.cu",
                         "replaces": "src/repro/kernels/randk/randk.py:111"},
    "flash_fwd": {"source": "src/repro_torch/csrc/flash_attention.cu",
                  "replaces": "src/repro/kernels/flash_attention/flash.py:34"},
    "flash_bwd": {"source": "src/repro_torch/csrc/flash_attention.cu",
                  "replaces": "src/repro/kernels/flash_attention/flash.py:34"},
    "flash_fwd_f32": {
        "source": "src/repro_torch/csrc/flash_attention_f32.cu",
        "replaces": "src/repro/kernels/flash_attention/flash.py:34"},
    "flash_bwd_f32": {
        "source": "src/repro_torch/csrc/flash_attention_f32.cu",
        "replaces": "src/repro/kernels/flash_attention/flash.py:34"},
}

# The LLM path (``repro_torch.launch.train``): full-width stablelm_3b cut to
# 2 layers, seq 4096, n = 8 workers with one sequence each, global
# Block-RandK at 0.05 with 512-wide blocks.
LLM_LAYERS, LLM_WORKERS, LLM_SEQ = 2, 8, 4096
LLM_D = 416_179_200  # make_flat_spec(pad_to=8) of the 2-layer model
LLM_BS = 512
LLM_KB = 40_642      # max(1, round(0.05 * D / 512))
# The sort kernels on float16 and float8_e4m3fn inputs (RoSDHB's compute
# dtypes below float32): the fig1 shapes (n = 13 padded to 16), the table1
# grid's batched one and the LLM path's CWTM (f = 1), timed; SORT_EDGES and
# SORT_NAN at both dtypes
LOWP_SORT_SHAPES = [(1, 13, 11958), (36, 13, 11958), (1, 13, 1048576)]
LOWP_CWTM_LLM = (1, 8, LLM_D)
# The sort kernels' narrow input classes, each timed at LOWP_SORT_SHAPES
# (and CWTM at LOWP_CWTM_LLM) with the plan it ran: bfloat16 beside the
# compute dtypes
SORT_LOWP_DTYPES = ("bfloat16", "float16", "float8_e4m3fn")
# RoSDHB's round at a float16 or float8 compute dtype (the compute dtypes
# phase): [8, LLM_D] with a bfloat16 wire on the card, then the same round
# at LOWP_CHECK_D columns on the card and on the CPU (a CPU round at LLM_D
# takes minutes)
LOWP_ROUNDS = (("float16", "float32"), ("float16", "float8_e4m3fn"),
               ("float8_e4m3fn", "float32"),
               ("float8_e4m3fn", "float8_e4m3fn"))
LOWP_CHECK_D = 1 << 22
# The audio family's train path (the decode phase): full-width
# musicgen_medium cut to 2 layers, the same workers, ratio and blocks; its
# flash calls are [1, 4096, 24, 64]
AUDIO_D = 59_784_192   # make_flat_spec(pad_to=8) of the 2-layer model
AUDIO_KB = 5_838       # max(1, round(0.05 * D / 512))
# The families' train paths (the families phase): the [8, D] server banks,
# their width rounded up to whole 512-wide blocks (TrainPlan.bank_width),
# of 2-layer deepseek_v2_lite_16b (D = 1,026,698,240; bfloat16 banks),
# 2-layer mamba2_1_3b (D = 257,647,488; float32), 6-layer zamba2_7b
# (D = 902,776,032; bfloat16) and 2-layer gemma_2b (D = 744,499,200, whole
# blocks; bfloat16); CWTM takes the float32 momenta [1, 8, width]
FAMILY_BANKS = (("deepseek_v2_lite_16b", 1_026_698_240, "bfloat16"),
                ("mamba2_1_3b", 257_647_616, "float32"),
                ("zamba2_7b", 902_776_320, "bfloat16"),
                ("gemma_2b", 744_499_200, "bfloat16"))


def kept_blocks(d: int, bs: int = LLM_BS, ratio: float = 0.05) -> int:
    """Block-RandK's kept blocks of a ``d``-wide bank: max(1, round(ratio *
    d / bs))."""
    return max(1, int(round(ratio * (d // bs))))


# The vlm's train path (the families phase): llama32_vision_11b at full
# width cut to 5 layers (4 self-attention layers and the first cross layer),
# float8 banks of D = 2,141,237,249 widened to 4,182,105 whole blocks. Its
# payload round runs by windows of algorithms.DENSE_COLUMNS // 512 = 32,768
# blocks (128 a step): the momentum kernel is timed at the first window and
# at the ragged last one (20,569 blocks), and over the step's 128 windows as
# the round launches them (MOMENTUM_VLM_SWEEP), CWTM over their slices too
VLM_BANK = ("llama32_vision_11b", 2_141_237_760, "float8_e4m3fn")
VLM_WINDOW_BLOCKS = 32_768
VLM_WINDOWS = ((0, VLM_WINDOW_BLOCKS),
               (127 * VLM_WINDOW_BLOCKS, 2_141_237_760 // LLM_BS))
# dbrx_132b's train path (the families phase): full width cut to 1 layer,
# float8 banks of D = 4,492,216,320 (8,773,860 whole blocks). The streamed
# step compresses one worker's row at a time, [1, D] (4.49 GB: the kernel's
# offsets pass 2^32 bytes), and its payload round runs 268 windows of
# 32,768 blocks a step (MOMENTUM_DBRX_SWEEP: the momentum kernel and CWTM
# over every window, held at the first, a middle and the ragged last)
DBRX_BANK = ("dbrx_132b", 4_492_216_320, "float8_e4m3fn")

# Block-RandK cases: (n, d, block_size, kb, local ids, dtype name).
RANDK_AWKWARD = [(3, 128 * 7, 128, 1, False, "float32"),
                 (3, 128 * 7, 128, 3, True, "float32"),
                 (2, 512 * 5, 512, 5, False, "float32"),
                 (4, 512 * 9, 512, 4, True, "bfloat16"),
                 (1, 128, 128, 1, False, "bfloat16"),
                 (8, 512 * 33, 512, 2, False, "float32"),
                 (5, 512 * 40, 512, 40, True, "float32")]
# float16 and float8 banks (the float8 ones get values past 448); the last
# two have blocks of 6 and 5 16-byte vectors, so a thread block takes 42
# and 51 blocks and the last one fewer
RANDK_AWKWARD_LOWP = [(3, 128 * 7, 128, 3, True, "float16"),
                      (4, 512 * 9, 512, 4, False, "float16"),
                      (3, 128 * 7, 128, 2, False, "float8_e4m3fn"),
                      (5, 512 * 40, 512, 7, True, "float8_e4m3fn"),
                      (3, 48 * 100, 48, 45, True, "float16"),
                      (2, 80 * 120, 80, 53, False, "float8_e4m3fn")]
# float16 and float8 server banks: the kernels at the LLM step's bank in
# those dtypes (timed)
LOWP_DTYPES = ("float16", "float8_e4m3fn")
RANDK_PATH = (LLM_WORKERS, LLM_D, LLM_BS, LLM_KB, False, "float32")
RANDK_AUDIO = (LLM_WORKERS, AUDIO_D, LLM_BS, AUDIO_KB, False, "float32")
# compress at the families' banks, in the wire dtype (their decompress
# launches none)
RANDK_FAMILIES = [(LLM_WORKERS, d, LLM_BS, kept_blocks(d), False, dt)
                  for _, d, dt in FAMILY_BANKS]
RANDK_LOWP = [(LLM_WORKERS, LLM_D, LLM_BS, LLM_KB, False, dt)
              for dt in LOWP_DTYPES]
# compress as the streamed step launches it on dbrx_132b: one row (timed)
RANDK_DBRX = (1, DBRX_BANK[1], LLM_BS, kept_blocks(DBRX_BANK[1]), False,
              DBRX_BANK[2])

# Momentum cases: (n, d, block_size, kb, local ids, bank dtype, beta,
# -0.0 in the bank). The payload is in the bank's dtype (the wire dtype is
# momentum_dtype); a bfloat16 bank also writes the float32 result.
MOMENTUM_AWKWARD = [(3, 128 * 7, 128, 1, False, "float32", 0.9, False),
                    (3, 128 * 7, 128, 7, True, "float32", 0.0, True),
                    (2, 512 * 5, 512, 5, False, "bfloat16", 0.99, False),
                    (4, 512 * 9, 512, 4, True, "bfloat16", 0.9, True),
                    (1, 128, 128, 1, False, "float32", 0.99, True),
                    (1, 128, 128, 1, True, "bfloat16", 0.0, True),
                    (8, 512 * 33, 512, 2, False, "float32", 0.9, True),
                    (5, 512 * 40, 512, 40, True, "bfloat16", 0.99, False)]
MOMENTUM_AWKWARD_LOWP = [
    (3, 128 * 7, 128, 2, False, "float16", 0.9, True),
    (4, 512 * 9, 512, 4, True, "float16", 0.99, False),
    (3, 128 * 7, 128, 7, True, "float8_e4m3fn", 0.0, True),
    (5, 512 * 40, 512, 9, False, "float8_e4m3fn", 0.9, True)]
# A ninth entry (b0, b1): the kernel on the window of destination blocks b0
# to b1 - 1 alone, the float32 result (banks narrower than float32) into a
# caller's buffer of a wider row stride; a first, a middle and a ragged
# last window at each bank dtype. Held bitwise to the plain version's
# window, and the rest of the bank to the bank as it was.
MOMENTUM_AWKWARD += [(3, 128 * 7, 128, 7, True, "float32", 0.9, True, (0, 3)),
                     (8, 512 * 33, 512, 2, False, "float32", 0.9, True,
                      (10, 20)),
                     (4, 512 * 9, 512, 4, True, "bfloat16", 0.9, True,
                      (5, 9)),
                     (5, 512 * 40, 512, 40, True, "bfloat16", 0.99, False,
                      (16, 32))]
MOMENTUM_AWKWARD_LOWP += [
    (3, 128 * 7, 128, 2, False, "float16", 0.9, True, (6, 7)),
    (4, 512 * 9, 512, 4, True, "float16", 0.99, False, (0, 4)),
    (3, 128 * 7, 128, 7, True, "float8_e4m3fn", 0.0, True, (4, 7)),
    (5, 512 * 40, 512, 9, False, "float8_e4m3fn", 0.9, True, (13, 26))]
MOMENTUM_PATH = [(LLM_WORKERS, LLM_D, LLM_BS, LLM_KB, False, "float32", 0.9,
                  False),
                 (LLM_WORKERS, LLM_D, LLM_BS, LLM_KB, False, "bfloat16", 0.9,
                  False)]
MOMENTUM_AUDIO = (LLM_WORKERS, AUDIO_D, LLM_BS, AUDIO_KB, False, "float32",
                  0.9, False)
MOMENTUM_FAMILIES = [(LLM_WORKERS, d, LLM_BS, kept_blocks(d), False, dt, 0.9,
                      False) for _, d, dt in FAMILY_BANKS]
MOMENTUM_LOWP = [(LLM_WORKERS, LLM_D, LLM_BS, LLM_KB, False, dt, 0.9, False)
                 for dt in LOWP_DTYPES]
# the vlm's float8 bank at its first and last window (timed)
MOMENTUM_VLM = [(LLM_WORKERS, VLM_BANK[1], LLM_BS, kept_blocks(VLM_BANK[1]),
                 False, VLM_BANK[2], 0.9, False, w) for w in VLM_WINDOWS]
# ... and every window of VLM_WINDOW_BLOCKS blocks of it, one after another;
# then dbrx_132b's float8 bank the same way
MOMENTUM_VLM_SWEEP = MOMENTUM_VLM[0][:8] + (VLM_WINDOW_BLOCKS,)
MOMENTUM_DBRX_SWEEP = (LLM_WORKERS, DBRX_BANK[1], LLM_BS,
                       kept_blocks(DBRX_BANK[1]), False, DBRX_BANK[2], 0.9,
                       False, VLM_WINDOW_BLOCKS)
MOMENTUM_SWEEPS = (MOMENTUM_VLM_SWEEP, MOMENTUM_DBRX_SWEEP)
# float8 stores past the largest finite value: values that round to 448,
# the midpoint 464, past it, +-inf and NaN, on the momentum kernel's
# store (beta 0 writes the float32 payload as it is)
FLOAT8_EDGES = (440.0, 447.9, 448.0, 456.0, 463.99, 464.0, 464.01, 465.0,
                470.0, 479.9, 480.0, 1e4, 2.0 ** -9, 2.0 ** -10, 1e-30,
                float("inf"), float("nan"), 0.0)

# Flash cases: (B, Sq, Sk, H, KV, D, causal, window, q_offset).
FLASH_AWKWARD = [(2, 100, 100, 32, 32, 80, True, None, 0),
                 (1, 130, 130, 16, 2, 64, True, None, 0),
                 (2, 77, 77, 8, 1, 128, True, None, 0),
                 (1, 200, 200, 16, 2, 80, True, 48, 0),
                 (2, 64, 192, 8, 1, 64, True, None, 128),
                 (1, 96, 160, 32, 32, 128, True, 40, 64),
                 (1, 70, 90, 16, 2, 80, False, None, 0)]
# At the Hopper kernels' tile edges (blocks of 128 rows or keys, streamed
# tiles of 128 keys forward and 64 rows or keys backward), at each head dim:
# GQA with B = 2 at a tile + 1, MQA at a tile - 1, a window across a tile
# boundary, q_offset > 0 with Sq < Sk, and a ragged non-causal case.
FLASH_AWKWARD += [case for d in (64, 80, 128) for case in (
    (2, 129, 129, 8, 2, d, True, None, 0),
    (1, 127, 127, 8, 1, d, True, None, 0),
    (1, 257, 257, 4, 2, d, True, 100, 0),
    (2, 65, 193, 4, 1, d, True, 70, 128),
    (1, 63, 191, 8, 2, d, False, None, 0))]
# Head dim 256 (gemma_2b's), whose tiles differ (Tiles<256> in the .cu: 64
# keys a forward stage and a dk/dv block, each consumer half of dK and dV;
# dq from dS^T in stages of 128 keys): MQA and GQA at a tile + 1 and - 1,
# a window across a 64-key tile, q_offset > 0 with Sq < Sk and a window, a
# ragged non-causal case, and a continuation chunk of 33 rows.
FLASH_AWKWARD_256 = [(2, 129, 129, 8, 1, 256, True, None, 0),
                     (1, 127, 127, 8, 2, 256, True, None, 0),
                     (1, 257, 257, 4, 1, 256, True, 100, 0),
                     (2, 65, 193, 4, 1, 256, True, 70, 128),
                     (1, 63, 191, 8, 1, 256, False, None, 0),
                     (1, 33, 97, 2, 1, 256, True, 40, 64)]
FLASH_AWKWARD += FLASH_AWKWARD_256
FLASH_PATH = (1, LLM_SEQ, LLM_SEQ, 32, 32, 80, True, None, 0)
# musicgen_medium's train path: 24 heads of 64 at seq 4096
FLASH_AUDIO = (1, LLM_SEQ, LLM_SEQ, 24, 24, 64, True, None, 0)
# zamba2_7b's shared attention block: 32 heads of 112 (unpadded)
FLASH_ZAMBA = (1, LLM_SEQ, LLM_SEQ, 32, 32, 112, True, None, 0)
# gemma_2b's train path: 8 query heads of 256 on one kv head (MQA)
FLASH_GEMMA = (1, LLM_SEQ, LLM_SEQ, 8, 1, 256, True, None, 0)
# llama32_vision_11b's self-attention layers: 32 query heads of 128 on 8
# kv heads (GQA)
FLASH_VLM = (1, LLM_SEQ, LLM_SEQ, 32, 8, 128, True, None, 0)
# qwen25_3b's (16 query heads on 2 KV heads: groups of 8) and
# mistral_large_123b's (96 on 8: groups of 12) self-attention
FLASH_QWEN = (1, LLM_SEQ, LLM_SEQ, 16, 2, 128, True, None, 0)
FLASH_MISTRAL = (1, LLM_SEQ, LLM_SEQ, 96, 8, 128, True, None, 0)
# dbrx_132b's (48 on 8: groups of 6)
FLASH_DBRX = (1, LLM_SEQ, LLM_SEQ, 48, 8, 128, True, None, 0)
# transformer-table1's folded call: 8 lanes x 9 workers x 4 sequences of 32
# tokens, 2 heads of 64 (the stream phase's grid under torch.func)
FLASH_TT1 = (288, 32, 32, 2, 2, 64, True, None, 0)
# Kernel against the plain version in float32 from the same bf16 inputs,
# as max |err| / max |plain|: the kernel rounds P (and dS) to bf16 before
# the tensor-core products (relative 2^-9 each) and writes bf16 outputs
# (relative 2^-9); sums over up to 4096 keys run in float32.
FLASH_TOL_OUT = 1e-2
FLASH_TOL_GRAD = 2e-2
# The same comparison tile by tile: rms(err) / rms(plain) over each block of
# FLASH_TILE_ROWS query rows (out, dq) or keys (dk, dv) of one head, at the
# worst block. The largest entries of out and of the gradients sit in the
# first rows and keys of a causal mask, so the bounds above cannot see one
# 128-key tile dropped for the last 64 rows of the path: that moves max|err|
# by less than 1e-2 max|plain|, and these measures by 0.03 (dk, dv) to 0.2
# (out, dq). The kernels read 0.002 to 0.0053 in every case on an H100.
FLASH_TILE_ROWS = 64
FLASH_TILE_TOL_OUT = 1e-2
FLASH_TILE_TOL_GRAD = 1e-2
# The float32 kernels (csrc/flash_attention_f32.cu) against the plain
# version on the same float32 inputs: both compute in float32 (FFMA, TF32
# off for the plain version's matmuls) and differ only in summation order,
# so out, dq, dk and dv within 1e-5 of max|plain|, and each 64-row tile's
# rms(err) within 1e-4 of its rms(plain) (a tile of small entries, the last
# keys of a causal mask, carries the rounding of the larger ones it sums).
# The dropped tile reads 0.03 and more: it fails this bound many times over.
FLASH_F32_TOL = 1e-5
FLASH_F32_TILE_TOL = 1e-4
# The float32 cases: every awkward case, then the timed rows at the LLM
# path's, the vlm's, gemma_2b's and zamba2's shapes (zamba2's at head dim
# 112, which the float32 kernels take unpadded).
FLASH_F32_TIMED = (FLASH_ZAMBA, FLASH_GEMMA, FLASH_VLM, FLASH_PATH)
FLASH_BF16_TIMED = (FLASH_PATH, FLASH_TT1, FLASH_AUDIO, FLASH_ZAMBA,
                    FLASH_GEMMA, FLASH_VLM, FLASH_QWEN, FLASH_MISTRAL,
                    FLASH_DBRX)
# Rounds of (version, tree, tree, version) readings an A/B takes at each
# case: the spread between calls of one build reaches 4% at table1's
# backward, so two readings each cannot resolve a 3% difference.
FLASH_AB_ROUNDS = 4
# The float32 kernels at head dim 112, unpadded (F32_HEAD_DIMS), at the
# tile edges of the other head dims' cases; and the dk/dv blocks' split
# (flash.dkdv_plan: every small grid splits) where Sk is no multiple of a
# key block, under a window, with q_offset > 0, MQA at head dim 256 and
# GQA at 80.
FLASH_F32_112 = [(2, 129, 129, 8, 2, 112, True, None, 0),
                 (1, 127, 127, 8, 1, 112, True, None, 0),
                 (1, 257, 257, 4, 2, 112, True, 100, 0),
                 (2, 65, 193, 4, 1, 112, True, 70, 128),
                 (1, 63, 191, 8, 2, 112, False, None, 0)]
FLASH_F32_SPLIT = [(1, 300, 1000, 8, 1, 256, True, 200, 700),
                   (2, 250, 700, 16, 2, 80, True, 300, 450)]
# The bf16 kernels where their dk/dv blocks split (flash.dkdv_plan with the
# bf16 tiles: every small grid splits) and head dim 112 at bf16: the
# float32 cases above (112 at the tile edges; 256 with a window and a
# q_offset, MQA, Sk no multiple of a 64-key block; GQA at 80, Sk no multiple
# of 128), then KV 2 at 128 with Sk no multiple of a key block. Each must
# split, and its backward repeat bitwise.
FLASH_SPLIT = FLASH_F32_112 + FLASH_F32_SPLIT + [
    (1, 1000, 1000, 8, 2, 128, True, None, 0)]
# The row-7 and row-7b shapes (PERF.md), the parent's kernels against the
# tree's in one call (``--flash-ab``): the LLM path's, table1's, musicgen's,
# zamba2's, gemma_2b's, the vlm's, qwen25_3b's and mistral's.


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events: the device's time when the device is the slower side, else the
    host's cost per call (the loop time)."""
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


def device_us(torch, fn, reps: int) -> tuple:
    """``(µs, device operations, names)`` per call of ``fn``: the durations
    of the device operations the profiler (CUPTI) sees over ``reps`` calls,
    summed and divided by the calls, with their count per call and their
    names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in ev)
    return total / reps, len(ev) / reps, sorted({e.name[:60] for e in ev})


def host_us(torch, fn, reps: int, warmup: int = 3) -> float:
    """Host µs per call of ``fn``: ``perf_counter`` around ``reps`` calls
    with no synchronize inside the window, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def split_times(torch, fns: dict, reps: int, rounds: int = 5) -> dict:
    """``{name: {"ms", "host_us"}}``: the loop time and the host µs per call
    of each function, the median over ``rounds`` rounds in which the
    functions take turns (forward, then backward order), so that host
    noise falls on all of them alike; the device µs come later
    (:func:`profile_cases`)."""
    names = list(fns)
    ms = {k: [] for k in names}
    host = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            ms[k].append(time_ms(torch, fns[k], reps))
            host[k].append(host_us(torch, fns[k], reps))
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    return {k: {"ms": med(ms[k]), "host_us": med(host[k])} for k in names}


# ----------------------------------------------------------------------- #
# kernels
# ----------------------------------------------------------------------- #


def bound_ms(name: str, shape, itemsize: int) -> tuple:
    """Least time for pairdist, CWTM or the median on these inputs: the
    kernel's work (``repro_torch.launch.roofline.pairdist_work``,
    ``sorted_weight_work``) at the float32 rate (:func:`_bound`)."""
    from repro_torch.launch import roofline as RL
    work = (RL.pairdist_work if name == "pairdist"
            else RL.sorted_weight_work)(*shape, itemsize)
    return _bound(work, "f32")


def pairdist_f64(torch, x):
    """Pairwise squared distances in float64 (the plain version's formula):
    the exact yardstick where the float32 plain version is not exact
    enough."""
    xd = x.double()
    g = xd @ xd.mT
    sq = g.diagonal(dim1=-2, dim2=-1)
    return (sq[..., :, None] + sq[..., None, :] - 2.0 * g).clamp_min(0.0)


def case_reps(shape) -> int:
    """Calls a timing loop makes at one shape: enough for ~1 ms or more."""
    b, n, d = shape
    return 200 if b * n * d < 1_000_000 else (
        20 if b * n * d < 50_000_000 else 5)


def case_fns(torch, name: str, shape, f: int, dtype, seed: int) -> tuple:
    """``(x, kernel, plain, library or None)`` of one case: the input made
    from ``seed`` and the three calls on it."""
    from repro_torch.kernels.cwtm import cwtm_cuda, cwtm_ref
    from repro_torch.kernels.median import median_cuda, median_ref
    from repro_torch.kernels.pairdist import pairdist_cuda, pairdist_ref
    from repro_torch.utils.dtypes import to_dtype
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = to_dtype(torch.randn(shape, generator=gen, device="cuda") * 3, dtype)
    if name == "pairdist":
        kern, plain = (lambda: pairdist_cuda(x)), (lambda: pairdist_ref(x))
        lib = lambda: torch.cdist(x.float(), x.float())  # noqa: E731
    elif name == "cwtm":
        kern, plain = (lambda: cwtm_cuda(x, f)), (lambda: cwtm_ref(x, f))
        lib = None  # no single PyTorch call computes a trimmed mean
    else:
        kern, plain = (lambda: median_cuda(x)), (lambda: median_ref(x))
        # torch.median returns the lower middle: the same function for odd n
        lib = ((lambda: torch.median(x, dim=1).values)
               if shape[1] % 2 and dtype != torch.float8_e4m3fn else None)
    return x, kern, plain, lib


def kernel_case(torch, name: str, shape, f: int, dtype, timed: bool,
                seed: int, reference: str = "plain") -> dict:
    """One kernel against its plain version at one shape (pairdist with
    ``reference="float64"``: against :func:`pairdist_f64`); timed, its loop
    and host times beside the plain version's and the library call's."""
    from repro_torch.kernels.pairdist import pairdist_cuda
    b, n, d = shape
    x, kern, plain, lib = case_fns(torch, name, shape, f, dtype, seed)
    got = kern()
    want = pairdist_f64(torch, x) if reference == "float64" else plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if name == "pairdist":
        from repro_torch.kernels.pairdist.pairdist import counters
        scale = float((x.float() ** 2).sum(-1).max())
        tol = 1e-5 * scale
        ok = tuple(got.shape) == (b, n, n) and err <= tol
        diag = got.diagonal(dim1=1, dim2=2)
        ok = ok and bool((diag == 0).all()) and torch.equal(got, got.mT)
        # every call leaves the ticket counters at zero
        ok = ok and not bool(counters(x.device).any())
        rule = (f"|d| <= 1e-5 * max sq = {tol:.3g} of the {reference} "
                f"version, diagonal exactly 0, symmetric, ticket counters "
                f"back at 0")
    elif dtype in (torch.float16, torch.float8_e4m3fn):
        # the kernel sums w * v in rank order, the plain version the sum
        # times 1/k: at most one step of the dtype apart (the median's
        # weights are 1 or 1/2, exact: bitwise)
        lim = 1 if name == "cwtm" else 0
        off = int(narrow_steps(torch, got, want,
                               finite_max(torch, x)).max())
        ok = off <= lim and bool(torch.isfinite(got.float()).all())
        rule = (f"within {lim} step of {str(dtype).split('.')[-1]} or "
                f"{SUM_ROUNDING:g} of max |x| ({off} at most)")
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
    if reference == "float64":  # why the float64 version is the yardstick
        rec["plain_err_vs_float64"] = float(
            (plain().double() - want).abs().max())
        rec["tolerance"] += (f"; the plain version is "
                             f"{rec['plain_err_vs_float64']:.3g} from it")
    if timed:
        reps = case_reps(shape)
        if name == "pairdist":
            # no float atomics: two launches give the same bits
            rec["bitwise_repeat"] = torch.equal(got, pairdist_cuda(x))
            rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
        t = split_times(torch, {"kernel": kern, "library": lib} if lib
                        else {"kernel": kern}, reps)
        rec["kernel"], rec["library"] = t["kernel"], t.get("library")
        rec["ms"] = t["kernel"]["ms"]
        rec["library_ms"] = t["library"]["ms"] if lib else None
        rec["plain_ms"] = time_ms(torch, plain, reps)
        rec["seed"], rec["reps"] = seed, reps  # for profile_cases
        rec["bound_ms"], rec["bound_by"] = bound_ms(name, shape,
                                                    x.element_size())
        rec["plan"] = sort_plan(name, x)
    return rec


def sort_plan(name: str, x) -> dict:
    """The launch plan the tree's wrapper takes for ``x``: pairdist's tile
    columns, copy bytes and cut of d; the sorted-weight kernel's
    coordinates a thread, load bytes and block size."""
    from repro_torch.kernels import build
    b, n, d = x.shape
    size = x.element_size()
    sms = build.sm_count(x.get_device())
    if name == "pairdist":
        from repro_torch.kernels.pairdist.pairdist import pairdist_plan
        p = pairdist_plan(b, n, d, size, sms)
        ptr = x.data_ptr()
        # the float32 kernel's cp.async width (copy_bytes in the source);
        # the narrow classes copy the 16-byte chunks that cover a row
        copy = 16 if size < 4 else next(
            (w for w in (16, 8) if ptr % w == 0 and d * 4 % w == 0), 4)
        return {"tile_columns": p.tile, "copy_bytes": copy,
                "cluster": p.cluster, "groups": p.groups,
                "tiles_per_cta": p.tiles_per_cta, "smem": p.smem}
    from repro_torch.kernels.cwtm.cwtm import (load_width, plan_vec,
                                              sorted_weight_threads)
    vec = plan_vec(b, n, d, size, sms)
    return {"vec": vec, "load_bytes": load_width(x.data_ptr() % 16, d, size,
                                                 vec),
            "threads": sorted_weight_threads(b, d, sms, vec)}


def wrapper_pieces(torch, reps: int = 10_000) -> dict:
    """Host µs per call of each piece of the pairdist and sorted-weight
    wrappers at the CNN shape, ``perf_counter`` over ``reps`` calls of each
    in five rounds (no synchronize inside), beside one PyTorch op and the routes the
    wrappers do not take (``get_device_properties``, a ``torch.device``
    argument, ``torch.empty``, a ctypes array built per call, PyTorch's
    private raw-stream call)."""
    import ctypes
    import sys as _sys
    from repro_torch.kernels import build
    from repro_torch.kernels.cwtm import cwtm_cuda, cwtm_weights
    from repro_torch.kernels.median import median_cuda
    from repro_torch.kernels.pairdist import pairdist_cuda
    cw = _sys.modules["repro_torch.kernels.cwtm.cwtm"]
    pd = _sys.modules["repro_torch.kernels.pairdist.pairdist"]
    x = torch.randn((1, 13, 11958), device="cuda")
    dev, idx = x.device, x.device.index
    w = cwtm_weights(13, 3)
    pairdist_cuda(x), cwtm_cuda(x, 3)  # their launch plans
    key = (1, 13, 11958, x.dtype, idx)
    lib = build.entry("pairdist", "pairdist")
    null_args = [0] * len(lib.argtypes)  # the C entry refuses them at once
    pieces = {
        "pairdist_cuda (whole wrapper)": lambda: pairdist_cuda(x),
        "cwtm_cuda (whole wrapper)": lambda: cwtm_cuda(x, 3),
        "median_cuda (whole wrapper)": lambda: median_cuda(x),
        "torch.cdist (one library call)": lambda: torch.cdist(x, x),
        "torch.median(x, dim=1) (one library call)":
            lambda: torch.median(x, dim=1),
        "x.neg() (one PyTorch op)": lambda: x.neg(),
        "pairdist _check(x)": lambda: pd._check(x),
        "sorted-weight _check(x, w)": lambda: cw._check(x, w),
        "x.get_device()": lambda: x.get_device(),
        "plan lookup (key tuple, dict get)":
            lambda: pd._LAUNCH.get((1, 13, 11958, x.dtype, idx)),
        "cwtm_weights(13, 3) (cached)": lambda: cwtm_weights(13, 3),
        "x.new_empty((1, 13, 13), dtype=float32)":
            lambda: x.new_empty((1, 13, 13), dtype=torch.float32),
        "torch.empty((1, 13, 13), device=x.device)": lambda: torch.empty(
            (1, 13, 13), dtype=torch.float32, device=x.device),
        "build.entry (bound C function)":
            lambda: build.entry("pairdist", "pairdist"),
        "x.data_ptr()": lambda: x.data_ptr(),
        "build.stream_ptr(index)": lambda: build.stream_ptr(idx),
        "torch.cuda.current_stream(x.device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index) (private)":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
        "torch.cuda.get_device_properties(dev).multi_processor_count":
            lambda: torch.cuda.get_device_properties(
                dev).multi_processor_count,
        "ctypes float[13] from a list": lambda: (ctypes.c_float * 13)(
            *[float(v) for v in w]),
        f"ctypes call, no launch ({len(null_args)} arguments)":
            lambda: lib(*null_args),
        "ctypes call with the launch (pairdist, no allocation)":
            lambda: lib(x.data_ptr(), pd_out.data_ptr(), pd_launch[0],
                        build.stream_ptr(idx)),
        "ctypes call with the launch (sorted_weight, no allocation)":
            lambda: sw_lib(x.data_ptr(), sw_out.data_ptr(), sw_launch[0],
                           build.stream_ptr(idx)),
        "build.check(0, ...)": lambda: build.check(0, "pairdist"),
    }
    pd_out = torch.empty((1, 13, 13), device="cuda")
    pd_launch = pd._LAUNCH[key]
    sw_lib = build.entry("sorted_weight", "sorted_weight")
    sw_out = torch.empty((1, 11958), device="cuda")
    sw_launch = cw._LAUNCH[key + (w, False, x.data_ptr() % 16)]  # CWTM
    # five rounds of reps / 5 calls of each piece in turn, the median
    runs = {label: [] for label in pieces}
    for _ in range(5):
        for label, fn in pieces.items():
            runs[label].append(host_us(torch, fn, reps // 5, warmup=100))
    out = {}
    for label, v in runs.items():
        out[label] = sorted(v)[2]
        log(f"wrapper piece {out[label]:8.3f} us  {label} (median of 5 "
            f"rounds of {reps // 5} calls)")
    return out


SORT_KERNELS = ("pairdist", "cwtm", "median")
# A pairdist case whose profiler window lost a kernel event is read again;
# the two readings' µs a kernel must agree this closely (at [8, 13,
# 1048576] three runs on an H100 read 191.7, 190.6 a kernel in the window
# that lost one, and 192.1)
PAIRDIST_REREAD_TOL = 0.05


# CWTM and the median with NaN and +-inf among a coordinate's values, as
# (B, n, f, d): none, one or two NaN a coordinate
SORT_NAN = [(1, 8, 1, 65536), (2, 13, 3, 4099), (1, 7, 2, 999)]


def sort_nan_cases(torch, device: str = "cuda", dtype: str = "float32"
                   ) -> list:
    """The sort kernels against their plain versions where a coordinate
    holds NaN (a float8 bank's ALIE rows can): the kernel sorts NaN after
    every number, as ``torch.sort`` does, so CWTM trims a NaN at a trimmed
    rank; the median is NaN there (``jnp.median``). Every result within
    1e-5 (CWTM) or 1e-6 (median) of the plain version's, NaN at the same
    places."""
    import numpy as np
    from repro_torch.kernels.cwtm import cwtm, cwtm_ref
    from repro_torch.kernels.median import median, median_ref
    from repro_torch.utils.dtypes import to_dtype
    out = []
    for i, (b, n, f, d) in enumerate(SORT_NAN):
        rng = np.random.default_rng(700 + i)
        x = rng.normal(size=(b, n, d)).astype(np.float32) * 3
        cols = np.arange(d)
        for k in (1, 2):
            pick = cols[cols % 3 == k]
            for _ in range(k):
                x[:, rng.integers(n, size=pick.size), pick] = np.nan
        x[:, rng.integers(n), ::7] = np.inf
        x[:, rng.integers(n), ::11] = -np.inf
        # float8 has no inf: its +-inf become NaN, more of them
        x = to_dtype(torch.tensor(x, device=device), getattr(torch, dtype))
        for name, kern, plain, tol in (
                ("cwtm", lambda t: cwtm(t, f), lambda t: cwtm_ref(t, f),
                 1e-5),
                ("median", median, median_ref, 1e-6)):
            got, want = kern(x), plain(x)
            same_nan = torch.equal(torch.isnan(got.float()),
                                   torch.isnan(want.float()))
            fin = torch.isfinite(want.float())
            err = (float((got[fin].float() - want[fin].float()).abs().max())
                   if bool(fin.any()) else 0.0)
            if dtype == "float32":
                ok = same_nan and torch.equal(
                    got[~fin].nan_to_num(), want[~fin].nan_to_num()) and \
                    err <= tol * max(1.0, float(want[fin].abs().max()))
                rule = f"{tol:g}"
            else:  # as kernel_case holds the narrow input classes
                lim = 1 if name == "cwtm" else 0
                ok = same_nan and int(narrow_steps(
                    torch, got, want, finite_max(torch, x)).max()) <= lim
                rule = (f"within {lim} step of {dtype} or "
                        f"{SUM_ROUNDING:g} of max |x|")
            log(f"kernel {name} {dtype} with NaN and +-inf {(b, n, d)} "
                f"f={f}: NaN at the plain version's places {same_nan}, "
                f"max|err| {err:.3g} ({rule}) {'ok' if ok else 'FAIL'}")
            out.append({"name": name, "shape": [b, n, d], "f": f,
                        "dtype": dtype, "ok": ok, "max_abs_err": err})
    return out


def kernel_phase(torch) -> dict:
    """pairdist, CWTM and median cases (``kernel_case``), then CWTM and the
    median with NaN among their inputs (:func:`sort_nan_cases`); fails
    where ptxas reported a spill in a sort kernel (:data:`SORT_PTXAS`)."""
    results = {k: [] for k in SORT_KERNELS}
    failures = []
    for name in SORT_KERNELS:
        cases = []
        for (b, n, f, d) in AWKWARD:
            dtypes = [torch.float32] + ([torch.bfloat16]
                                        if name != "pairdist" else [])
            for dt in dtypes:
                cases.append(((b, n, d), f, dt, False))
        for shape in PATH_SHAPES:
            cases.append((shape, F, torch.float32, True))
        if name == "cwtm":  # the LLM path's aggregation, f = 1
            cases.append(((1, LLM_WORKERS, LLM_D), 1, torch.float32, True))
        # the redesigned kernels' edges (after the cases above: their seeds
        # stay as they were)
        cases = [c + ("plain",) for c in cases]
        if name == "pairdist":
            cases += [((b, n, d), 0, getattr(torch, dt), False, ref)
                      for (b, n, d, dt, ref) in PAIRDIST_EDGES]
        else:
            cases += [((b, n, d), f, dt, False, "plain")
                      for (b, n, f, d) in SORT_EDGES
                      for dt in (torch.float32, torch.bfloat16)]
        # the grid's batched shape (last: the earlier seeds stay)
        cases.append((GRID_SHAPES[name], F, torch.float32, True, "plain"))
        if name == "cwtm":  # the audio train path's aggregation, f = 1
            cases.append(((1, LLM_WORKERS, AUDIO_D), 1, torch.float32, False,
                          "plain"))
            # the families' train paths (the plain version a slice of
            # coordinates at a time)
            cases += [((1, LLM_WORKERS, d), 1, torch.float32, False, "plain")
                      for _, d, _ in FAMILY_BANKS]
            # one column slice of the rounds that run by slices (RoSDHB's
            # payload and dense rounds, dasha's): DENSE_COLUMNS columns
            cases.append(((1, LLM_WORKERS, 1 << 24), 1, torch.float32, True,
                          "plain"))
            # the ragged last window of dbrx_132b's payload round (24,804
            # blocks of 512)
            cases.append(((1, LLM_WORKERS, DBRX_BANK[1] % (1 << 24)), 1,
                          torch.float32, False, "plain"))
        for i, (shape, f, dt, timed, ref) in enumerate(cases):
            rec = kernel_case(torch, name, shape, f, dt, timed, seed=100 + i,
                              reference=ref)
            results[name].append(rec)
            log_case(rec)
            if not rec["ok"]:
                failures.append(f"{name} {shape} {rec['dtype']}")
            # each case's blocks go back before the next case is timed (a
            # cached 48 GiB block doubled the host cost of later calls in
            # one run on an H100 80GB HBM3 and left it as it was in
            # another: --sort-ab's host_context)
            torch.cuda.empty_cache()
    # float16 and float8_e4m3fn inputs (last: the seeds above stay)
    for name in SORT_KERNELS:
        cases = [((b, n, d), f, dt, False) for (b, n, f, d) in SORT_EDGES
                 for dt in LOWP_DTYPES if name != "pairdist"]
        cases += [(shape, F, dt, True) for shape in LOWP_SORT_SHAPES
                  for dt in LOWP_DTYPES]
        if name == "cwtm":
            cases += [(LOWP_CWTM_LLM, 1, dt, True) for dt in LOWP_DTYPES]
        for i, (shape, f, dt, timed) in enumerate(cases):
            rec = kernel_case(torch, name, shape, f, getattr(torch, dt),
                              timed, seed=900 + i)
            results[name].append(rec)
            log_case(rec)
            if not rec["ok"]:
                failures.append(f"{name} {shape} {rec['dtype']}")
            torch.cuda.empty_cache()
    # bfloat16 at the same timed shapes (after the float16 and float8
    # cases: their seeds stay); pairdist at 1M against the float64 version
    # (see PAIRDIST_EDGES)
    for name in SORT_KERNELS:
        cases = [(shape, F, True) for shape in LOWP_SORT_SHAPES]
        if name == "cwtm":
            cases.append((LOWP_CWTM_LLM, 1, True))
        for i, (shape, f, timed) in enumerate(cases):
            ref = ("float64" if name == "pairdist" and shape[2] >= 1 << 20
                   else "plain")
            rec = kernel_case(torch, name, shape, f, torch.bfloat16, timed,
                              seed=950 + i, reference=ref)
            results[name].append(rec)
            log_case(rec)
            if not rec["ok"]:
                failures.append(f"{name} {shape} {rec['dtype']}")
            torch.cuda.empty_cache()
    results["nan"] = sort_nan_cases(torch)
    for dt in LOWP_DTYPES:
        results["nan"] += sort_nan_cases(torch, dtype=dt)
    failures += [f"{r['name']} {r['shape']} {r.get('dtype', '')} with NaN"
                 for r in results["nan"] if not r["ok"]]
    # the wrappers' host cost before any profiler runs in this process
    results["wrapper_pieces"] = wrapper_pieces(torch)
    # no sort kernel spills, at any N_PAD, V, load width or dtype (where
    # this process built them)
    failures += [f"{k} spills ({r})" for k, r in sorted(SORT_PTXAS.items())
                 if r["spill_stores"] or r["spill_loads"]]
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return results


def device_times(torch, cases, flash_cases=(), randk_cases=()) -> dict:
    """For each ``(name, shape, f, dtype name, seed, reps)``: the kernel's
    and the library call's ``(device µs, device operations, names)`` per
    call (:func:`device_us`), on the input made from the seed; the same for
    the flash forward and backward of each ``(case, seed)`` of
    ``flash_cases`` (:func:`flash_fns`; ``(case, seed, dtype)``), for the
    Block-RandK kernels of
    each ``("block" | "momentum", case, seed, names)`` of ``randk_cases``
    (:func:`randk_fns`, :func:`momentum_fn`); and the host µs of
    ``x.neg()`` before and after those profiler windows."""
    x = torch.randn((1, 13, 11958), device="cuda")
    neg = [host_us(torch, lambda: x.neg(), 10_000, warmup=100)]
    out = []
    for name, shape, f, dtype, seed, reps in cases:
        _, kern, _, lib = case_fns(torch, name, tuple(shape), f,
                                   getattr(torch, dtype), seed)
        out.append({who: device_us(torch, fn, reps) for who, fn in
                    (("kernel", kern), ("library", lib)) if fn is not None})
        del kern, lib
        torch.cuda.empty_cache()
    flash = []
    for case, seed, dtype in flash_cases:
        fns = flash_fns(torch, tuple(case), seed, dtype=dtype)
        flash.append({name: {who: device_us(torch, fn, 10) for who, fn in
                             zip(("kernel", "library"), pair)
                             if fn is not None}
                      for name, pair in fns.items()})
        del fns
        torch.cuda.empty_cache()
    randk = []
    for kind, case, seed, names in randk_cases:
        if kind == "block":
            fns = randk_fns(torch, tuple(case), seed)
        elif kind == "sweep":
            fns = momentum_sweep_fns(torch, tuple(case), momentum_inputs(
                torch, tuple(case), seed))[0]
        else:
            fns = {"momentum_scatter": momentum_fn(torch, tuple(case), seed)}
        # a window is one short kernel a call: more calls, as CUPTI drops
        # some events of a short profiler window (a sweep is 128 of them)
        reps = 3 if kind == "sweep" else 20 if len(case) > 8 else 5
        randk.append({name: device_us(torch, fns[name], reps)
                      for name in names})
        del fns
        torch.cuda.empty_cache()
    neg.append(host_us(torch, lambda: x.neg(), 10_000, warmup=100))
    return {"cases": out, "flash": flash, "randk": randk,
            "neg_host_us": neg}


def profile_cases(torch, results, fresh_process: bool = False,
                  flash=(), randk=None) -> None:
    """Device µs and device operations per call of each timed case's kernel
    and library call, after every timed phase: once started, the profiler
    (CUPTI) slows the launches that follow it, and a process that has run
    profiler windows before drops some of a later window's kernel events,
    so ``fresh_process`` measures in a new process (``--device-times``).
    ``flash``: the flash phase's records; the timed ones get the device µs
    of their forward and backward and of SDPA's. Fails if a pairdist call
    is not one device kernel. ``randk``: the randk phase's records; the
    timed ones get the device µs of their kernels (compress, decompress,
    ``momentum_scatter``)."""
    cases = [(name, rec["shape"], rec["f"], rec["dtype"], rec["seed"],
              rec["reps"]) for name in SORT_KERNELS for rec in results[name]
             if "seed" in rec]
    timed_flash = [rec for rec in flash if "flash_fwd" in rec]
    flash_cases = [(rec["case"], rec["seed"], rec["dtype"])
                   for rec in timed_flash]
    timed_randk = [] if randk is None else (
        [("block", rec) for rec in randk["block"] if "seed" in rec]
        + [("momentum", rec) for rec in randk["momentum"] if "seed" in rec]
        + [("sweep", rec) for rec in randk.get("momentum_sweep", ())
           if "seed" in rec])
    randk_cases = [
        (kind, (list(rec["shape"]) + [rec["block_size"], rec["kb"],
                                      rec["local"], rec["dtype"]]
                + ([rec["beta"], rec["neg_zero"]] if kind != "block"
                   else []) + ([rec["window"]] if "window" in rec else [])
                + ([rec["window_blocks"]] if kind == "sweep" else [])),
         rec["seed"],
         ([n for n in ("block_compress", "block_decompress") if n in rec]
          if kind == "block" else ["momentum_scatter", "cwtm"]
          if kind == "sweep" else ["momentum_scatter"]))
        for kind, rec in timed_randk]

    def measure(sort_cases, flash_cases, randk_cases=()):
        if not fresh_process:
            return device_times(torch, sort_cases, flash_cases, randk_cases)
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--device-times", json.dumps(
                                  {"sort": sort_cases,
                                   "flash": flash_cases,
                                   "randk": randk_cases})],
                             capture_output=True, text=True, timeout=900,
                             check=True)
        return json.loads(run.stdout.strip().splitlines()[-1])

    times = measure(cases, flash_cases, randk_cases)
    failures = []
    # CUPTI can drop a kernel event of a short window (one of the 5 calls
    # at [8, 13, 1048576] read 0.8 kernels a call in one run, where every
    # call launches one): a pairdist case that reads fewer kernels than
    # calls is measured once more, the check below holds the new reading
    # to exactly one kernel a call, both readings stay in the record, and
    # the first reading's µs per kernel it saw must agree with the second's
    # within PAIRDIST_REREAD_TOL (else the first reading was not a dropped
    # event alone)
    short = [i for i, (c, t) in enumerate(zip(cases, times["cases"]))
             if c[0] == "pairdist" and t["kernel"][1] < 1]
    readings = {}
    if short:
        again = measure([cases[i] for i in short], ())
        for i, t in zip(short, again["cases"]):
            (us1, ops1, _), (us2, ops2, _) = times["cases"][i]["kernel"], \
                t["kernel"]
            per_kernel = us1 / ops1 if ops1 else float("inf")
            readings[i] = [{"device_us": us1, "device_ops": ops1,
                            "device_us_a_kernel": per_kernel},
                           {"device_us": us2, "device_ops": ops2}]
            log(f"pairdist {cases[i][1]}: the profiler saw {ops1:g} "
                f"kernels a call ({per_kernel:.3f} us a kernel), "
                f"{ops2:g} measured again ({us2:.3f} us a call)")
            if abs(per_kernel - us2) > PAIRDIST_REREAD_TOL * us2:
                failures.append(f"pairdist {cases[i][1]}: {per_kernel:.3f} "
                                f"us a kernel in the first reading, "
                                f"{us2:.3f} in the second")
            times["cases"][i] = t
    for rec, t in zip(timed_flash, times["flash"]):
        for name, by_who in t.items():
            for who, (us, ops, names) in by_who.items():
                key = "" if who == "kernel" else "library_"
                rec[name].update({f"{key}device_us": us,
                                  f"{key}device_ops": ops})
            log(f"flash {name} {rec['case']} {rec['dtype']}: device us "
                f"{rec[name]['device_us']:.3f} ({rec[name]['device_ops']:g}"
                f" kernels a call), host us {rec[name]['host_us']:.3f}, "
                f"SDPA device us {rec[name].get('library_device_us')}")
    for (kind, rec), t in zip(timed_randk, times["randk"]):
        for name, (us, ops, names) in t.items():
            target = rec if kind == "momentum" else rec[name]
            target.update(device_us=us, device_ops=ops)
            if "window" in rec:  # the slot map built before: one kernel
                target["device_us_a_kernel"] = us / ops if ops else None
            log(f"randk {name} {rec['shape']} {rec['dtype']}"
                + (f" window {rec['window']}" if "window" in rec else "")
                + f": device us "
                f"{us:.3f} ({ops:g} kernels a call: {', '.join(names)}), "
                f"host us {target['host_us']:.3f}, loop ms "
                f"{target['ms']:.5f}")
    recs = [rec for name in SORT_KERNELS for rec in results[name]
            if "seed" in rec]
    results["neg_host_us"] = times["neg_host_us"]
    log(f"x.neg() host us per call: {times['neg_host_us'][0]:.3f} before "
        f"the kernels' profiler windows, {times['neg_host_us'][1]:.3f} "
        f"after")
    for i, (rec, t) in enumerate(zip(recs, times["cases"])):
        for who, (us, ops, names) in t.items():
            rec[who].update(device_us=us, device_ops=ops, device_names=names)
        if i in readings:
            rec["kernel"]["device_readings"] = readings[i]
        log_case(rec)
        if rec["name"] == "pairdist" and rec["kernel"]["device_ops"] != 1:
            failures.append(f"pairdist {rec['shape']}: "
                            f"{rec['kernel']['device_ops']} device "
                            f"operations a call")
    if failures:
        raise AssertionError(f"pairdist is not one launch, or its readings "
                             f"disagree: {failures}")


def log_case(rec) -> None:
    name, shape, f = rec["name"], rec["shape"], rec["f"]
    line = (f"kernel {name:8s} {str(tuple(shape)):22s} "
            f"{rec['dtype']:8s} f={f} max_abs_err={rec['max_abs_err']:.3g}"
            f" ({rec['tolerance']}) {'ok' if rec['ok'] else 'FAIL'}")
    if "ms" in rec:
        lib = rec["library_ms"]
        line += (f" | kernel_ms={rec['ms']:.5f} plain_ms="
                 f"{rec['plain_ms']:.5f} library_ms="
                 f"{'null' if lib is None else f'{lib:.5f}'}"
                 f" bound_us={rec['bound_ms'] * 1e3:.3f}"
                 f" ({rec['bound_by']})")
        for who in ("kernel", "library"):
            t = rec[who]
            if t is not None:
                line += f" | {who}: host_us={t['host_us']:.3f}"
            if t is not None and "device_us" in t:
                line += (f" device_us={t['device_us']:.3f}"
                         f" device_ops/call={t['device_ops']:g}"
                         f" ({', '.join(t['device_names'])})")
        if "bitwise_repeat" in rec:
            line += (f" | two launches bitwise equal: "
                     f"{rec['bitwise_repeat']}")
        if "plan" in rec:
            line += f" | plan {rec['plan']}"
    log(line)



def _bound(work: tuple, rate: str) -> tuple:
    """``(ms, "bytes" | "operations")`` of a kernel's ``work = (bytes,
    operations)`` (``repro_torch.launch.roofline``'s counts): the larger of
    the bytes over the HBM rate and the operations over the ``rate``
    (``"f32"`` or ``"bf16"``) of :func:`peak_rates`."""
    from repro_torch.launch.roofline import bound_ms as roofline_bound
    return roofline_bound(work, peak_rates()[rate])


def randk_inputs(torch, case, seed: int, device: str = "cuda") -> tuple:
    """``(g [n, d], block ids, alpha)`` of a Block-RandK case, made from
    ``seed``."""
    from repro_torch.utils.dtypes import to_dtype
    n, d, bs, kb, local, dt = case
    nb = d // bs
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, d), generator=gen, device=device)
    if dt in LOWP_DTYPES:
        # every 97th value past float8's range before the cast; compress
        # then multiplies by nb / kb, which takes more past it
        g[:, ::97] *= 600.0
    g = to_dtype(g, getattr(torch, dt))
    if local:
        ids = torch.stack([torch.randperm(nb, generator=gen, device=device)[:kb]
                           for _ in range(n)]).int()
    else:
        ids = torch.randperm(nb, generator=gen, device=device)[:kb].int()
    return g, ids, nb / kb


def randk_case(torch, case, timed: bool, seed: int, device: str = "cuda",
               decompress: bool = True) -> dict:
    """Block compress and decompress (``decompress=False``: compress only)
    against their plain versions, bitwise, and (below 1e8 values) against
    the dense mask multiply on finite inputs."""
    from repro_torch.kernels.randk import (block_compress_ref,
                                           block_decompress_ref, compress,
                                           decompress as decompress_kernel)
    n, d, bs, kb, local, dt = case
    dtype = getattr(torch, dt)
    nb = d // bs
    g, ids, alpha = randk_inputs(torch, case, seed, device)
    kern_c = lambda: compress(g, ids, block_size=bs, alpha=alpha)  # noqa: E731
    plain_c = lambda: block_compress_ref(g, ids, bs, alpha)  # noqa: E731
    pay = kern_c()
    pay_ref = plain_c()
    ok = {"block_compress": torch.equal(bits(torch, pay),
                                        bits(torch, pay_ref))}
    err = {"block_compress": max_abs_diff(pay, pay_ref)}
    nans = int(torch.isnan(pay.float()).sum())
    del pay_ref
    kern_d = lambda: decompress_kernel(pay, ids, block_size=bs,  # noqa: E731
                                       d=d)
    plain_d = lambda: block_decompress_ref(pay, ids, bs, d)  # noqa: E731
    if decompress:
        dense = kern_d()
        dense_ref = plain_d()
        ok_d = torch.equal(bits(torch, dense), bits(torch, dense_ref))
        err["block_decompress"] = max_abs_diff(dense, dense_ref)
        del dense_ref
        if n * d < 100_000_000 and dt != "float8_e4m3fn":
            # the reference's contract: bitwise the dense (alpha*g)*mask on
            # finite gradients (torch.equal takes -0.0 == 0.0)
            mask = torch.zeros((n, nb), dtype=dtype, device=device)
            mask.scatter_(1, ids.long().expand(n, kb), 1)
            want = (alpha * g) * mask.repeat_interleave(bs, dim=1)
            ok_d = ok_d and torch.equal(dense, want)
        ok["block_decompress"] = ok_d
        del dense
    rec = {"shape": [n, d], "block_size": bs, "kb": kb, "local": local,
           "dtype": dt, "ok": ok, "max_abs_err": err, "payload_nans": nans}
    if timed:
        from repro_torch.launch import roofline as RL
        isz = g.element_size()
        n_slots = nb if ids.ndim == 1 else n * nb
        rec["seed"] = seed  # for profile_cases
        rec["block_compress"] = {
            "ms": time_ms(torch, kern_c, 5), "plain_ms": time_ms(
                torch, plain_c, 5), "library_ms": None,
            "host_us": host_us(torch, kern_c, 20)}
        rec["block_compress"]["bound_ms"], rec["block_compress"][
            "bound_by"] = _bound(RL.compress_work(n, kb, bs, isz,
                                                  ids.numel()), "f32")
        if decompress:
            rec["block_decompress"] = {
                "ms": time_ms(torch, kern_d, 5), "plain_ms": time_ms(
                    torch, plain_d, 5), "library_ms": None,
                "host_us": host_us(torch, kern_d, 20)}
            rec["block_decompress"]["bound_ms"], rec["block_decompress"][
                "bound_by"] = _bound(RL.decompress_work(
                    n, d, kb, bs, isz, ids.numel(), n_slots), "f32")
    return rec


def randk_fns(torch, case, seed: int, device: str = "cuda") -> dict:
    """``{"block_compress": fn, "block_decompress": fn}``: the kernels'
    calls on the inputs :func:`randk_case` makes from ``seed``."""
    from repro_torch.kernels.randk import compress, decompress
    n, d, bs, kb, local, dt = case
    g, ids, alpha = randk_inputs(torch, case, seed, device)
    pay = compress(g, ids, block_size=bs, alpha=alpha)
    return {"block_compress": lambda: compress(g, ids, block_size=bs,
                                               alpha=alpha),
            "block_decompress": lambda: decompress(pay, ids, block_size=bs,
                                                   d=d)}


def bits(torch, x):
    """``x``'s bit pattern (bitwise comparison that tells -0.0 from +0.0
    and NaN from NaN)."""
    return x.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[x.element_size()])


def ulps_off(torch, got, want):
    """How many steps of their (one, narrow) dtype two tensors are apart,
    from their bit patterns as signed magnitudes; NaN against NaN is 0.
    float32 tensors are compared as float32."""
    size = got.element_size()
    wide = bits(torch, got).to(torch.int64), bits(torch, want).to(torch.int64)
    top = 1 << (8 * size - 1)

    def key(v):
        v = v & (2 * top - 1)
        return torch.where(v >= top, top - v, v)

    both = torch.isnan(got.float()) & torch.isnan(want.float())
    return torch.where(both, 0, (key(wide[0]) - key(wide[1])).abs())


#: Where two float32 sums of the same terms differ (another order, or the
#: 1/k factor applied to each term or to the sum), by up to this fraction
#: of the terms' largest magnitude: a result near zero rounds such a
#: difference to several of its narrow dtype's (fine) steps.
SUM_ROUNDING = 2.0 ** -20


def narrow_steps(torch, got, want, scale: float):
    """:func:`ulps_off`, taken as 0 where the two differ by no more than
    the float32 sums' rounding of terms of magnitude ``scale``
    (:data:`SUM_ROUNDING`)."""
    off = ulps_off(torch, got, want)
    near = (got.float() - want.float()).abs() <= SUM_ROUNDING * scale
    return torch.where(near, torch.zeros_like(off), off)


def finite_max(torch, x) -> float:
    """max |x| over the finite entries (0 if none), 2^26 values at a time
    (a float32 copy of CWTM's [1, 8, 416179200] input is 13 GB)."""
    out = 0.0
    for part in x.reshape(-1).split(1 << 26):
        pf = part.float()
        out = max(out, float(torch.where(torch.isfinite(pf), pf.abs(),
                                         0.0).max()))
    return out


def max_abs_diff(a, b) -> float:
    """max |a - b| in float32, a row at a time (the banks fill the card),
    over the entries where neither is NaN or infinite (the bitwise checks
    hold those)."""
    def row(x, y):
        x, y = x.float(), y.float()
        fin = x.isfinite() & y.isfinite()
        return float((x - y).masked_fill(~fin, 0.0).abs().max())
    return max(row(x, y) for x, y in zip(a, b))


#: Banks of more float32 bytes than this are drawn a row at a time (the
#: vlm's [8, 2.1e9] float8 bank: a float32 draw of it would not fit).
MOMENTUM_DRAW_BYTES = 16 << 30


def momentum_inputs(torch, case, seed: int, device: str = "cuda") -> tuple:
    """``(bank m0, payload, block ids)`` of a momentum case, made from
    ``seed``."""
    from repro_torch.utils.dtypes import to_dtype
    n, d, bs, kb, local, dt, beta, neg_zero = case[:8]
    dtype = getattr(torch, dt)
    nb = d // bs
    gen = torch.Generator(device=device).manual_seed(seed)
    if n * d * 4 <= MOMENTUM_DRAW_BYTES:
        m0 = to_dtype(torch.randn((n, d), generator=gen, device=device),
                      dtype)
    else:
        m0 = torch.empty((n, d), dtype=dtype, device=device)
        for r in range(n):
            m0[r] = to_dtype(torch.randn(d, generator=gen, device=device),
                             dtype)
    if neg_zero:  # the first block of every row, and every 7th value
        m0[:, :bs] = -0.0
        m0[:, ::7] = -0.0
    pay = to_dtype(torch.randn((n, kb * bs), generator=gen, device=device),
                   dtype)
    if local:
        ids = torch.stack([torch.randperm(nb, generator=gen, device=device)[:kb]
                           for _ in range(n)]).int()
    else:
        ids = torch.randperm(nb, generator=gen, device=device)[:kb].int()
    return m0, pay, ids


def momentum_window_args(torch, case, m0, ids, wide: bool = False) -> dict:
    """The keyword arguments of a windowed momentum call (the case's ninth
    entry ``(b0, b1)``): the window, the round's slot map built once, and
    a float32 buffer for the result of a bank narrower than float32 (of a
    wider row stride than the window's with ``wide``, as a caller's slice
    of a larger buffer may be)."""
    from repro_torch.kernels.randk import slot_map
    n, d, bs = case[:3]
    b0, b1 = case[8]
    width = (b1 - b0) * bs
    kw = {"window": (b0, b1), "slots": slot_map(ids, d // bs)}
    if m0.dtype != torch.float32:
        buf = torch.empty((n, width + (bs if wide else 0)),
                          dtype=torch.float32, device=m0.device)
        kw["out"] = buf[:, :width]
    return kw


def momentum_case(torch, case, timed: bool, seed: int,
                  device: str = "cuda") -> dict:
    """The momentum kernel against its plain version, bitwise in the bank
    and (bfloat16 bank) in the float32 result: the plain version a slice
    of columns at a time from the initial bank (``momentum_columns_ref``,
    the slices of ``momentum_scatter_ref``), each slice held against the
    kernel's (a second bank and float32 result of [8, 1e9] would not fit
    the card). A windowed case (:func:`momentum_window_args`) runs the
    plain version on its window first (its window of the bank kept aside
    and put back), then the kernel on that window alone: the window held
    to the plain version's, the float32 result too, and (below 1 GiB) the
    rest of the bank to a copy of the bank as it was."""
    from repro_torch.kernels.randk import momentum_scatter_ref, momentum_update
    from repro_torch.kernels.randk.ref import (MOMENTUM_COLS,
                                               momentum_columns_ref)
    from repro_torch.utils.dtypes import to_dtype
    n, d, bs, kb, local, dt, beta, neg_zero = case[:8]
    window = case[8] if len(case) > 8 else None
    m0, pay, ids = momentum_inputs(torch, case, seed, device)
    dtype = m0.dtype
    f32_out = dtype != torch.float32
    ok, err = True, 0.0
    if window is not None:
        b0, b1 = window
        cols = slice(b0 * bs, b1 * bs)
        small = m0.numel() * m0.element_size() < (1 << 30)
        kw = momentum_window_args(torch, case, m0, ids, wide=small)
        before = m0[:, cols].clone()
        res = momentum_columns_ref(m0, pay, ids, bs, beta, b0, b1)
        want = m0[:, cols].clone()
        m0[:, cols] = before
        del before
        whole = m0.clone() if small else None
        m_k = m0
        out_k = momentum_update(m_k, pay, ids, block_size=bs, beta=beta,
                                **kw)
        ok = torch.equal(bits(torch, m_k[:, cols]), bits(torch, want))
        err = max_abs_diff(m_k[:, cols], want)
        if f32_out:
            ok = ok and out_k is kw["out"] and torch.equal(
                bits(torch, out_k), bits(torch, res))
            err = max(err, max_abs_diff(out_k, res))
        if whole is not None:
            rest = torch.ones(d, dtype=torch.bool, device=m0.device)
            rest[cols] = False
            ok = ok and torch.equal(bits(torch, m_k[:, rest]),
                                    bits(torch, whole[:, rest]))
        del res, want, whole, out_k
    else:
        kw = ({"out": torch.empty((n, d), dtype=torch.float32,
                                  device=m0.device)} if f32_out else {})
        m_k = m0.clone()
        out_k = momentum_update(m_k, pay, ids, block_size=bs, beta=beta,
                                **kw)
        if not f32_out:
            out_k = None
        step = max(1, MOMENTUM_COLS // bs)
        for b0 in range(0, d // bs, step):
            b1 = min(d // bs, b0 + step)
            cols = slice(b0 * bs, b1 * bs)
            res = momentum_columns_ref(m0, pay, ids, bs, beta, b0, b1)
            ok = ok and torch.equal(bits(torch, m_k[:, cols]),
                                    bits(torch, to_dtype(res, dtype)))
            err = max(err, max_abs_diff(m_k[:, cols], to_dtype(res, dtype)))
            if out_k is not None:
                ok = ok and torch.equal(bits(torch, out_k[:, cols]),
                                        bits(torch, res))
                err = max(err, max_abs_diff(out_k[:, cols], res))
            del res
        del out_k
    rec = {"shape": [n, d], "block_size": bs, "kb": kb, "local": local,
           "dtype": dt, "beta": beta, "neg_zero": neg_zero, "ok": ok,
           "max_abs_err": err}
    if window is not None:
        rec["window"] = list(window)
    if timed:
        from repro_torch.launch import roofline as RL
        kern = lambda: momentum_update(m_k, pay, ids, block_size=bs,  # noqa
                                       beta=beta, **kw)
        rec["ms"] = time_ms(torch, kern, 5)
        rec["host_us"] = host_us(torch, kern, 10)
        rec["seed"] = seed  # for profile_cases
        if window is None:
            del m_k
            rec["plain_ms"] = time_ms(torch, lambda: momentum_scatter_ref(
                m0, pay, ids, bs, beta, **kw), 3)
            work = RL.momentum_work(n, d, kb, bs, m0.element_size(),
                                    pay.element_size(), ids.numel(), f32_out)
        else:
            b0, b1 = window
            rec["plain_ms"] = time_ms(torch, lambda: momentum_scatter_ref(
                m0, pay, ids, bs, beta, **kw), 3)
            # the window's own work: its bank columns, the payload blocks
            # whose ids fall in it and the slot map's entries it reads
            inside = int(((ids >= b0) & (ids < b1)).sum())
            work = RL.momentum_work(n, (b1 - b0) * bs,
                                    inside // (n if local else 1), bs,
                                    m0.element_size(), pay.element_size(),
                                    (b1 - b0) * (n if local else 1), f32_out)
        rec["library_ms"] = None  # no single call decays and scatter-adds
        rec["bound_ms"], rec["bound_by"] = _bound(work, "f32")
    return rec


def momentum_fn(torch, case, seed: int, device: str = "cuda"):
    """The momentum kernel's call on the inputs :func:`momentum_case` makes
    from ``seed`` (on a copy of the bank, updated in place each call; a
    windowed case with its slot map and buffer made once)."""
    from repro_torch.kernels.randk import momentum_update
    n, d, bs, kb, local, dt, beta, neg_zero = case[:8]
    m0, pay, ids = momentum_inputs(torch, case, seed, device)
    if len(case) > 8:
        kw = momentum_window_args(torch, case, m0, ids)
    elif m0.dtype != torch.float32:
        kw = {"out": torch.empty((n, d), dtype=torch.float32,
                                 device=m0.device)}
    else:
        kw = {}
    return lambda: momentum_update(m0, pay, ids, block_size=bs, beta=beta,
                                   **kw)


def momentum_sweep_fns(torch, case, inputs, device: str = "cuda"):
    """The payload round's steps 5 and 6 over every window of ``case[8]``
    blocks of the case's bank, as ``algorithms._payload_apply``
    launches them (one slot map, one reused float32 slice), on ``inputs``
    (:func:`momentum_inputs`): ``({"momentum_scatter": the momentum kernel
    over the windows, "cwtm": CWTM (f = 1) over each window's slice into
    the direction}, (slots, buf), windows)``. One sweep runs first (it
    fills the slice)."""
    from repro_torch.core import AggregatorConfig, make_aggregator
    from repro_torch.kernels.randk import momentum_update, slot_map
    n, d, bs, kb, local, dt, beta, _, step = case
    m0, pay, ids = inputs
    nb = d // bs
    slots = slot_map(ids, nb)
    buf = torch.empty(n * step * bs, dtype=torch.float32, device=device)
    r = torch.empty(d, dtype=torch.float32, device=device)
    agg = make_aggregator(AggregatorConfig(name="cwtm", f=1), device=device)
    wins = [(b0, min(nb, b0 + step)) for b0 in range(0, nb, step)]

    def slice_of(b0, b1):
        return buf[:n * (b1 - b0) * bs].view(n, (b1 - b0) * bs)

    def momentum():
        for b0, b1 in wins:
            momentum_update(m0, pay, ids, block_size=bs, beta=beta,
                            window=(b0, b1), slots=slots,
                            out=slice_of(b0, b1))

    def cwtm():
        for b0, b1 in wins:
            r[b0 * bs:b1 * bs] = agg(slice_of(b0, b1))

    momentum()
    return {"momentum_scatter": momentum, "cwtm": cwtm}, (slots, buf), wins


def momentum_sweep_case(torch, case, timed: bool, seed: int,
                        device: str = "cuda") -> dict:
    """The momentum kernel over every window of the bank
    (:func:`momentum_sweep_fns`): after one sweep, the bank at its first, a
    middle and its last window held bitwise to the plain version from the
    initial bank there, the slice (the last window's float32 momenta) too.
    Timed: the sweep of the momentum kernel and of CWTM over the slices,
    each between two CUDA events (loop ms) and on the host; the plain
    version's sweep; the bound of each sweep's work, its windows' summed."""
    from repro_torch.kernels.randk import momentum_scatter_ref
    from repro_torch.kernels.randk.ref import momentum_columns_ref
    from repro_torch.launch import roofline as RL
    n, d, bs, kb, local, dt, beta, _, step = case
    m0, pay, ids = momentum_inputs(torch, case, seed, device)
    nb = d // bs
    wins = [(b0, min(nb, b0 + step)) for b0 in range(0, nb, step)]
    checked = [wins[0], wins[len(wins) // 2], wins[-1]]
    before = [m0[:, b0 * bs:b1 * bs].clone() for b0, b1 in checked]
    fns, (slots, buf), wins = momentum_sweep_fns(torch, case, (m0, pay, ids),
                                                 device)
    ok, err = True, 0.0
    for (b0, b1), init in zip(checked, before):
        cols = slice(b0 * bs, b1 * bs)
        got = m0[:, cols].clone()
        m0[:, cols] = init
        res = momentum_columns_ref(m0, pay, ids, bs, beta, b0, b1)
        ok = ok and torch.equal(bits(torch, got), bits(torch, m0[:, cols]))
        err = max(err, max_abs_diff(got, m0[:, cols]))
        if (b0, b1) == wins[-1]:
            last = buf[:n * (b1 - b0) * bs].view(n, -1)
            ok = ok and torch.equal(bits(torch, last), bits(torch, res))
            err = max(err, max_abs_diff(last, res))
        del got, res
    del before
    rec = {"shape": [n, d], "block_size": bs, "kb": kb, "local": local,
           "dtype": dt, "beta": beta, "neg_zero": False,
           "window_blocks": step, "windows": len(wins), "ok": ok,
           "max_abs_err": err, "checked_windows": [list(w) for w in checked]}
    if timed:
        rec["seed"] = seed  # for profile_cases
        # the work of each window: its bank columns, the payload blocks
        # whose ids fall in it and the slot map's entries it reads; CWTM
        # reads the window's float32 slice and writes its columns of r
        works = {"momentum_scatter": [0, 0], "cwtm": [0, 0]}
        for b0, b1 in wins:
            inside = int(((ids >= b0) & (ids < b1)).sum())
            for i, v in enumerate(RL.momentum_work(
                    n, (b1 - b0) * bs, inside, bs, m0.element_size(),
                    pay.element_size(), b1 - b0, True)):
                works["momentum_scatter"][i] += v
            for i, v in enumerate(RL.sorted_weight_work(
                    1, n, (b1 - b0) * bs, 4)):
                works["cwtm"][i] += v
        for name, fn in fns.items():
            t = {"ms": time_ms(torch, fn, 3, warmup=1),
                 "host_us": host_us(torch, fn, 3, warmup=1),
                 "library_ms": None}
            t["bound_ms"], t["bound_by"] = _bound(tuple(works[name]), "f32")
            rec[name] = t

        def plain():
            for b0, b1 in wins:
                w = (b1 - b0) * bs
                momentum_scatter_ref(m0, pay, ids, bs, beta, window=(b0, b1),
                                     out=buf[:n * w].view(n, w))

        rec["momentum_scatter"]["plain_ms"] = time_ms(torch, plain, 1,
                                                      warmup=0)
    del fns, m0, pay, ids, slots, buf
    return rec


def float8_store_case(torch, device: str = "cuda") -> dict:
    """The momentum kernel's float8 store against ``utils.dtypes.to_float8``
    (the reference's cast), bitwise: a float32 payload written into a
    zero float8 bank with beta 0 (the store of the payload as it is, -0.0
    made +0.0 by the update's add) over
    :data:`FLOAT8_EDGES` and their negations, a sweep of [-500, 500], and
    float32 bit patterns every 37 from 0 up to 2^24 (the subnormals and
    the small normals), both signs. Values past 464, +-inf and NaN must
    come back NaN of their sign, where PyTorch's own cast gives 448."""
    from repro_torch.kernels.randk import momentum_update
    from repro_torch.utils.dtypes import FLOAT8, to_float8
    bs = 512
    edges = torch.tensor(FLOAT8_EDGES, device=device)
    pats = torch.arange(0, 1 << 24, 37, device=device,
                        dtype=torch.int32).view(torch.float32)
    vals = torch.cat([edges, -edges, torch.linspace(-500, 500, 1 << 18,
                                                     device=device),
                      pats, -pats])
    width = -(-vals.numel() // bs) * bs
    pay = torch.zeros((1, width), device=device)
    pay[0, :vals.numel()] = vals
    nb = width // bs
    bank = torch.zeros((1, width), dtype=FLOAT8, device=device)
    ids = torch.arange(nb, dtype=torch.int32, device=device)
    momentum_update(bank, pay, ids, block_size=bs, beta=0.0,
                    out=torch.empty_like(pay))
    # the update is fma(0, m, 1 * p): p itself, but +0.0 for -0.0
    want = to_float8(pay + 0.0)
    ok = torch.equal(bits(torch, bank), bits(torch, want))
    nan = int(torch.isnan(bank.float()).sum())
    sat = int((pay.abs() > 464).sum() + torch.isnan(pay).sum())
    log(f"float8 store: {vals.numel()} values through momentum_scatter's "
        f"float8 store against to_float8, bitwise {ok}; {nan} NaN for "
        f"{sat} values past 464, inf or NaN (PyTorch's own cast: "
        f"{float(torch.tensor(470.0, device=device).to(FLOAT8).float())} "
        f"for 470)")
    if not ok or nan != sat:
        raise AssertionError("float8 store: the kernel does not round as "
                             "the reference's cast")
    return {"values": vals.numel(), "bitwise": ok, "nan": nan}


def server_round_case(torch, n: int = LLM_WORKERS, d: int = LLM_D,
                      bs: int = LLM_BS, device: str = "cuda") -> dict:
    """One RoSDHB round on the payload route (compress, ALIE on the payload,
    the momentum kernel, CWTM) against one dense round (compress and
    decompress, ALIE on the dense wire, the dense momentum, CWTM) from the
    same bank, momentum and block ids: the momentum bitwise, the direction
    within rtol 1e-5 (CWTM sums the same values; only the kernel's float32
    order could differ, and it does not)."""
    import numpy as np
    from repro_torch.core import algorithms as alg
    from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                                  AttackConfig, SparsifierConfig)
    from repro_torch.core import make_aggregator
    from repro_torch.testing import ReplayDraws
    cfg = AlgorithmConfig(
        name="rosdhb", n_workers=n, f=1, beta=0.9,
        sparsifier=SparsifierConfig(kind="block", ratio=0.05, block_size=bs),
        aggregator=AggregatorConfig(name="cwtm", f=1),
        attack=AttackConfig(name="alie"))
    nb = d // bs
    kb = max(1, int(round(0.05 * nb)))
    ids = np.random.default_rng(7).permutation(nb)[:kb]
    gen = torch.Generator(device=device).manual_seed(11)
    grads = torch.randn((n, d), generator=gen, device=device)
    m0 = torch.randn((n, d), generator=gen, device=device)
    agg = make_aggregator(cfg.aggregator, device=device)
    state = alg.init_state(cfg, 1, device=device)._replace(momentum=m0)
    assert alg._payload_route(cfg, d)
    # the dense round first: it leaves m0 as it was
    hp = alg.static_hparams(cfg)
    wire = alg._compressed_wire(cfg, grads, ReplayDraws(device,
                                                        permutations=[ids]))
    r_dense, dense = alg._rosdhb_apply(cfg, agg, state, wire, hp)
    del wire
    m_dense = dense.momentum.cpu()
    del dense
    sync(torch, device)
    t0 = time.perf_counter()
    r_fused, fused, _ = alg.server_round(
        cfg, state, grads, ReplayDraws(device, permutations=[ids]), agg=agg)
    sync(torch, device)
    fused_ms = (time.perf_counter() - t0) * 1e3
    del grads, state
    m_dense = m_dense.to(device)
    ok_m = torch.equal(bits(torch, fused.momentum), bits(torch, m_dense))
    diff = float((r_fused - r_dense).abs().max())
    del m_dense
    scale = float(r_dense.abs().max())
    ok_r = diff <= 1e-5 * scale
    log(f"server round [{n}, {d}]: payload route vs dense round, momentum "
        f"bitwise {ok_m}, direction max |d| {diff:.3g} of max |R| "
        f"{scale:.4g} (bound rtol 1e-5) {'ok' if ok_r else 'FAIL'}; "
        f"payload round {fused_ms:.3f} ms (host clock)")
    if not (ok_m and ok_r):
        raise AssertionError("server round: payload route and dense round "
                             "disagree")
    return {"momentum_bitwise": ok_m, "dir_max_abs_diff": diff,
            "dir_scale": scale, "payload_round_ms": fused_ms}


def randk_phase(torch, device: str = "cuda", path=RANDK_PATH,
                momentum_path=MOMENTUM_PATH, round_shape=None,
                audio=RANDK_AUDIO, momentum_audio=MOMENTUM_AUDIO,
                families=RANDK_FAMILIES,
                momentum_families=MOMENTUM_FAMILIES, lowp=RANDK_LOWP,
                momentum_lowp=MOMENTUM_LOWP,
                momentum_vlm=MOMENTUM_VLM, dbrx=RANDK_DBRX,
                momentum_sweeps=MOMENTUM_SWEEPS) -> dict:
    """Block-RandK kernel cases: awkward shapes (float16 and float8 among
    them), the audio train path's (``audio``), the families' train paths'
    (``families``: compress only, timed), one row of dbrx_132b's float8
    bank as the streamed step compresses it (``dbrx``: compress only,
    timed), the LLM path's bank in float16 and float8 (``lowp``, timed),
    then the LLM path's (timed, last); the momentum kernel likewise (the
    families' and then ``momentum_lowp``, timed), its windowed awkward
    cases and the vlm's float8 bank at its first and last window
    (``momentum_vlm``, timed) and, the vlm's and then dbrx_132b's, over all
    the bank's windows with CWTM on their slices (``momentum_sweeps``,
    timed, :func:`momentum_sweep_case`); the float8 store at its edges
    (:func:`float8_store_case`); then one server round, payload route
    against dense round, at the LLM path's shape (``round_shape`` ``(n, d,
    bs)`` overrides it)."""
    out, failures = {"block": [], "momentum": []}, []
    # (case, timed, seed, decompress): the seeds of the cases before stay
    # as they were
    n_awk = len(RANDK_AWKWARD)
    cases = ([(c, False, 300 + i, True) for i, c in enumerate(RANDK_AWKWARD)]
             + [(audio, False, 300 + n_awk + 1, True)]
             + [(c, True, 300 + n_awk + 2 + i, False)
                for i, c in enumerate(families)]
             + [(dbrx, True, 370, False)]
             + [(c, False, 360 + i, True)
                for i, c in enumerate(RANDK_AWKWARD_LOWP)]
             + [(c, True, 350 + i, True) for i, c in enumerate(lowp)]
             + [(path, True, 300 + n_awk, True)])
    for case, timed, seed, dec in cases:
        rec = randk_case(torch, case, timed and device == "cuda",
                         seed=seed, device=device, decompress=dec)
        out["block"].append(rec)
        line = (f"kernel block_compress/decompress n={case[0]} d={case[1]} "
                f"bs={case[2]} kb={case[3]} local={case[4]} {case[5]}: "
                f"bitwise {rec['ok']}")
        for name in ("block_compress", "block_decompress"):
            if name in rec:
                t = rec[name]
                line += (f" | {name} ms={t['ms']:.5f} plain_ms="
                         f"{t['plain_ms']:.5f} bound_ms={t['bound_ms']:.5f}"
                         f" ({t['bound_by']}) library_ms=null")
        log(line)
        failures += [f"{k} {case}" for k, v in rec["ok"].items() if not v]
        if device == "cuda":
            torch.cuda.empty_cache()
    # the windowed cases last: the seeds of the cases before stay as they
    # were
    whole = [c for c in MOMENTUM_AWKWARD if len(c) == 8]
    whole_lowp = [c for c in MOMENTUM_AWKWARD_LOWP if len(c) == 8]
    windowed = [c for c in MOMENTUM_AWKWARD + MOMENTUM_AWKWARD_LOWP
                if len(c) > 8]
    cases = ([(c, False) for c in whole]
             + [(c, True) for c in momentum_path])
    cases = ([(c, t, 400 + i) for i, (c, t) in enumerate(cases)]
             + [(momentum_audio, False, 400 + len(cases))]
             + [(c, True, 400 + len(cases) + 1 + i)
                for i, c in enumerate(momentum_families)]
             + [(c, False, 460 + i) for i, c in enumerate(whole_lowp)]
             + [(c, True, 450 + i) for i, c in enumerate(momentum_lowp)]
             + [(c, False, 480 + i) for i, c in enumerate(windowed)]
             + [(c, True, 470 + i) for i, c in enumerate(momentum_vlm)])
    for case, timed, seed in cases:
        rec = momentum_case(torch, case, timed and device == "cuda",
                            seed=seed, device=device)
        out["momentum"].append(rec)
        line = (f"kernel momentum_scatter n={case[0]} d={case[1]} "
                f"bs={case[2]} kb={case[3]} local={case[4]} {case[5]} "
                f"beta={case[6]} -0.0={case[7]}"
                + (f" window={case[8]}" if len(case) > 8 else "")
                + f": bitwise {rec['ok']}")
        if "ms" in rec:
            line += (f" | ms={rec['ms']:.5f} plain_ms={rec['plain_ms']:.5f}"
                     f" bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']})"
                     f" library_ms=null")
        log(line)
        if not rec["ok"]:
            failures.append(f"momentum_scatter {case}")
        if device == "cuda":
            torch.cuda.empty_cache()
    out["momentum_sweep"] = []
    for i, sweep in enumerate(momentum_sweeps):
        rec = momentum_sweep_case(torch, sweep, device == "cuda",
                                  seed=490 + i, device=device)
        out["momentum_sweep"].append(rec)
        line = (f"kernel momentum_scatter n={rec['shape'][0]} "
                f"d={rec['shape'][1]} {rec['dtype']}: {rec['windows']} "
                f"windows of {rec['window_blocks']} blocks, bitwise "
                f"{rec['ok']} at {rec['checked_windows']}")
        for name in ("momentum_scatter", "cwtm"):
            if name in rec:
                t = rec[name]
                line += (f" | {name} sweep ms={t['ms']:.5f} host_us="
                         f"{t['host_us']:.1f} bound_ms={t['bound_ms']:.5f}"
                         + (f" plain_ms={t['plain_ms']:.5f}"
                            if "plain_ms" in t else ""))
        log(line)
        if not rec["ok"]:
            failures.append(f"momentum_scatter sweep {sweep}")
        if device == "cuda":
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"block kernels disagree: {failures}")
    out["float8_store"] = float8_store_case(torch, device)
    n, d, bs = round_shape or (LLM_WORKERS, LLM_D, LLM_BS)
    out["server_round"] = server_round_case(torch, n, d, bs, device=device)
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def flash_pairs(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """Visible (query, key) pairs: the work the mask leaves."""
    total = 0
    for i in range(sq):
        qpos = q_offset + i
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def tile_rel_err(torch, got, want, rows: int = FLASH_TILE_ROWS) -> float:
    """Worst block of ``rows`` rows of one head of ``[B, S, heads, D]``
    tensors: rms(got - want) / rms(want); a block whose plain values are
    all zero reads 0 if the kernel's are too, else inf."""
    import torch.nn.functional as Fn
    diff = got.detach().float() - want.detach().float()
    err = Fn.pad(diff.pow(2).sum(-1), (0, 0, 0, -want.shape[1] % rows))
    ref = Fn.pad(want.detach().float().pow(2).sum(-1),
                 (0, 0, 0, -want.shape[1] % rows))
    err, ref = (t.unflatten(1, (-1, rows)).sum(2) for t in (err, ref))
    ratio = torch.where(ref > 0, (err / ref).sqrt(),
                        torch.where(err > 0, math.inf, 0.0))
    return float(ratio.max())


def flash_fault_readings(torch, case, seed: int,
                         device: str = "cuda") -> dict:
    """What :func:`tile_rel_err` reads for out, dq, dk and dv when one tile
    is dropped: the plain version of one head of ``case``, with and without
    the pairs of its last 64 query rows and the 128 keys from the last
    row's first visible key. That is the fault the check must catch: the
    smallest tile of any of the kernels, where most keys share each row."""
    from repro_torch.kernels.flash_attention import attention_mask
    _, sq, sk, _, _, d, causal, window, q_offset = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn((1, s, 1, d), generator=gen, device=device)
                     .to(torch.bfloat16).float() for s in (sq, sk, sk, sq))
    mask = attention_mask(sq, sk, causal, window, q_offset, device)
    first = int(mask[-1].nonzero()[0])
    drop = mask.clone()
    drop[max(0, sq - 64):, first:first + 128] = False

    def plain(visible):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        logits = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~visible, -1e30), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, leaves[2])
        return [o, *torch.autograd.grad(o, leaves, dout)]
    return {name: tile_rel_err(torch, bad, good) for name, bad, good in
            zip(("out", "dq", "dk", "dv"), plain(drop), plain(mask))}


def launch_inputs(torch, q, k, v, dout) -> tuple:
    """What the kernels are launched on for a case: ``(q, k, v, dout,
    scale)`` as they are (scale None: ``1/sqrt(D)``), or at a head dim
    they are not built for (192) zero-padded to the next multiple of 128
    with the head dim's own scale ``1/sqrt(D)`` (``ops.padded_attention``;
    dout's padded lanes are zero, as the slice's gradient is)."""
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import padded_dim
    d = q.shape[-1]
    dp = padded_dim(d, q.dtype)
    if dp == d:
        return q, k, v, dout, None
    pad = (0, dp - d)
    return tuple(Fn.pad(t, pad) for t in (q, k, v, dout)) + (
        1.0 / math.sqrt(d),)


def flash_tols(dtype: str) -> tuple:
    """``(out, grad, tile out, tile grad)`` bounds of a flash case of
    ``dtype``, as fractions of max|plain| and of each tile's rms(plain)."""
    if dtype == "float32":
        return (FLASH_F32_TOL,) * 2 + (FLASH_F32_TILE_TOL,) * 2
    return (FLASH_TOL_OUT, FLASH_TOL_GRAD, FLASH_TILE_TOL_OUT,
            FLASH_TILE_TOL_GRAD)


def flash_inputs(torch, case, seed: int, dtype: str, device: str) -> tuple:
    """q, k, v and dout of ``case`` from ``seed``: normal draws, rounded to
    ``dtype``."""
    b, sq, sk, h, kv, d = case[:6]
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(
        getattr(torch, dtype)) for s in ((b, sq, h, d), (b, sk, kv, d),
                                         (b, sk, kv, d), (b, sq, h, d)))


def flash_case(torch, case, timed: bool, seed: int,
               device: str = "cuda", dtype: str = "bfloat16") -> dict:
    """Flash forward and backward against the plain version computed in
    float32 from the same inputs (bfloat16, or float32: the float32
    kernels): out, dq, dk, dv; on the card the launches land on the
    kernels of ``dtype`` (one forward, one backward)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    b, sq, sk, h, kv, d, causal, window, q_offset = case
    q, k, v, dout = flash_inputs(torch, case, seed, dtype, device)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    o = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, dout)
    launched = {n: c for n, c in K.launches().items() if c}
    keys = ("flash_fwd_f32", "flash_bwd_f32") if dtype == "float32" else \
        ("flash_fwd", "flash_bwd")
    want_launched = {n: 1 for n in keys} if device == "cuda" else {}
    fl = [t.float().requires_grad_() for t in (q, k, v)]
    o_ref = attention_ref(*fl, **kw)
    grads_ref = torch.autograd.grad(o_ref, fl, dout.float())
    tol_out, tol_grad, tile_out, tile_grad = flash_tols(dtype)
    errs, ok = {}, launched == want_launched
    for name, got, want, tol, tile_tol in [
            ("out", o, o_ref, tol_out, tile_out)] + [
            (n_, g_, w_, tol_grad, tile_grad) for n_, g_, w_
            in zip(("dq", "dk", "dv"), grads, grads_ref)]:
        err = float((got.detach().float() - want.detach()).abs().max())
        scale = float(want.detach().abs().max())
        errs[name] = err
        errs[name + "_rel"] = err / scale
        errs[name + "_tile"] = tile_rel_err(torch, got, want)
        ok = ok and got.shape == want.shape and got.dtype == q.dtype and \
            math.isfinite(err) and err <= tol * scale and \
            errs[name + "_tile"] <= tile_tol
    if timed and dtype == "float32":
        # the kernels and the plain version each against float64, as
        # max|err| / max|float64|: whose rounding the distance above is
        d64 = [t.double().requires_grad_() for t in (q, k, v)]
        o64 = attention_ref(*d64, **kw)
        want64 = [o64.detach(), *torch.autograd.grad(o64, d64,
                                                     dout.double())]
        for who, vals in (("kernel", [o, *grads]),
                          ("plain", [o_ref, *grads_ref])):
            errs[f"{who}_f64"] = {
                n: float((a.detach().double() - w).abs().max()
                         / w.abs().max())
                for n, a, w in zip(("out", "dq", "dk", "dv"), vals, want64)}
        del d64, o64, want64
    del fl, o_ref, grads_ref
    rec = {"case": list(case), "dtype": dtype, "errs": errs, "ok": ok,
           "launched": launched,
           "tolerance": f"max|err| <= {tol_out:g} max|plain| (out), "
                        f"{tol_grad:g} max|plain| (dq, dk, dv); "
                        f"worst {FLASH_TILE_ROWS}-row tile rms(err) <= "
                        f"{tile_out:g} rms(plain) (out), "
                        f"{tile_grad:g} (dq, dk, dv)"}
    if device == "cuda":
        # the dk/dv blocks' split on this card (flash.dkdv_plan) and the
        # backward's scratch (its partial sums, dS^T at 256)
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import (bwd_scratch,
                                                         dkdv_plan)
        rec["nsplit"] = dkdv_plan(*case, sms=build.sm_count(
            q.get_device()), dtype=q.dtype)["nsplit"]
        rec["scratch_mib"] = bwd_scratch(
            *case[:6], rec["nsplit"], q.dtype) / 2 ** 20
        from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                         flash_fwd_cuda)
        qp, kp, vp, dp_, sc = launch_inputs(torch, q, k, v, dout)
        o_k, lse = flash_fwd_cuda(qp, kp, vp, **kw, scale=sc)
        # no atomics (the split's partial sums added in a fixed order): two
        # backward runs are bitwise equal
        runs = [flash_bwd_cuda(qp, kp, vp, o_k, lse, dp_, **kw, scale=sc)
                for _ in range(2)]
        rec["bwd_bitwise_repeat"] = all(
            torch.equal(a, b_) for a, b_ in zip(*runs))
        rec["ok"] = rec["ok"] and rec["bwd_bitwise_repeat"]
        del runs, o_k, lse, qp, kp, vp, dp_
    if timed:
        rec["seed"] = seed  # for profile_cases
        from repro_torch.launch.roofline import flash_work
        work = flash_work(b, sq, sk, h, kv, d,
                          flash_pairs(sq, sk, causal, window, q_offset),
                          itemsize=q.element_size())
        rate = "f32" if dtype == "float32" else "bf16"
        fns = flash_fns(torch, case, seed, dtype=dtype)
        for name, (kern, lib) in fns.items():
            rec[name] = {"ms": time_ms(torch, kern, 10),
                         "host_us": host_us(torch, kern, 100),
                         "library_ms": (time_ms(torch, lib, 10)
                                        if lib is not None else None)}
        rec["flash_fwd"]["plain_ms"] = time_ms(
            torch, lambda: attention_ref(q, k, v, **kw), 5)
        rec["flash_fwd"]["bound_ms"], rec["flash_fwd"]["bound_by"] = _bound(
            work["flash_fwd"], rate)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o_p = attention_ref(*leaves, **kw)
        rec["flash_bwd"]["plain_ms"] = time_ms(torch, lambda: torch.autograd
                                               .grad(o_p, leaves, dout,
                                                     retain_graph=True), 5)
        del o_p
        rec["flash_bwd"]["bound_ms"], rec["flash_bwd"]["bound_by"] = _bound(
            work["flash_bwd"], rate)
        if rec["flash_fwd"]["library_ms"] is not None:
            sdpa, (qt, kt, vt, dt_) = sdpa_inputs(torch, q, k, v, dout)
            lt = [t.clone().requires_grad_() for t in (qt, kt, vt)]

            def fwd_bwd():
                o2 = sdpa(*lt)
                torch.autograd.grad(o2, lt, dt_)
            rec["library_fwd_bwd_ms"] = time_ms(torch, fwd_bwd, 10)
        del fns
    return rec


def sdpa_inputs(torch, q, k, v, dout):
    """PyTorch's fused attention (the yardstick, never used by the port;
    ``enable_gqa`` where k and v have fewer heads than q) and the inputs in
    its ``[B, H, S, D]`` layout."""
    import torch.nn.functional as Fn
    gqa = q.shape[2] != k.shape[2]
    sdpa = lambda *a: Fn.scaled_dot_product_attention(  # noqa: E731
        *a, is_causal=True, enable_gqa=gqa)
    return sdpa, [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]


def flash_fns(torch, case, seed: int, device: str = "cuda",
              dtype: str = "bfloat16") -> dict:
    """``{"flash_fwd": (kernel, library), "flash_bwd": (kernel, library)}``
    calls on the inputs :func:`flash_case` makes from ``seed`` (the
    kernels of ``dtype`` on :func:`launch_inputs`); the library call is
    SDPA's forward or backward where it computes the same function
    (causal, full window, Sq = Sk; GQA through its ``enable_gqa``; float32
    with TF32 off as the script sets it), else None."""
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_fwd_cuda)
    b, sq, sk, h, kv, d, causal, window, q_offset = case
    q, k, v, dout = flash_inputs(torch, case, seed, dtype, device)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    qp, kp, vp, dp_, sc = launch_inputs(torch, q, k, v, dout)
    o, lse = flash_fwd_cuda(qp, kp, vp, **kw, scale=sc)
    lib_fwd = lib_bwd = None
    if causal and window is None and q_offset == 0 and sq == sk:
        sdpa, (qt, kt, vt, dt_) = sdpa_inputs(torch, q, k, v, dout)
        lt = [t.clone().requires_grad_() for t in (qt, kt, vt)]
        o_l = sdpa(*lt)
        lib_fwd = lambda: sdpa(qt, kt, vt)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            o_l, lt, dt_, retain_graph=True)
    return {"flash_fwd": (lambda: flash_fwd_cuda(qp, kp, vp, **kw,
                                                 scale=sc), lib_fwd),
            "flash_bwd": (lambda: flash_bwd_cuda(qp, kp, vp, o, lse, dp_,
                                                 **kw, scale=sc), lib_bwd)}


def flash_phase(torch, device: str = "cuda", path=FLASH_PATH,
                audio=FLASH_AUDIO, zamba=FLASH_ZAMBA,
                gemma=FLASH_GEMMA, vlm=FLASH_VLM,
                f32_timed=FLASH_F32_TIMED) -> list:
    """Flash attention kernel cases: awkward shapes, then
    transformer-table1's folded call, the audio train path's (``audio``),
    zamba2_7b's shared block at head dim 112 (``zamba``), gemma_2b's at
    head dim 256 (``gemma``), the vlm's self-attention (``vlm``: GQA, 32
    heads of 128 on 8), qwen25_3b's (16 on 2), mistral_large_123b's (96
    on 8) and dbrx_132b's (48 on 8), and the LLM path's (timed; the LLM
    path's last), then
    ``FLASH_SPLIT`` (bf16 dk/dv splits, 112), each bf16 backward twice and
    bitwise equal; the float32 kernels on every awkward case and, timed,
    at ``f32_timed`` (zamba2's, gemma_2b's, the vlm's and the LLM path's
    shapes). Fails where ptxas reports a spill in any flash
    kernel, or where the SASS of a bfloat16 attention kernel lacks HGMMA or
    TMA loads, or that of a float32 kernel lacks FFMA or holds a tensor
    core or tf32 instruction."""
    out, failures = [], []
    # (case, timed, seed): the seeds of the cases before stay as they were
    n_awk = len(FLASH_AWKWARD) - len(FLASH_AWKWARD_256)
    cases = ([(c, False, 500 + i)
              for i, c in enumerate(FLASH_AWKWARD[:n_awk])]
             + [(c, False, 600 + i) for i, c in enumerate(FLASH_AWKWARD_256)]
             + [(FLASH_TT1, True, 500 + n_awk),
                (audio, True, 500 + n_awk + 2),
                (zamba, True, 500 + n_awk + 3),
                (gemma, True, 500 + n_awk + 4),
                (vlm, True, 500 + n_awk + 5),
                (FLASH_QWEN, True, 500 + n_awk + 6),
                (FLASH_MISTRAL, True, 500 + n_awk + 7),
                (FLASH_DBRX, True, 500 + n_awk + 8)]
             + [(c, False, 650 + i) for i, c in enumerate(FLASH_SPLIT)])
    cases = [(c, timed, seed, "bfloat16") for c, timed, seed in cases]
    # the float32 kernels: every awkward case, then the timed rows; the
    # bf16 path's case stays last (the kernel record's)
    cases += ([(c, False, 700 + i, "float32")
               for i, c in enumerate(FLASH_AWKWARD)]
              + [(c, False, 750 + i, "float32")
                 for i, c in enumerate(FLASH_F32_112 + FLASH_F32_SPLIT)]
              + [(c, True, 800 + i, "float32")
                 for i, c in enumerate(f32_timed)]
              + [(path, True, 500 + n_awk + 1, "bfloat16")])
    for case, timed, seed, dtype in cases:
        rec = flash_case(torch, case, timed and device == "cuda",
                         seed=seed, device=device, dtype=dtype)
        out.append(rec)
        e = rec["errs"]
        line = (f"kernel flash {case} {dtype}: rel err out "
                f"{e['out_rel']:.3g} dq "
                f"{e['dq_rel']:.3g} dk {e['dk_rel']:.3g} dv {e['dv_rel']:.3g}"
                f"; tile rel rms out {e['out_tile']:.3g} dq "
                f"{e['dq_tile']:.3g} dk {e['dk_tile']:.3g} dv "
                f"{e['dv_tile']:.3g} ({rec['tolerance']}) "
                f"{'ok' if rec['ok'] else 'FAIL'}")
        for name in ("flash_fwd", "flash_bwd"):
            if name in rec:
                t = rec[name]
                lib = t["library_ms"]
                line += (f" | {name} ms={t['ms']:.5f} host_us="
                         f"{t['host_us']:.1f} plain_ms="
                         f"{t['plain_ms']:.5f} bound_ms={t['bound_ms']:.5f}"
                         f" ({t['bound_by']}) library_ms="
                         f"{'null' if lib is None else f'{lib:.5f}'}")
                if lib:
                    line += f" kernel/library={t['ms'] / lib:.3f}"
                line += f" bound/kernel={t['bound_ms'] / t['ms']:.3f}"
        if "library_fwd_bwd_ms" in rec:
            line += f" | sdpa fwd+bwd ms={rec['library_fwd_bwd_ms']:.5f}"
        if "bwd_bitwise_repeat" in rec:
            line += (f" | two backward runs bitwise equal: "
                     f"{rec['bwd_bitwise_repeat']}")
        if "nsplit" in rec:
            line += (f" | dk/dv split {rec['nsplit']}, backward scratch "
                     f"{rec['scratch_mib']:.3f} MiB")
        for who in ("kernel", "plain"):
            if f"{who}_f64" in e:
                line += f" | {who} vs float64: " + ", ".join(
                    f"{n} {r:.3g}" for n, r in e[f"{who}_f64"].items())
        log(line)
        if not rec["ok"]:
            failures.append(f"{case} {dtype} (launched {rec['launched']})")
        must_split = (FLASH_F32_SPLIT + [gemma] if dtype == "float32" else
                      FLASH_SPLIT + [gemma, FLASH_QWEN])
        if device == "cuda" and case in must_split and rec["nsplit"] < 2:
            failures.append(f"{case} {dtype}: its dk/dv blocks do not split")
    # the tile check would fail a kernel that dropped one tile on the path,
    # at either dtype's bounds
    fault = flash_fault_readings(torch, path, seed=499, device=device)
    for dtype in ("bfloat16", "float32"):
        _, _, tile_out, tile_grad = flash_tols(dtype)
        tols = {"out": tile_out, "dq": tile_grad, "dk": tile_grad,
                "dv": tile_grad}
        log(f"flash {path}: one dropped tile reads tile rel rms " +
            ", ".join(f"{n} {r:.3g}" for n, r in fault.items()) +
            f" (must exceed twice the {dtype} tile bounds, {tile_out:g} "
            f"out, {tile_grad:g} dq, dk, dv)")
        failures += [f"a dropped tile reads {n} {r:.3g}, within twice its "
                     f"{dtype} bound" for n, r in fault.items()
                     if r <= 2 * tols[n]]
    for name, regs in sorted(FLASH_PTXAS.items()):
        log(f"flash ptxas {name}: {regs['registers']} registers, spill "
            f"stores {regs['spill_stores']} B, spill loads "
            f"{regs['spill_loads']} B")
        if regs["spill_stores"] or regs["spill_loads"]:
            failures.append(f"{name} spills ({regs})")
    # every kernel at every head dim in the report of each library this
    # process built
    from repro_torch.kernels import build
    missing = [f"{k}<{d}>" for lib, names in FLASH_KERNELS.items()
               if lib in build.BUILD_LOG for k in names
               for d in flash_dims(lib, k) if f"{k}<{d}>" not in FLASH_PTXAS]
    if missing:
        failures.append(f"no ptxas report of {missing}")
    if device == "cuda":
        sass = {}
        for lib in FLASH_KERNELS:
            sass.update(sass_counts(build.library_path(lib)))
        if {n.split("<")[0] for n in sass} != {
                k for names in FLASH_KERNELS.values() for k in names}:
            failures.append(f"cuobjdump -sass shows the flash kernels "
                            f"{sorted(sass)}")
        for name, ops in sorted(sass.items()):
            log(f"flash sass {name}: " + ", ".join(
                f"{op} {n}" for op, n in ops.items()))
            if "ffma" in name:
                # the float32 kernels: FFMA on the CUDA cores, no tensor
                # core instruction and nothing in tf32
                if not ops["FFMA"] or ops["HGMMA"] or ops["HMMA"] or \
                        ops["TF32"]:
                    failures.append(f"{name} SASS {ops}")
            # the bf16 attention kernels run on wgmma and TMA, never on
            # WMMA (the delta and sum passes are plain loads and adds)
            elif "delta" not in name and "sum" not in name and (
                    not ops["HGMMA"] or not ops["UTMALDG"] or ops["HMMA"]):
                failures.append(f"{name} SASS {ops}")
        FLASH_SASS.update(sass)
    if failures:
        raise AssertionError(f"flash kernels disagree: {failures}")
    return out


def kernel_split_us(torch, fn, reps: int = 3) -> dict:
    """Device µs per call of each kernel ``fn`` launches, by name (the
    profiler's events, summed over ``reps`` calls)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m[1] if m else e.name[:40]
            out[name] += (e.time_range.end - e.time_range.start) / reps
    return dict(out)


def flash_ab(torch, parents, reps: int = 10) -> list:
    """The flash kernels of this tree against other versions of their
    source (``parents``, e.g. the parent commit's ``git show
    HEAD:src/repro_torch/csrc/flash_attention.cu``): a version that defines
    ``flash_bwd_f32`` is the float32 library's, timed at
    :data:`FLASH_F32_TIMED`, else the bf16 one's, at
    :data:`FLASH_BF16_TIMED`; each built with the same ``nvcc`` flags under
    ``build/flash_ab``. At each case, forward and backward, each version and
    the tree are timed in turns, version, tree, tree, version,
    :data:`FLASH_AB_ROUNDS` times, as :func:`time_ms` loops of ``reps`` calls, each launched as the port
    launched it (a head dim the library is not built for, zero-padded to
    128 with the head dim's own scale; a backward with a dk/dv split, with
    its plan and scratch), beside SDPA's forward or backward where it
    computes the same function, with the device µs of each backward
    kernel. Returns a record a version, case and direction: the readings of
    each, their means and medians, SDPA's, and max|tree - version| /
    max|version| of the outputs."""
    import ctypes
    import re

    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(parents):
        so = out_dir / f"lib{i}.so"
        jobs.append((src, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    records = []
    for src, so, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{report}")
        text = re.sub(r"//[^\n]*", "", Path(src).read_text())
        f32 = "flash_bwd_f32" in text
        lib = "flash_attention_f32" if f32 else "flash_attention"
        new = build.load(lib)
        m = re.search(r'extern\s+"C"\s+int\s+flash_bwd(?:_f32)?\s*'
                      r'\(([^)]*)\)', text)
        split_args = m is not None and "nsplit" in m[1]
        dims = [int(d) for d in re.findall(r"case (\d+):", text)]
        regs = {k: v["registers"] for k, v in ptxas_table(report).items()
                if "<80>" in k or "<256>" in k}
        log(f"flash ab {src}: registers {regs}")
        records += _flash_ab_one(
            torch, ctypes.CDLL(str(so)), new, f32, split_args, dims,
            str(src), reps, FLASH_F32_TIMED if f32 else FLASH_BF16_TIMED)
    return records


def _flash_ab_one(torch, old, new, f32: bool, split_args: bool, dims,
                  label: str, reps: int, cases) -> list:
    import ctypes

    import torch.nn.functional as Fn

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import bwd_scratch, dkdv_plan
    P, I, F = build.P, build.I, build.F
    suffix = "_f32" if f32 else ""
    dtype = torch.float32 if f32 else torch.bfloat16
    for lib in (old, new):
        fwd_fn = getattr(lib, "flash_fwd" + suffix)
        bwd_fn = getattr(lib, "flash_bwd" + suffix)
        fwd_fn.argtypes = [P] * 5 + [I] * 9 + [F, P]
        fwd_fn.restype = bwd_fn.restype = ctypes.c_int
    getattr(new, "flash_bwd" + suffix).argtypes = [P] * 11 + [I] * 10 + [
        F, P]
    getattr(old, "flash_bwd" + suffix).argtypes = (
        [P] * 11 + [I] * 10 if split_args else [P] * 10 + [I] * 9) + [F, P]
    stream = build.stream_ptr(0)
    sms = build.sm_count(0)
    records = []
    for i, case in enumerate(cases):
        b, sq, sk, h, kv, d, causal, window, q_offset = case
        q, k, v, dout = flash_inputs(torch, case, 900 + i, str(dtype)[6:],
                                     "cuda")
        calls = {}
        for who, lib in (("parent", old), ("tree", new)):
            built = dims if who == "parent" else flash_dims(
                "flash_attention_f32" if f32 else "flash_attention")
            splits = split_args or who == "tree"
            # a head dim the version is not built for: zero-padded to 128
            dp = d if d in built else -(-d // 128) * 128
            pad = (0, dp - d)
            qp, kp, vp, dop = (Fn.pad(t, pad).contiguous()
                               for t in (q, k, v, dout))
            scale = 1.0 / math.sqrt(d)
            o, dq = torch.empty_like(qp), torch.empty_like(qp)
            dk, dv = torch.empty_like(kp), torch.empty_like(kp)
            lse = torch.empty((b, h, sq), device="cuda")
            delta = torch.empty_like(lse)
            dims_args = (b, sq, sk, h, kv, dp, int(causal), window or 0,
                         q_offset)
            split = ()
            if splits:
                nsplit = dkdv_plan(b, sq, sk, h, kv, dp, causal, window,
                                   q_offset, sms, dtype)["nsplit"]
                n = bwd_scratch(b, sq, sk, h, kv, dp, nsplit, dtype)
                part = torch.empty(n, dtype=torch.uint8, device="cuda") \
                    if n else None
                split = (0 if part is None else part.data_ptr(), nsplit)
            fwd_fn = getattr(lib, "flash_fwd" + suffix)
            bwd_fn = getattr(lib, "flash_bwd" + suffix)

            def fwd(fn=fwd_fn, qp=qp, kp=kp, vp=vp, o=o, lse=lse,
                    a=dims_args, scale=scale):
                build.check(fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), *a, scale,
                               stream), "fwd")

            def bwd(fn=bwd_fn, qp=qp, kp=kp, vp=vp, o=o, dop=dop, lse=lse,
                    delta=delta, dq=dq, dk=dk, dv=dv, split=split,
                    a=dims_args, scale=scale):
                build.check(fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                               o.data_ptr(), dop.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), *split, *a,
                               scale, stream), "bwd")
            fwd()
            bwd()
            torch.cuda.synchronize()
            calls[who] = {"fwd": fwd, "bwd": bwd, "outs": [
                t[..., :d] for t in (o, dq, dk, dv)]}
        diff = max(float((a.float() - b_.float()).abs().max()
                         / b_.float().abs().max()) for a, b_
                   in zip(calls["tree"]["outs"], calls["parent"]["outs"]))
        fns = flash_fns(torch, case, 900 + i, dtype=str(dtype)[6:])
        times = {}
        for name in ("fwd", "bwd"):
            times[name] = {"parent": [], "tree": []}
            for _ in range(FLASH_AB_ROUNDS):
                for who in ("parent", "tree", "tree", "parent"):
                    times[name][who].append(time_ms(torch, calls[who][name],
                                                    reps))
            lib_fn = fns["flash_" + name][1]
            times[name]["sdpa"] = (time_ms(torch, lib_fn, reps)
                                   if lib_fn is not None else None)
        del fns
        # after the timed loops: the profiler slows the launches after it
        split_us = {who: kernel_split_us(torch, calls[who]["bwd"])
                    for who in ("parent", "tree")}
        for name in ("fwd", "bwd"):
            t = times[name]
            rec = {"version": label, "case": list(case), "kernel": name,
                   "dtype": str(dtype)[6:], "parent_ms": t["parent"],
                   "tree_ms": t["tree"],
                   "parent_mean_ms": sum(t["parent"]) / len(t["parent"]),
                   "tree_mean_ms": sum(t["tree"]) / len(t["tree"]),
                   "parent_median_ms": statistics.median(t["parent"]),
                   "tree_median_ms": statistics.median(t["tree"]),
                   "sdpa_ms": t["sdpa"],
                   "tree_vs_parent_rel_diff": diff}
            rec["speedup"] = rec["parent_mean_ms"] / rec["tree_mean_ms"]
            if t["sdpa"]:
                rec["tree_over_sdpa"] = rec["tree_mean_ms"] / t["sdpa"]
            if name == "bwd":
                rec["bwd_kernels_us"] = split_us
            records.append(rec)
            log(f"flash ab {case} {rec['dtype']} {name}: version "
                f"{', '.join(f'{x:.5f}' for x in t['parent'])} ms, tree "
                f"{', '.join(f'{x:.5f}' for x in t['tree'])} ms, "
                f"parent/tree {rec['speedup']:.3f} (medians "
                f"{rec['parent_median_ms'] / rec['tree_median_ms']:.3f})"
                + (f", sdpa {t['sdpa']:.5f} ms, tree/sdpa "
                   f"{rec['tree_over_sdpa']:.3f}" if t["sdpa"] else "")
                + f"; outputs differ by {diff:.3g} of max|version|" + (
                    "; backward kernels µs " + str({w: {k: round(v, 1) for
                                                      k, v in u.items()}
                                                  for w, u in rec[
                                                      "bwd_kernels_us"]
                                                  .items()})
                    if name == "bwd" else ""))
        del calls, q, k, v, dout
        torch.cuda.empty_cache()
    return records


# The rows of PERF.md's kernel table for pairdist (row 1), CWTM (row 2) and
# the median (row 3), each at every input dtype, for ``--sort-ab``: the
# CNN's shape, the table1 grid's (18 lanes a rule, 36 under NNM), the
# quadratic's, and CWTM's LLM column slice and whole LLM bank.
SORT_AB_SHAPES = {
    "pairdist": [(1, 13, 11958), (36, 13, 11958), (1, 13, 1048576),
                 (8, 13, 1048576)],
    "cwtm": [(1, 13, 11958), (18, 13, 11958), (36, 13, 11958),
             (1, 13, 1048576), (1, LLM_WORKERS, 1 << 24),
             (1, LLM_WORKERS, LLM_D)],
    "median": [(1, 13, 11958), (18, 13, 11958), (36, 13, 11958),
               (1, 13, 1048576)],
}
SORT_AB_DTYPES = ("float32",) + SORT_LOWP_DTYPES
# Rounds of (version, tree, tree, version) readings a case takes: more
# where a reading is a few µs of host cost, so that the spread of the
# float32 rows (the same kernel and plan on both sides) shows what the
# loop can resolve there.
SORT_AB_ROUNDS = {"small": 12, "large": 4}
# The exit code of ``--sort-ab`` when every check holds (a partial run, no
# ok line; a mismatch raises, exit 1).
SORT_AB_EXIT = 5
# The wrapper modules ``--sort-ab`` loads from a version's checkout.
SORT_AB_MODULES = {"pairdist": "repro_torch.kernels.pairdist.pairdist",
                   "cwtm": "repro_torch.kernels.cwtm.cwtm",
                   "median": "repro_torch.kernels.median.median",
                   "build": "repro_torch.kernels.build"}


def load_version(src: Path) -> dict:
    """The wrapper modules (:data:`SORT_AB_MODULES`) of the ``repro_torch``
    package under ``src``, another checkout's, imported beside this tree's:
    ``src`` goes first on the path while they import, and their modules
    leave ``sys.modules`` after, so that this tree's stay in place. Each
    version builds its sources into its own checkout's ``build/kernels``."""
    import importlib

    def ours(name):
        return name == "repro_torch" or name.startswith("repro_torch.")
    tree = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, str(src))
    try:
        mods = {k: importlib.import_module(m)
                for k, m in SORT_AB_MODULES.items()}
    finally:
        sys.path.remove(str(src))
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(tree)
    for m in mods.values():
        if not Path(m.__file__).resolve().is_relative_to(src.resolve()):
            raise RuntimeError(f"--sort-ab: {m.__name__} loaded from "
                               f"{m.__file__}, not from {src}")
    return mods


def host_context(torch, label: str, reps: int = 2000) -> dict:
    """Host µs a call, at this point of the process, of one PyTorch op and
    of the tree's pairdist and CWTM wrappers and their raw C calls at the
    CNN's [1, 13, 11958] float16 (:func:`host_us`, median of 3): how far
    the state a run has reached moves the host cost of the same calls."""
    import importlib
    mods = {k: importlib.import_module(m) for k, m in SORT_AB_MODULES.items()}
    x = (torch.randn((1, 13, 11958), device="cuda") * 3).to(torch.float16)
    stream = mods["build"].stream_ptr(0)
    fns = {"x.neg()": lambda: x.neg()}
    for kernel in ("pairdist", "cwtm"):
        wrapper, raw, _, _ = _sort_ab_calls(mods, kernel, x, F, stream)
        fns[f"{kernel} wrapper"], fns[f"{kernel} raw"] = wrapper, raw
    out = {k: statistics.median(host_us(torch, fn, reps) for _ in range(3))
           for k, fn in fns.items()}
    log(f"sort ab host µs {label}: " + ", ".join(f"{k} {v:.2f}"
                                                  for k, v in out.items()))
    return out


def sort_ab(torch, versions, reps=None) -> list:
    """The sort kernels of this tree against other versions (``versions``:
    ``<checkout>/src/repro_torch/csrc/sorted_weight.cu`` or ``pairdist.cu``
    of another checkout, e.g. the parent commit's ``git archive`` under
    ``build/parent``). Each version runs with its own checkout's wrappers
    (:func:`load_version`): they build its sources into that checkout's
    ``build/kernels`` and make its launch plans. At every shape of
    :data:`SORT_AB_SHAPES` and every dtype of :data:`SORT_AB_DTYPES`, the
    version and the tree are timed in turns, version, tree, tree, version,
    :data:`SORT_AB_ROUNDS` times: loops of raw C calls with the plan each
    wrapper made, then loops of whole wrapper calls, with the host µs of
    each. The sorted-weight kernel (CWTM and the median) must give the
    version's bits; pairdist the version's bits at float32, at the narrow
    classes within 1e-5 of max |x|^2 of it, and two calls of the tree's
    the same bits. Returns a record a case; raises on any mismatch."""
    import importlib
    tree = {k: importlib.import_module(m) for k, m in SORT_AB_MODULES.items()}
    build = tree["build"]
    runs, loaded = [], {}
    for cu in versions:
        name = cu.stem
        if name not in ("sorted_weight", "pairdist") or \
                cu.parent.name != "csrc" or \
                cu.parents[1].name != "repro_torch":
            raise ValueError(f"--sort-ab takes <checkout>/src/repro_torch/"
                             f"csrc/{{sorted_weight,pairdist}}.cu, got {cu}")
        src = cu.parents[2]
        if src not in loaded:
            loaded[src] = load_version(src)
        runs.append((cu, name, loaded[src]))
    # every build at once: the versions' and the tree's
    jobs = [(mods["build"], name, mods["build"]._start(name))
            for _, name, mods in runs]
    jobs += [(build, n, build._start(n)) for n in ("sorted_weight",
                                                    "pairdist")]
    for b, name, job in jobs:
        if job is not None:
            b._finish(name, job)
    for name, (secs, report) in build.BUILD_LOG.items():
        for kernel, regs in ptxas_table(report).items():
            log(f"sort ab ptxas {kernel}: {regs['registers']} registers, "
                f"spill stores {regs['spill_stores']} B, spill loads "
                f"{regs['spill_loads']} B")
    stream = build.stream_ptr(0)
    records, failures = [], []
    context = {"fresh": host_context(torch, "fresh")}
    big = torch.empty(48 << 30, dtype=torch.uint8, device="cuda")
    del big  # cached by the allocator, as after the LLM-shape cases
    context["after 48 GiB, cached"] = host_context(torch, "after 48 GiB, "
                                                   "cached")
    torch.cuda.empty_cache()
    context["after empty_cache"] = host_context(torch, "after empty_cache")
    for cu, name, mods in runs:
        log(f"sort ab {cu}: {name}, wrappers from {cu.parents[2]}")
        kernels = ("pairdist",) if name == "pairdist" else ("cwtm", "median")
        for kernel in kernels:
            for i, shape in enumerate(SORT_AB_SHAPES[kernel]):
                for dt in SORT_AB_DTYPES:
                    rec = _sort_ab_one(torch, mods, tree, kernel, shape, dt,
                                       1200 + i, stream, reps)
                    rec["version"] = str(cu)
                    records.append(rec)
                    if not rec["ok"]:
                        failures.append(f"{kernel} {shape} {dt}")
                    torch.cuda.empty_cache()
    context["after the cases"] = host_context(torch, "after the cases")
    records.append({"host_context": context})
    if failures:
        raise AssertionError(f"--sort-ab: the tree's kernels disagree with "
                             f"the versions' at {failures}")
    return records


def _sort_ab_calls(mods: dict, kernel: str, x, f: int, stream) -> tuple:
    """``(wrapper, raw, out, keep)`` of one version at one input: its
    wrapper, and a raw C call of its entry with the launch plan that its
    wrapper made for ``x`` (the one entry of the wrapper's plan cache after
    one call), into the buffer ``out``."""
    import torch
    owner = mods["pairdist" if kernel == "pairdist" else "cwtm"]
    wrapper = {"pairdist": lambda: mods["pairdist"].pairdist_cuda(x),
               "cwtm": lambda: mods["cwtm"].cwtm_cuda(x, f),
               "median": lambda: mods["median"].median_cuda(x)}[kernel]
    owner._LAUNCH.clear()
    out = torch.empty_like(wrapper())
    (launch,) = owner._LAUNCH.values()
    lib = "pairdist" if kernel == "pairdist" else "sorted_weight"
    entry = mods["build"].entry(lib, lib)

    def raw():
        mods["build"].check(entry(x.data_ptr(), out.data_ptr(), launch[0],
                                  stream), kernel)
    return wrapper, raw, out, launch


def _sort_ab_one(torch, mods, tree, kernel: str, shape, dt: str, seed: int,
                 stream, reps) -> dict:
    from repro_torch.utils.dtypes import to_dtype
    b, n, d = shape
    f = 1 if n == LLM_WORKERS else F
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = to_dtype(torch.randn(shape, generator=gen, device="cuda") * 3,
                 dtype)
    calls, outs, keep = {}, {}, []
    for who, m in (("version", mods), ("tree", tree)):
        wrapper, raw, out, launch = _sort_ab_calls(m, kernel, x, f, stream)
        raw()
        torch.cuda.synchronize()
        outs[who], outs[who + "_buffer"] = out.clone(), out
        calls[who], calls[who + " wrapper"] = raw, wrapper
        keep.append(launch)
    rec = {"kernel": kernel, "shape": list(shape), "dtype": dt, "f": f,
           "plan": sort_plan(kernel, x)}
    bits = lambda t: t.view(torch.uint8)  # noqa: E731
    if kernel == "pairdist":
        calls["tree"]()  # again, into the same buffer
        torch.cuda.synchronize()
        rec["tree_repeats_bitwise"] = torch.equal(outs["tree"],
                                                  outs["tree_buffer"])
        rec["max_abs_diff"] = float((outs["tree"].double()
                                     - outs["version"].double()).abs().max())
        rec["bitwise"] = torch.equal(outs["tree"], outs["version"])
        scale = float(x.float().square().sum(-1).max())
        rec["ok"] = rec["tree_repeats_bitwise"] and (
            rec["bitwise"] if dt == "float32"
            else rec["max_abs_diff"] <= 1e-5 * scale)
    else:
        rec["bitwise"] = torch.equal(bits(outs["tree"]),
                                     bits(outs["version"]))
        rec["ok"] = rec["bitwise"]
    reps = reps or case_reps(shape)
    rounds = SORT_AB_ROUNDS["small" if reps >= 200 else "large"]
    t = {k: [] for k in calls}
    host = {k: [] for k in calls}
    for kind in ("", " wrapper"):
        for _ in range(rounds):
            for who in ("version", "tree", "tree", "version"):
                t[who + kind].append(time_ms(torch, calls[who + kind],
                                             reps))
                host[who + kind].append(host_us(torch, calls[who + kind],
                                                reps))
    med = statistics.median
    rec.update(version_ms=t["version"], tree_ms=t["tree"],
               version_median_ms=med(t["version"]),
               tree_median_ms=med(t["tree"]),
               wrapper_ms={w: t[w + " wrapper"] for w in ("version", "tree")},
               wrapper_median_ms={w: med(t[w + " wrapper"])
                                  for w in ("version", "tree")},
               host_median_us={k: med(v) for k, v in host.items()},
               reps=reps, rounds=rounds)
    # the spread of a side's readings: (upper quartile - lower) / median
    rec["spread"] = {k: (statistics.quantiles(v, n=4)[2]
                         - statistics.quantiles(v, n=4)[0]) / med(v)
                     for k, v in t.items()}
    # device µs a call of each (the profiler, after this case's timed
    # loops: where the call's host cost hides the kernel, this is its time)
    rec["device_us"] = {who: sum(kernel_split_us(torch, calls[who],
                                                 reps=20).values())
                        for who in ("version", "tree")}
    rec["version_over_tree"] = rec["version_median_ms"] / rec[
        "tree_median_ms"]
    rec["wrapper_version_over_tree"] = (rec["wrapper_median_ms"]["version"]
                                        / rec["wrapper_median_ms"]["tree"])
    from repro_torch.launch import roofline as RL
    work = (RL.pairdist_work if kernel == "pairdist"
            else RL.sorted_weight_work)(b, n, d, x.element_size())
    rec["bound_ms"], rec["bound_by"] = _bound(work, "f32")
    hu = rec["host_median_us"]
    log(f"sort ab {kernel} {tuple(shape)} {dt}: version "
        f"{', '.join(f'{v:.5f}' for v in t['version'])} ms, tree "
        f"{', '.join(f'{v:.5f}' for v in t['tree'])} ms, medians "
        f"{rec['version_median_ms']:.5f} -> {rec['tree_median_ms']:.5f} "
        f"(version/tree {rec['version_over_tree']:.3f}, spreads "
        f"{rec['spread']['version']:.3f} / {rec['spread']['tree']:.3f}; "
        f"device µs {rec['device_us']['version']:.3f} -> "
        f"{rec['device_us']['tree']:.3f}; host µs "
        f"{hu['version']:.2f} -> {hu['tree']:.2f}; bound "
        f"{rec['bound_ms']:.5f} ms, tree at "
        f"{rec['bound_ms'] / rec['tree_median_ms']:.3f} of it); wrappers "
        f"{rec['wrapper_median_ms']['version']:.5f} -> "
        f"{rec['wrapper_median_ms']['tree']:.5f} ms (version/tree "
        f"{rec['wrapper_version_over_tree']:.3f}, spreads "
        f"{rec['spread']['version wrapper']:.3f} / "
        f"{rec['spread']['tree wrapper']:.3f}; host µs "
        f"{hu['version wrapper']:.2f} -> {hu['tree wrapper']:.2f}); bitwise "
        f"{rec['bitwise']}"
        + (f", max|tree - version| {rec['max_abs_diff']:.3g}, tree repeats "
           f"bitwise {rec['tree_repeats_bitwise']}" if kernel == "pairdist"
           else "")
        + f" | plan {rec['plan']} {'ok' if rec['ok'] else 'FAIL'}")
    del keep, calls, outs, x
    return rec


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


#: The ``__global__`` names of the port's server kernels (``csrc/``): the
#: pairdist and sorted-weight kernels (float32, then the narrow classes')
#: and the Block-RandK kernels.
PORT_SERVER_KERNELS = ("pairdist_kernel", "pairdist_narrow_kernel",
                       "sorted_weight_kernel", "sorted_weight_pairs_kernel",
                       "compress_kernel", "decompress_kernel",
                       "momentum_kernel")


def op_kind(name: str) -> str:
    """Coarse kind of a device operation, by its kernel name."""
    low = name.lower()
    if "flash" in low:
        return "flash attention (port)"
    if any(k in low for k in PORT_SERVER_KERNELS):
        return "server kernels (port)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "wgrad", "dgrad", "conv")):
        return "matmul/conv (library)"
    if "sort" in low:
        return "sort"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reductions"
    if "copy" in low:
        return "casts and copies"
    return "other elementwise"


def profile_window(torch, step, n: int, label: str) -> dict:
    """Device busy share and device time by kernel over ``n`` calls of
    ``step(i)`` (steady rounds or steps), from ``torch.profiler`` (CUPTI).
    The wall time includes the profiler's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
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
    by_kind = {}
    for name, (tot, _) in by_name.items():
        kind = op_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + tot / n / 1e3
    out = {"rounds": n, "wall_ms_per_round": wall_us / n / 1e3,
           "device_busy_ms_per_round": busy / n / 1e3,
           "device_events": len(spans),
           "idle_share": (1.0 - busy / wall_us) if spans else None,
           "ms_per_round_by_kind": by_kind,
           "top": [{"name": k[:80], "ms_per_round": v[0] / n / 1e3,
                    "calls_per_round": v[1] / n} for k, v in top]}
    if not spans:
        log(f"{label} profile: the profiler saw no device events (device "
            f"time not measured)")
        return out
    log(f"{label} profile over {n} rounds: wall "
        f"{out['wall_ms_per_round']:.3f} ms/round (profiler on), device busy "
        f"{out['device_busy_ms_per_round']:.3f} ms/round, idle share "
        f"{out['idle_share']:.3f}, {len(spans) / n:.0f} device operations "
        f"per round")
    log(f"{label} device time by kind (ms/round): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_kind.items(),
                                          key=lambda kv: -kv[1])))
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

    prof = None
    if device == "cuda":
        box = [state]

        def one_round(i):
            box[0], _ = sim.round(box[0], batch_fn(rounds + i))
        prof = profile_window(torch, one_round, 5, "cnn")

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
    """The fig1-alie cell on the quadratic testbed, RoSDHB and then dasha
    (Byz-DASHA-PAGE, the paper's baseline, on the same cell), each on the
    kernel path and on the plain path."""
    from repro_torch import kernels as K
    from repro_torch.core import Simulator, quadratic_testbed

    out = {}
    for name in ("rosdhb", "dasha"):
        finals, rec = {}, {}
        for use_kernels in (True, False):
            cfg = dataclasses.replace(fig1_alie(use_kernels), name=name)
            loss_fn, params0, batch_fn, tg = quadratic_testbed(
                13, d=d, seed=0, device=device)
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
            log(f"quadratic {name} d={d} {tag}: first round "
                f"{round_ms[0]:.3f} ms, median round {wall:.3f} ms, peak "
                f"device memory {peak:.1f} MiB, distance to the honest "
                f"optimum {dist0:.4f} -> {dist:.4f}, launches {launches}")
            if not dist < dist0:
                raise AssertionError(f"quadratic {name} {tag}: distance did "
                                     f"not fall")
            expected = rounds if use_kernels and device == "cuda" else 0
            if launches["pairdist"] != expected or \
                    launches["cwtm"] != expected:
                raise AssertionError(f"quadratic {name}: launches "
                                     f"{launches} != {rounds} rounds")
            finals[tag] = state.params_flat
            rec[tag] = {"ms_per_round": wall, "dist0": dist0, "dist": dist,
                        "launches": launches, "peak_mib": peak}
        diff = float((finals["kernel"] - finals["plain"]).abs().max())
        scale = float(finals["plain"].abs().max())
        log(f"quadratic {name}: kernel vs plain path after {rounds} rounds, "
            f"max |d| {diff:.3g} of max |w| {scale:.4f} (bound 1e-5 "
            f"relative: the paths differ only in float32 summation order "
            f"inside the aggregation, about 1e-7 relative a round)")
        if diff > 1e-5 * scale:
            raise AssertionError(f"quadratic {name}: kernel and plain paths "
                                 f"disagree")
        rec["max_abs_diff"] = diff
        out[name] = rec
    return out


GRID_SEEDS = (0, 1)
GRID_ROUNDS = 100        # timed rounds of the table1 grid on the CNN
GRID_CHECK_ROUNDS = 3    # rounds held against the CPU and the plain path
GRID_SINGLE_ROUNDS = 10  # rounds of the three lanes held against lone runs
GRID_TAU_LOSS = 1.0      # honest-loss threshold of bytes_to_threshold
# (algorithm, attack, aggregator, seed) of the lanes held against the
# port's own single-scenario Simulator.rollout
GRID_SINGLES = (("rosdhb", "alie", "cwtm", 0), ("dasha", "foe", "median", 1),
                ("dgd", "signflip", "mean", 0))


def grid_replay(torch, device, rounds: int, d: int, k: int, n: int,
                seed: int):
    """A seed's draws of ``rounds`` table1 rounds (the global mask, then one
    mask per worker for dasha), from numpy, so that the card and the CPU
    read the same."""
    import numpy as np
    from repro_torch.testing import ReplayDraws
    rng = np.random.default_rng(1000 + seed)
    return ReplayDraws(device, permutations=[
        rng.permutation(d)[:k] for _ in range(rounds * (n + 1))])


def grid_cells(spec: str, use_kernels: bool):
    """The registry spec's cells on the kernel or the plain path."""
    from repro_torch.adversary import registry as R
    from repro_torch.core import sweep as SW
    return SW.with_kernels(R.expand_scenario(spec), use_kernels)


def grid_lane_shapes(bank) -> dict:
    """``{kernel: [lanes, n, D]}`` that one round of ``bank`` hands to
    pairdist (the lanes whose rule composes NNM), CWTM and the median, per
    seed times the seeds."""
    from repro_torch.core import algorithms as Alg
    entries = bank.cfg.aggregator.bank
    counts = {"pairdist": 0, "cwtm": 0, "median": 0}
    for c, e in enumerate(bank.agg_idx):
        algo = (Alg.ALGO_BANK[bank.algo_idx[c]] if bank.algo_idx is not None
                else bank.cfg.name)
        if algo == "dgd":
            continue  # dgd takes the plain mean
        name, pre = entries[e]
        counts["pairdist"] += int(pre and name != "mean")
        if name in counts:
            counts[name] += 1
    return {k: v * len(GRID_SEEDS) for k, v in counts.items()}


def grid_run(torch, device, spec: str, use_kernels: bool, rounds: int,
             draws=None, per_worker: int = 800, testbed: str = "mnist",
             d: int = 64, timed: bool = False, snapshot: int = 0):
    """``rounds`` rounds of the spec's one bank, 2 seeds, round by round
    (each ended by a synchronize when ``timed``). Returns the simulator, the
    bank, the lanes' final state, per-round honest losses ``[B, rounds]``,
    round times (ms), the launches and, at round ``snapshot``, the
    parameters."""
    from repro_torch import kernels as K
    from repro_torch.core import sweep as SW
    plan = SW.plan_grid(grid_cells(spec, use_kernels))
    if len(plan.banks) != 1 or plan.singles:
        raise AssertionError(f"grid {spec}: expected one bank, got "
                             f"{plan.describe()}")
    bank = plan.banks[0]
    n = bank.cfg.n_workers
    if testbed == "mnist":
        from repro_torch.core import mnist_testbed
        loss_fn, params0, batch_fn, eval_fn, eval_batch = mnist_testbed(
            n, per_worker=per_worker, batch=60, seed=0, device=device)
    else:
        loss_fn, params0, batch_fn, _ = SW.quadratic_testbed(n, d=d,
                                                             device=device)
        eval_fn = eval_batch = None
    sim = SW.Simulator(loss_fn, params0, bank.cfg, eval_fn=eval_fn,
                       device=device)
    state, lanes = SW.grid_lanes(sim, bank.scenario_params(), GRID_SEEDS,
                                 draws)
    K.reset_launches()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, round_ms, snap = [], [], None
    for t in range(rounds):
        if timed:
            sync(torch, device)
        t0 = time.perf_counter()
        state, m = sim.round(state, batch_fn(t), lanes)
        if timed:
            sync(torch, device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        if t + 1 == snapshot:
            snap = state.params_flat.clone()
    sync(torch, device)
    out = {"sim": sim, "bank": bank, "state": state, "lanes": lanes,
           "loss": torch.stack(losses, dim=-1).cpu(), "round_ms": round_ms,
           "launches": K.launches(), "snapshot": snap,
           "batch_fn": batch_fn, "eval_batch": eval_batch,
           "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                        if device == "cuda" else float("nan"))}
    return out


def grid_compare(label: str, bank, a: dict, b: dict, what: str) -> dict:
    """Two runs of one bank lane by lane: the honest loss of every lane and
    round within rel 1e-4 (the CNN phase's bar: float32 sums in other
    orders), and each lane's largest parameter difference over its largest
    parameter, logged per lane. NNM ranks neighbours by distance, so a
    near tie that the two paths' float32 distances order differently moves
    a lane's parameters by more than the sums' rounding: the loss, not the
    parameters, is held to the bar."""
    rel = ((a["loss"] - b["loss"]).abs() / b["loss"].abs()).amax(dim=-1)
    wa, wb = a["state"].params_flat, b["state"].params_flat
    dw = ((wa - wb).abs().amax(dim=-1) / wb.abs().amax(dim=-1)).cpu()
    n_s = len(GRID_SEEDS)
    for i in range(len(rel)):
        if dw[i] > 1e-5 or rel[i] > 1e-5:
            log(f"grid {label} lane {bank.scenarios[i // n_s].label} seed "
                f"{GRID_SEEDS[i % n_s]}: loss rel {float(rel[i]):.3g}, "
                f"max |d| / max |w| {float(dw[i]):.3g}")
    worst = float(rel.max())
    log(f"grid {label}: {what}: honest loss max rel diff {worst:.3g} (bound "
        f"1e-4), max |d| / max |w| {float(dw.max()):.3g} (median over lanes "
        f"{float(dw.median()):.3g}), lanes above 1e-5: "
        f"{int((dw > 1e-5).sum())} of {len(dw)}")
    if worst > 1e-4:
        raise AssertionError(f"grid {label}: {what}: the runs disagree")
    return {"rel_loss": worst, "rel_param_max": float(dw.max()),
            "rel_param_median": float(dw.median()),
            "lanes_param_above_1e-5": int((dw > 1e-5).sum())}


def grid_check_launches(label: str, launches: dict, rounds: int,
                        kernels, on_card: bool) -> None:
    """One launch a round of each of ``kernels`` (none off the card), and
    none of the others."""
    want = {k: (rounds if on_card and k in kernels else 0)
            for k in ("pairdist", "cwtm", "median")}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"grid {label}: launches {got}, expected {want}")


def grid_phase(torch, device: str = "cuda", rounds: int = GRID_ROUNDS,
               check_rounds: int = GRID_CHECK_ROUNDS,
               single_rounds: int = GRID_SINGLE_ROUNDS,
               per_worker: int = 800, mimic_rounds: int = 30,
               mixed_rounds: int = 20) -> dict:
    """The Table-1 grid engine (``repro_torch.core.sweep``) on the card:
    (a) the ``table1`` product on the paper's CNN, 21 cells x 2 seeds as
    42 lanes of one bank; (b) ``mimic-iid`` on the CNN; (c)
    ``mixed-attacks`` on the quadratic testbed (d = 64). ``cpu`` only to
    rehearse the script's logic."""
    import numpy as np
    from repro_torch.core import sweep as SW
    from repro_torch.core.simulator import Simulator
    on_card = device == "cuda"
    out = {}

    # (a) table1 on the CNN: the plan and the kernels' batched shapes
    plan = SW.plan_grid(grid_cells("table1", True))
    log("grid table1 plan: " + plan.describe().replace("\n", "\n  "))
    bank = plan.banks[0]
    lanes_b = bank.n_cells * len(GRID_SEEDS)
    shapes = {k: [v, 13, 11958] for k, v in grid_lane_shapes(bank).items()}
    log(f"grid table1: {bank.n_cells} cells x {len(GRID_SEEDS)} seeds = "
        f"{lanes_b} lanes; per round pairdist {shapes['pairdist']}, CWTM "
        f"{shapes['cwtm']}, median {shapes['median']}")
    if (len(plan.banks), len(plan.singles), bank.n_cells) != (1, 0, 21) or \
            {k: tuple(v) for k, v in shapes.items()} != GRID_SHAPES:
        raise AssertionError(f"grid table1: unexpected plan {shapes}")

    # the first rounds of every lane: card (kernels) against the CPU's
    # plain path, and against the plain path on the card, same draws
    d, k, n = 11958, bank.cfg.sparsifier.k(11958), bank.cfg.n_workers
    runs = {}
    for dev, kern in {(device, True), (device, False), ("cpu", True)}:
        draws = [grid_replay(torch, dev, check_rounds, d, k, n, s)
                 for s in GRID_SEEDS]
        runs[(dev, kern)] = grid_run(torch, dev, "table1", kern,
                                     check_rounds, draws=draws,
                                     per_worker=per_worker)
    card, cpu = runs[(device, True)], runs[("cpu", True)]
    rel = float(((card["loss"] - cpu["loss"]).abs()
                 / cpu["loss"].abs()).max())
    log(f"grid table1: card vs cpu honest loss, every lane, {check_rounds} "
        f"rounds: max rel diff {rel:.3g} (bound 1e-4, the CNN phase's)")
    if rel > 1e-4:
        raise AssertionError("grid table1: card and cpu disagree")
    kvp = grid_compare("table1", bank, card, runs[(device, False)],
                       f"kernel vs plain path "
                       f"on the {device}, {check_rounds} rounds")
    out["table1_check"] = {"cpu_rel_loss": rel, **kvp}

    # the timed run: 100 rounds, TorchDraws(seed) per seed
    run = grid_run(torch, device, "table1", True, rounds, timed=True,
                   per_worker=per_worker, snapshot=single_rounds)
    loss, round_ms = run["loss"], run["round_ms"]
    steady = sorted(round_ms[1:])[len(round_ms[1:]) // 2]
    per_round = {k: run["launches"][k] / rounds
                 for k in ("pairdist", "cwtm", "median")}
    log(f"grid table1 timed: {rounds} rounds, first {round_ms[0]:.3f} ms, "
        f"median {steady:.3f} ms a round, {lanes_b / steady * 1e3:.1f} "
        f"lane-rounds/s, peak device memory {run['peak_mib']:.1f} MiB, "
        f"launches a round {per_round}")
    grid_check_launches("table1", run["launches"], rounds,
                        ("pairdist", "cwtm", "median"), on_card)
    rows, cells = [], bank.scenarios
    sim, state = run["sim"], run["state"]
    cells_state = state._replace(params_flat=state.params_flat.reshape(
        (bank.n_cells, len(GRID_SEEDS), -1)))
    acc = SW.fused_grid_eval(sim, cells_state, run["eval_batch"])["acc"]
    lossg = loss.reshape(bank.n_cells, len(GRID_SEEDS), rounds).numpy()
    for c, sc in enumerate(cells):
        per_round_bytes = SW.alg.algo_payload_bytes(sc.cfg, sim.d) * n
        btt = SW.bytes_to_threshold(lossg[c], per_round_bytes, GRID_TAU_LOSS)
        for i, r in enumerate(SW._result_rows(
                sc, sim, GRID_SEEDS, lossg[c],
                {"acc": acc[c].cpu().numpy()}, rounds)):
            r["bytes_to_loss_1"] = float(btt[i])
            rows.append(r)
            log(f"grid row {r['scenario']:30s} seed {r['seed']} final_loss "
                f"{r['final_loss']:.4f} acc {r['acc']:.4f} comm_bytes "
                f"{r['comm_bytes']} bytes_to_loss_1 {r['bytes_to_loss_1']}")
    bad = [sc.label for c, sc in enumerate(cells) if sc.cfg.name == "rosdhb"
           and not (np.isfinite(lossg[c]).all()
                    and (lossg[c][:, -1] < lossg[c][:, 0]).all())]
    if bad:
        raise AssertionError(f"grid table1: rosdhb honest loss did not fall "
                             f"or is not finite: {bad}")

    # three lanes against the port's own lone runs of their cells
    single_err = {}
    for algo, attack, agg, seed in GRID_SINGLES:
        c = next(i for i, sc in enumerate(cells)
                 if sc.label == f"table1/{algo}/{attack}/{agg}")
        lane = c * len(GRID_SEEDS) + GRID_SEEDS.index(seed)
        from repro_torch.core import mnist_testbed
        loss_fn, params0, batch_fn, _, _ = mnist_testbed(
            n, per_worker=per_worker, batch=60, seed=0, device=device)
        one = Simulator(loss_fn, params0, cells[c].cfg, device=device)
        st, _ = one.rollout(one.init(seed), batch_fn, steps=single_rounds)
        got = run["snapshot"][lane]
        err = float((st.params_flat - got).abs().max()
                    / st.params_flat.abs().max())
        single_err[cells[c].label + f"/seed{seed}"] = err
        log(f"grid lane {cells[c].label} seed {seed} vs its lone "
            f"Simulator.rollout, {single_rounds} rounds: max |d| / max |w| "
            f"= {err:.3g} (bound 1e-5)")
        if err > 1e-5:
            raise AssertionError(f"grid lane {cells[c].label}: differs from "
                                 f"its lone run")
    out["table1"] = {
        "lanes": lanes_b, "cells": bank.n_cells, "rounds": rounds,
        "round_ms": round_ms, "median_round_ms": steady,
        "lane_rounds_per_s": lanes_b / steady * 1e3,
        "peak_mib": run["peak_mib"], "launches": run["launches"],
        "launches_per_round": per_round, "shapes": shapes,
        "acc": {sc.label: [float(a) for a in acc[c]]
                for c, sc in enumerate(cells)},
        "single_lane_rel_err": single_err, "rows": rows}

    # (b) mimic-iid on the CNN, kernel against plain, same TorchDraws
    fin = {}
    for kern in (True, False):
        r = grid_run(torch, device, "mimic-iid", kern, mimic_rounds,
                     timed=True, per_worker=per_worker)
        fin[kern] = r
    mim = grid_compare("mimic-iid", fin[True]["bank"], fin[True],
                       fin[False], f"kernel vs plain, {mimic_rounds} rounds")
    ms = sorted(fin[True]["round_ms"][1:])[len(fin[True]["round_ms"]) // 2]
    log(f"grid mimic-iid: {fin[True]['bank'].n_cells} cells x 2 seeds, "
        f"median {ms:.3f} ms a round, launches {fin[True]['launches']}")
    # launches a round do not grow with the lane count: 4 lanes here, 42
    # in table1, 36 in mixed-attacks, one launch a branch a round in each
    grid_check_launches("mimic-iid", fin[True]["launches"], mimic_rounds,
                        ("pairdist", "cwtm"), on_card)
    out["mimic_iid"] = {**mim, "median_round_ms": ms,
                        "launches": fin[True]["launches"]}

    # (c) mixed-attacks on the quadratic, kernel against plain
    fin = {}
    for kern in (True, False):
        fin[kern] = grid_run(torch, device, "mixed-attacks", kern,
                             mixed_rounds, testbed="quadratic", timed=True)
    wk, wp = fin[True]["state"].params_flat, fin[False]["state"].params_flat
    mix = float((wk - wp).abs().max() / wp.abs().max())
    ms = sorted(fin[True]["round_ms"][1:])[len(fin[True]["round_ms"]) // 2]
    log(f"grid mixed-attacks: {fin[True]['bank'].n_cells} cells x 2 seeds "
        f"on the quadratic (d = 64), {mixed_rounds} rounds, kernel vs plain "
        f"max |d| / max |w| = {mix:.3g} (bound 1e-5), median {ms:.3f} ms a "
        f"round, launches {fin[True]['launches']}")
    if mix > 1e-5:
        raise AssertionError("grid mixed-attacks: kernel and plain disagree")
    grid_check_launches("mixed-attacks", fin[True]["launches"], mixed_rounds,
                        ("pairdist", "cwtm", "median"), on_card)
    out["mixed_attacks"] = {"rel_err": mix, "median_round_ms": ms,
                            "launches": fin[True]["launches"]}

    # last: the profiler's window over steady table1 rounds
    if on_card:
        box = [run["state"]]

        def one_round(i):
            box[0], _ = run["sim"].round(box[0], run["batch_fn"](rounds + i),
                                         run["lanes"])
        out["table1"]["profile"] = profile_window(torch, one_round, 5,
                                                  "grid table1")
    return out


LLM_GAMMA = 0.5      # large enough that 8 steps move the honest loss
LLM_STEPS = 8
LLM_CHECK_STEPS = 2
# Kernel path against the plain path over the first steps, same seed, same
# draws: the flash kernels round P and dS to bf16 where the plain attention
# rounds the normalised probabilities, so activations and bf16 gradients
# differ by bf16 rounding (relative 2^-9); the compress round trip is
# bitwise the mask multiply and CWTM differs only in float32 summation
# order. The honest loss averages 7 x 4095 token losses.
LLM_TOL_LOSS = 5e-3   # relative, per step
LLM_TOL_DIR = 2e-2    # relative |R|, per step
# the LLM cut at model dtype float32 (the float32 flash kernels): steps run
# on each path
LLM_F32_STEPS = 2


def llm_argv(device: str, steps: int, n_layers: int = LLM_LAYERS) -> list:
    return ["--arch", "stablelm_3b", "--steps", str(steps), "--n-layers",
            str(n_layers), "--n-workers", str(LLM_WORKERS), "--global-batch",
            str(LLM_WORKERS), "--f", "1", "--ratio", "0.05", "--gamma",
            str(LLM_GAMMA), "--seed", "0", "--device", device]


def llm_launches(cfg, plan, steps: int, on_card: bool, **server) -> dict:
    """Expected launches of ``steps`` LLM steps: the flash kernels of the
    model's dtype (:func:`flash_keys`, none of the other's) per
    self-attention application (:func:`flash_layers`) and worker, CWTM
    once a window of the payload round (:func:`payload_slices`), and the
    server kernels given (per step; a callable is called with ``plan``)."""
    per_step = flash_layers(cfg, on_card) * plan.n_workers
    fwd, bwd = flash_keys(cfg)
    want = {"flash_fwd": 0, "flash_bwd": 0, "flash_fwd_f32": 0,
            "flash_bwd_f32": 0, fwd: per_step * steps,
            bwd: per_step * steps,
            "cwtm": payload_slices(plan) * steps, "pairdist": 0,
            "median": 0,
            **{k: (v(plan) if callable(v) else v) * steps
               for k, v in server.items()}}
    return want if on_card else {k: 0 for k in want}


def check_launches(label: str, launches: dict, want: dict) -> None:
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def llm_phase(torch, device: str = "cuda", steps: int = LLM_STEPS,
              check_steps: int = LLM_CHECK_STEPS) -> dict:
    """The LLM main path through ``repro_torch.launch.train`` (``cpu`` only
    to rehearse the script's logic at the launcher's reduced CPU size),
    then the launcher's options: local masks, bfloat16 banks, the streamed
    run with its checkpoint."""
    from repro_torch import kernels as K
    from repro_torch.launch import train

    K.reset_launches()
    res = train.run(llm_argv(device, steps), log=log)
    launches = K.launches()
    plan = res["plan"]
    cfg = plan.model
    log(f"llm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}x"
        f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"layers={cfg.n_layers} seq={plan.shape.seq_len} n={plan.n_workers}"
        f" D={plan.flat_spec.padded_size:,} gamma={LLM_GAMMA}")
    for t, (l, r, ms) in enumerate(zip(res["losses"], res["dir_norms"],
                                       res["step_ms"])):
        log(f"llm step {t:3d} honest_loss={l:.6f} |R|={r:.6f} ms={ms:.3f}")
    steady = sorted(res["step_ms"][1:])[len(res["step_ms"][1:]) // 2]
    peak_mib = (res["peak_bytes"] / 2**20 if res["peak_bytes"] is not None
                else float("nan"))
    held_mib = (res["held_bytes"] / 2**20 if res["held_bytes"] is not None
                else float("nan"))
    log(f"llm: launches {launches}, first step {res['step_ms'][0]:.3f} ms, "
        f"median step {steady:.3f} ms, peak device memory {peak_mib:.1f} MiB")
    losses = res["losses"]
    if not all(math.isfinite(v) for v in losses + res["dir_norms"]):
        raise AssertionError(f"llm: non-finite loss or |R|: {losses}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"llm: honest loss did not fall: {losses}")
    on_card = device == "cuda"
    # the payload route, streamed: compress once a worker, the momentum
    # kernel and CWTM once a window; no dense wire, so no decompress
    check_launches("llm", launches, llm_launches(
        cfg, plan, steps, on_card, block_compress=compressions,
        block_decompress=0, momentum_scatter=payload_slices))

    prof = None
    if on_card:
        box = [res["state"]]

        def one_step(i):
            box[0], _ = res["step"](box[0], res["batch_fn"]())
        prof = profile_window(torch, one_step, 2, "llm")
        del box
    first = {"losses": losses[:check_steps],
             "dir_norms": res["dir_norms"][:check_steps]}
    step_ms = res["step_ms"]
    del res
    if on_card:
        torch.cuda.empty_cache()

    # the plain path on the same device, same seed and draws
    plain = train.run(llm_argv(device, check_steps), plain=True, log=log)
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(first["losses"],
                                                   plain["losses"]))
    rel_r = max(abs(a - b) / abs(b) for a, b in zip(first["dir_norms"],
                                                   plain["dir_norms"]))
    log(f"llm: kernel vs plain path over {check_steps} steps: honest loss "
        f"{first['losses']} vs {plain['losses']} (max rel {rel_l:.3g}, bound "
        f"{LLM_TOL_LOSS:g}); |R| {first['dir_norms']} vs "
        f"{plain['dir_norms']} (max rel {rel_r:.3g}, bound {LLM_TOL_DIR:g}); "
        f"plain steps {', '.join(f'{v:.3f}' for v in plain['step_ms'])} ms")
    if rel_l > LLM_TOL_LOSS or rel_r > LLM_TOL_DIR:
        raise AssertionError("llm: kernel and plain paths disagree")
    out = {"steps": steps, "losses": losses, "step_ms": step_ms,
           "median_step_ms": steady, "peak_mib": peak_mib,
           "held_mib": held_mib,
           "launches": launches, "profile": prof, "plain_rel_loss": rel_l,
           "plain_rel_dir": rel_r, "plain_step_ms": plain["step_ms"]}
    del plain
    if on_card:
        torch.cuda.empty_cache()
    out["options"] = llm_options(torch, device, main=out)
    out["f32"] = llm_f32(torch, device)
    return out


def llm_f32(torch, device: str = "cuda", steps: int = LLM_F32_STEPS) -> dict:
    """The LLM cut at model dtype float32 (``launch.train``'s plan and step
    on stablelm_3b with its dtype overridden, float32 banks): q, k and v
    float32, so the float32 flash kernels run once a self-attention
    application and worker each way (16 a step) and the bf16 ones not at
    all; finite losses, and the same steps against the plain path within
    ``LLM_TOL_LOSS`` and ``LLM_TOL_DIR`` (float32 attention on both sides:
    the bf16 model's bounds are loose for it)."""
    from repro_torch.launch import train
    on_card = device == "cuda"
    res = llm_run(torch, device, "f32", llm_argv(device, steps), steps,
                  dtype="float32", block_compress=compressions,
                  block_decompress=0, momentum_scatter=payload_slices)
    cfg = res["plan"].model
    rec = {"dtype": cfg.dtype, "steps": steps, "losses": res["losses"],
           "dir_norms": res["dir_norms"], "step_ms": res["step_ms"],
           "peak_mib": res["peak_mib"], "held_mib": res["held_mib"],
           "launches": res["launches"]}
    del res
    if on_card:
        torch.cuda.empty_cache()
    plain = train.run(llm_argv(device, steps), plain=True, log=log,
                      dtype="float32")
    rec["plain_rel_loss"] = max(abs(a - b) / abs(b) for a, b in zip(
        rec["losses"], plain["losses"]))
    rec["plain_rel_dir"] = max(abs(a - b) / abs(b) for a, b in zip(
        rec["dir_norms"], plain["dir_norms"]))
    rec["plain_step_ms"] = plain["step_ms"]
    rec["plain_peak_mib"] = (plain["peak_bytes"] / 2**20
                             if plain["peak_bytes"] is not None else None)
    del plain
    if on_card:
        torch.cuda.empty_cache()
    log(f"llm f32: {cfg.name} dtype={cfg.dtype} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}x{cfg.resolved_head_dim} layers={cfg.n_layers}"
        f": step ms {', '.join(f'{v:.3f}' for v in rec['step_ms'])}, peak "
        f"{rec['peak_mib']:.1f} MiB; kernel vs plain path over {steps} "
        f"steps: honest loss max rel {rec['plain_rel_loss']:.3g} (bound "
        f"{LLM_TOL_LOSS:g}), |R| max rel {rec['plain_rel_dir']:.3g} (bound "
        f"{LLM_TOL_DIR:g}); plain steps "
        f"{', '.join(f'{v:.3f}' for v in rec['plain_step_ms'])} ms, plain "
        f"peak {rec['plain_peak_mib']} MiB")
    if cfg.dtype != "float32" or rec["plain_rel_loss"] > LLM_TOL_LOSS or \
            rec["plain_rel_dir"] > LLM_TOL_DIR:
        raise AssertionError(f"llm f32: {rec}")
    return rec


def llm_run(torch, device: str, label: str, argv: list, steps: int,
            dtype=None, **server) -> dict:
    """One launcher run of ``steps`` steps (``dtype``: the model's, in
    place of the config's) with its launch counts checked (``server``: the
    server kernels' launches a step); returns the step times, the peak
    memory and the session."""
    from repro_torch import kernels as K
    from repro_torch.launch import train
    K.reset_launches()
    res = train.run(argv, log=log, dtype=dtype)
    launches = K.launches()
    peak = (res["peak_bytes"] / 2**20 if res["peak_bytes"] is not None
            else float("nan"))
    log(f"llm {label}: losses {res['losses']}, |R| {res['dir_norms']}, "
        f"wall ms {', '.join(f'{v:.3f}' for v in res['step_ms'])}, peak "
        f"device memory {peak:.1f} MiB, launches {launches}")
    if not all(math.isfinite(v) for v in res["losses"] + res["dir_norms"]):
        raise AssertionError(f"llm {label}: non-finite loss or |R|")
    plan = res["plan"]
    check_launches(f"llm {label}", launches, llm_launches(
        plan.model, plan, steps, device == "cuda", **server))
    held = (res["held_bytes"] / 2**20 if res["held_bytes"] is not None
            else float("nan"))
    return {**res, "peak_mib": peak, "held_mib": held, "launches": launches}


def compressions(plan) -> int:
    """Launches of ``block_compress`` a step of RoSDHB under ``plan``: one a
    worker where the step streams its payload
    (``algorithms.streams_payload``: each worker's row compressed into its
    payload row as soon as its gradient exists), one a step on the ``[n,
    D]`` bank."""
    from repro_torch.core import algorithms as alg
    return (plan.n_workers if alg.streams_payload(plan.algo,
                                                  plan.bank_width) else 1)


def payload_slices(plan) -> int:
    """Launches of ``momentum_scatter`` and CWTM a step of RoSDHB under
    ``plan``: one a window of the payload round
    (``algorithms._payload_window``: ``DENSE_COLUMNS // block_size`` blocks
    at banks narrower than float32, the whole bank elsewhere), one a step
    off the payload route."""
    from repro_torch.core import algorithms as alg
    d = plan.bank_width
    if alg._payload_route(plan.algo, d):
        nb = d // plan.algo.sparsifier.block_size
        return -(-nb // alg._payload_window(plan.algo, d))
    return 1


def dasha_slices(plan) -> int:
    """CWTM launches a step of Byz-DASHA-PAGE under ``plan``: one a column
    slice where the round runs by slices (``algorithms._dasha_by_columns``),
    one a step where it runs whole."""
    from repro_torch.core import algorithms as alg
    d = plan.bank_width
    if alg._dasha_by_columns(plan.algo, d):
        return -(-d // alg.DENSE_COLUMNS)
    return 1


def dasha_kernels(plan) -> dict:
    """The server kernels' launches a step of Byz-DASHA-PAGE: by column
    slices the dense mask path (no Block-RandK kernel) and CWTM once a
    slice; whole, the compress and decompress round trip where the
    sparsifier takes it (the CPU rehearsal's bank) and CWTM once."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import compression as comp
    sliced = alg._dasha_by_columns(plan.algo, plan.bank_width)
    trip = int(not sliced and comp._kernel_eligible(plan.algo.sparsifier,
                                                    plan.bank_width))
    return {"block_compress": trip, "block_decompress": trip,
            "momentum_scatter": 0, "cwtm": dasha_slices(plan)}


def llm_options(torch, device: str = "cuda", local_steps: int = 2,
                bf16_steps: int = 4, stream_steps: int = 8,
                chunk: int = 4, lowp_steps: int = 2,
                dasha_steps: int = 2, main=None) -> dict:
    """The launcher's options on the LLM path: local masks (the dense wire,
    so decompress runs), bfloat16 server banks, float16 and float8 server
    banks (each against the plain path at the same dtype), Byz-DASHA-PAGE
    at float32, bfloat16 and float8 banks (against the plain path at its
    dtype, its peak memory and payload beside RoSDHB's; ``main``: the main
    run's record, RoSDHB at float32 banks), and a streamed run with its
    checkpoint, against a per-step run over the same ``(seed, t)``
    batches."""
    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves

    on_card = device == "cuda"
    out = {}

    def done():
        if on_card:
            torch.cuda.empty_cache()

    # local masks: the dense wire, so decompress and the dense momentum
    res = llm_run(torch, device, "local masks", llm_argv(
        device, local_steps) + ["--local-masks"], local_steps,
        block_compress=1, block_decompress=1, momentum_scatter=0)
    out["local_masks"] = {k: res[k] for k in ("losses", "step_ms",
                                              "peak_mib", "launches")}
    del res
    done()

    res = llm_run(torch, device, "bfloat16 banks", llm_argv(
        device, bf16_steps) + ["--momentum-dtype", "bfloat16"], bf16_steps,
        block_compress=compressions, block_decompress=0,
        momentum_scatter=payload_slices)
    if res["state"].server.momentum.dtype != torch.bfloat16:
        raise AssertionError("llm bfloat16 banks: the momentum bank is "
                             f"{res['state'].server.momentum.dtype}")
    out["bf16"] = {k: res[k] for k in ("losses", "step_ms", "peak_mib",
                                       "held_mib", "launches")}
    del res
    done()

    # float16 and float8 banks: the wire in that dtype, the same kernels
    # (compress and the momentum kernel once a step), held to the plain
    # path at the same dtype as the main run is
    for dt in LOWP_DTYPES:
        argv = llm_argv(device, lowp_steps) + ["--momentum-dtype", dt]
        res = llm_run(torch, device, f"{dt} banks", argv, lowp_steps,
                      block_compress=compressions, block_decompress=0,
                      momentum_scatter=payload_slices)
        if res["state"].server.momentum.dtype != getattr(torch, dt):
            raise AssertionError(f"llm {dt} banks: the momentum bank is "
                                 f"{res['state'].server.momentum.dtype}")
        rec = {k: res[k] for k in ("losses", "dir_norms", "step_ms",
                                   "peak_mib", "held_mib", "launches")}
        del res
        done()
        plain = train.run(argv, plain=True, log=log)
        rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                       plain["losses"]))
        rel_r = max(abs(a - b) / abs(b) for a, b in zip(rec["dir_norms"],
                                                         plain["dir_norms"]))
        log(f"llm {dt} banks: kernel vs plain path over {lowp_steps} "
            f"steps: honest loss {rec['losses']} vs {plain['losses']} (max "
            f"rel {rel:.3g}, bound {LLM_TOL_LOSS:g}); |R| "
            f"{rec['dir_norms']} vs {plain['dir_norms']} (max rel "
            f"{rel_r:.3g}, bound {LLM_TOL_DIR:g})")
        if not (rel <= LLM_TOL_LOSS and rel_r <= LLM_TOL_DIR):
            raise AssertionError(f"llm {dt} banks: kernel and plain paths "
                                 f"disagree")
        out[dt] = {**rec, "plain_losses": plain["losses"],
                   "plain_dir_norms": plain["dir_norms"],
                   "plain_rel_loss": rel, "plain_rel_dir": rel_r}
        del plain
        done()

    out["dasha"] = llm_dasha(torch, device, dasha_steps, rosdhb={
        "float32": main or {}, "bfloat16": out["bf16"],
        **{dt: out[dt] for dt in LOWP_DTYPES}})
    done()

    ckpt = ROOT / "build" / "chip_smoke" / "llm_params"
    argv = llm_argv(device, stream_steps)
    res = llm_run(torch, device, "stream", argv + [
        "--stream", "--chunk-size", str(chunk), "--prefetch-depth", "2",
        "--checkpoint", str(ckpt)], stream_steps,
        block_compress=compressions, block_decompress=0,
        momentum_scatter=payload_slices)
    streamed = res["state"].params
    stream_rec = {k: res[k] for k in ("losses", "step_ms", "peak_mib",
                                      "launches", "host_high_water_bytes")}
    del res
    done()
    # the same (seed, t) batches one step at a time
    s = train.setup(train.parse_args(argv))
    state = s["state"]
    losses = []
    for t in range(stream_steps):
        batch = {k: torch.from_numpy(v).to(s["device"])
                 for k, v in s["batch_at"](t).items()}
        state, m = s["step"](state, batch)
        losses.append(float(m["loss"]))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(streamed),
                                                tree_leaves(state.params)))
    log(f"llm stream: {stream_steps} streamed steps (chunks of {chunk}) vs "
        f"per-step over the same batches: parameters bitwise {same}, losses "
        f"{stream_rec['losses']} vs {losses}; host high-water "
        f"{stream_rec['host_high_water_bytes']} B")
    if not same or losses != stream_rec["losses"]:
        raise AssertionError("llm stream: the streamed run is not the "
                             "per-step run")
    del s, state
    done()
    back = checkpoint.restore(str(ckpt), {"params": streamed})["params"]
    same_ck = all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                   tree_leaves(streamed)))
    step = checkpoint.latest_step(str(ckpt))
    log(f"llm checkpoint: restored {len(tree_leaves(back))} leaves, bitwise "
        f"{same_ck}, step {step}")
    if not same_ck or step != stream_steps:
        raise AssertionError("llm checkpoint: the restored parameters are "
                             "not the saved ones")
    out["stream"] = {**stream_rec, "bitwise_per_step": same,
                     "checkpoint_bitwise": same_ck}
    return out


DASHA_DTYPES = ("float32", "bfloat16", "float8_e4m3fn")


def llm_dasha(torch, device: str, steps: int, rosdhb: dict) -> dict:
    """Byz-DASHA-PAGE at the LLM cut (``--algo dasha``) at each bank dtype
    of :data:`DASHA_DTYPES` (float32, the paper's and the launcher's
    default, fits one card because the round by column slices writes its
    new banks over the old ones): its launches against the route's own count
    (:func:`dasha_kernels`), its honest loss and |R| against the plain path
    at the same dtype (:data:`LLM_TOL_LOSS`, :data:`LLM_TOL_DIR`), and its
    peak device memory and per-worker payload beside RoSDHB's at the same
    cut and bank dtype (``rosdhb``: those runs' records): the paper's
    memory and communication claim, measured."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import compression as comp
    from repro_torch.launch import train

    out = {}
    for dt in DASHA_DTYPES:
        argv = llm_argv(device, steps) + ["--algo", "dasha",
                                          "--momentum-dtype", dt]
        res = llm_run(torch, device, f"dasha {dt} banks", argv, steps,
                      **{k: (lambda plan, k=k: dasha_kernels(plan)[k])
                         for k in ("block_compress", "block_decompress",
                                   "momentum_scatter", "cwtm")})
        plan = res["plan"]
        srv = res["state"].server
        if srv.momentum.dtype != getattr(torch, dt) or srv.mirror is None:
            raise AssertionError(f"llm dasha {dt}: the banks are "
                                 f"{srv.momentum.dtype}, mirror "
                                 f"{srv.mirror is not None}")
        d = plan.flat_spec.padded_size
        rosdhb_cfg = dataclasses.replace(plan.algo, name="rosdhb")
        rec = {k: res[k] for k in ("losses", "dir_norms", "step_ms",
                                   "peak_mib", "held_mib", "launches")}
        rec.update(
            sliced=alg._dasha_by_columns(plan.algo, plan.bank_width),
            slices=dasha_slices(plan),
            payload_floats=comp.payload_floats(d, plan.algo.sparsifier),
            payload_bytes=alg.algo_payload_bytes(plan.algo, d),
            rosdhb_payload_bytes=alg.algo_payload_bytes(rosdhb_cfg, d),
            state_bytes=alg.server_state_bytes(plan.algo, plan.bank_width),
            rosdhb_state_bytes=alg.server_state_bytes(rosdhb_cfg,
                                                      plan.bank_width))
        del res, srv
        if device == "cuda":
            torch.cuda.empty_cache()
        plain = train.run(argv, plain=True, log=log)
        rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                       plain["losses"]))
        rel_r = max(abs(a - b) / abs(b) for a, b in zip(rec["dir_norms"],
                                                         plain["dir_norms"]))
        ros = rosdhb.get(dt, {})
        log(f"llm dasha {dt} banks: kernel vs plain path over {steps} "
            f"steps: honest loss {rec['losses']} vs {plain['losses']} (max "
            f"rel {rel:.3g}, bound {LLM_TOL_LOSS:g}); |R| "
            f"{rec['dir_norms']} vs {plain['dir_norms']} (max rel "
            f"{rel_r:.3g}, bound {LLM_TOL_DIR:g}); plain steps "
            f"{', '.join(f'{v:.3f}' for v in plain['step_ms'])} ms")
        log(f"llm dasha {dt} banks: {rec['slices']} column slices a round "
            f"(by columns: {rec['sliced']}); peak device memory "
            f"{rec['peak_mib']:.1f} MiB against RoSDHB's "
            f"{ros.get('peak_mib', float('nan')):.1f} MiB at the same cut "
            f"and bank dtype; server banks {rec['state_bytes']} B against "
            f"{rec['rosdhb_state_bytes']} B; a worker sends "
            f"{rec['payload_floats']} floats, {rec['payload_bytes']} B a "
            f"round with its indices, against RoSDHB's "
            f"{rec['rosdhb_payload_bytes']} B (a global mask sends none)")
        if not (rel <= LLM_TOL_LOSS and rel_r <= LLM_TOL_DIR):
            raise AssertionError(f"llm dasha {dt} banks: kernel and plain "
                                 f"paths disagree")
        out[dt] = {**rec, "rosdhb_peak_mib": ros.get("peak_mib"),
                   "plain_losses": plain["losses"],
                   "plain_dir_norms": plain["dir_norms"],
                   "plain_step_ms": plain["step_ms"],
                   "plain_peak_mib": (plain["peak_bytes"] / 2**20
                                      if plain["peak_bytes"] is not None
                                      else float("nan")),
                   "plain_rel_loss": rel, "plain_rel_dir": rel_r}
        del plain
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------- #
# the streaming parameter server
# ----------------------------------------------------------------------- #

SERVE_D = 1048576         # the quadratic phase's width
SERVE_ROUNDS = 20         # fig1-alie in process, each round held bitwise
SERVE_SHORT_ROUNDS = 10   # the median cell, the transports, bfloat16
SERVE_PARTIAL_ROUNDS = 30
SERVE_CHAOS_ROUNDS = 12
SERVE_MEDIAN_CELL = "stateless-linear/rosdhb/foe/median"
SERVE_WAIT_S = 120.0


def serve_cfg(use_kernels: bool = True, label=None, **over):
    """fig1-alie (or a registry cell by label) with the kernels or the
    plain rules, and ``over`` replacing config fields."""
    if label is None:
        cfg = fig1_alie(use_kernels)
    else:
        from repro_torch.adversary import registry as R
        cfg = next(sc.cfg for sc in R.expand_scenario(label.split("/")[0])
                   if sc.label == label)
        cfg = dataclasses.replace(cfg, aggregator=dataclasses.replace(
            cfg.aggregator, use_kernels=use_kernels))
    return dataclasses.replace(cfg, **over)


def serve_testbed(d: int, device: str):
    from repro_torch.core import quadratic_testbed
    return quadratic_testbed(13, d=d, seed=0, device=device)


def honest_loss(torch, w, tg) -> float:
    """The honest workers' mean quadratic loss at ``w``."""
    return float(0.5 * torch.square(w[None, :tg.shape[1]] - tg[F:]).sum(
        dim=-1).mean())


def serve_check_launches(label: str, launches: dict, fired: int,
                         names, device: str) -> None:
    want = fired if device == "cuda" else 0
    got = {k: launches[k] for k in names}
    if any(v != want for v in got.values()):
        raise AssertionError(f"serve {label}: launches {got}, expected "
                             f"{want} each ({fired} fired rounds)")


def serve_run(torch, device: str, cfg, rounds: int, runner=None,
              behavior=None, serve=None, draws_for=None, snapshots=False,
              d: int = SERVE_D, wrap_step=None) -> dict:
    """Serve ``rounds`` rounds in process with the launch counts set to 0
    just before and read just after (after ``stop()``: the batcher thread
    launches). ``snapshots`` keeps each round's parameters (a lock-step
    full-participation loop); ``wrap_step`` wraps the server's step."""
    from repro_torch import kernels as K
    from repro_torch.serve import (ByzantineRobustServer, ClientPool,
                                   ServeConfig, run_service)
    loss_fn, params0, batch_fn, tg = serve_testbed(d, device)
    server = ByzantineRobustServer(cfg, params0, serve or ServeConfig(),
                                   seed=0, device=device)
    pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=behavior,
                      device=device, draws_for=draws_for)
    if wrap_step is not None:
        server.step = wrap_step(server.step)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    params = []
    if snapshots:
        server.start()
        t0 = time.perf_counter()
        try:
            for t in range(rounds):
                ann = server.announce(timeout=SERVE_WAIT_S)
                for s in pool.round_payloads(ann):
                    server.submit(s.update)
                server.wait_round(t, timeout=SERVE_WAIT_S)
                params.append(server.params_flat)
        finally:
            server.metrics.span(t0, time.perf_counter())
            server.stop()
        results = None
    else:
        results = (runner or run_service)(server, pool, rounds)
    launches = K.launches()
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if device == "cuda" else float("nan"))
    return {"server": server, "pool": pool, "results": results,
            "params": params, "launches": launches, "peak_mib": peak,
            "summary": server.metrics.summary(), "targets": tg,
            "params0": params0}


def serve_times(summary: dict) -> dict:
    return {k: summary[k] for k in ("rounds", "rounds_per_sec",
                                    "updates_per_sec", "latency_p50_ms",
                                    "latency_p99_ms", "step_p50_ms")}


def serve_log_times(label: str, rec: dict) -> None:
    log(f"serve {label}: {rec['rounds']} rounds, {rec['rounds_per_sec']:.2f}"
        f" rounds/s, {rec['updates_per_sec']:.1f} updates/s, round latency "
        f"p50 {rec['latency_p50_ms']:.3f} ms p99 {rec['latency_p99_ms']:.3f}"
        f" ms, median step {rec['step_p50_ms']:.3f} ms, peak device memory "
        f"{rec['peak_mib']:.1f} MiB")


def serve_bf16(torch, device: str, rounds: int, d: int = SERVE_D) -> dict:
    """fig1-alie with ``server_compute_dtype="bfloat16"`` served on
    ``device``; each round's step inputs are replayed through the same step
    on the CPU, where the wrappers run the kernels' plain versions: the
    momentum bank bitwise, the parameters within ``gamma`` times one
    bfloat16 ulp of max |R| (the bar of the bfloat16 test against the
    reference; the plain rules, ``use_kernels=False``, are no yardstick
    here: they compute NNM's distances in bfloat16)."""
    from repro_torch.serve import ByzantineRobustServer
    cfg = serve_cfg(server_compute_dtype="bfloat16")
    steps = []

    def recorded(step):
        def run_step(params, state, wire, present, discount):
            new_p, new_s = step(params, state, wire, present, discount)
            steps.append([t.cpu() for t in (params, state.momentum, wire,
                                            present, discount, new_p,
                                            new_s.momentum)])
            return new_p, new_s
        return run_step

    run = serve_run(torch, device, cfg, rounds, d=d, wrap_step=recorded)
    serve_check_launches("bfloat16", run["launches"], rounds,
                         ("pairdist", "cwtm"), device)
    _, params0, _, _ = serve_testbed(d, "cpu")
    plain = ByzantineRobustServer(cfg, params0, device="cpu")
    worst, mom_equal = 0.0, True
    for p, m, wire, present, disc, new_p, new_m in steps:
        st = plain.server_state._replace(momentum=m)
        want_p, want_s = plain.step(p, st, wire, present, disc)
        mom_equal &= bool(torch.equal(want_s.momentum, new_m))
        max_r = float((p - new_p).abs().max()) / cfg.gamma
        ulp = 2.0 ** (math.floor(math.log2(max_r)) - 7)
        worst = max(worst, float((want_p - new_p).abs().max())
                    / (cfg.gamma * ulp))
    log(f"serve bfloat16 compute: launches "
        f"{ {k: run['launches'][k] for k in ('pairdist', 'cwtm')} }, each of "
        f"{len(steps)} steps against the plain versions on the cpu: momentum "
        f"bitwise {mom_equal}, parameters within {worst:.3g} x gamma x one "
        f"bfloat16 ulp of max |R| (bound 1)")
    if len(steps) != rounds or not mom_equal or worst > 1.0:
        raise AssertionError("serve bfloat16: the card's step and the plain "
                             "versions disagree")
    return {"rounds": rounds, "launches": run["launches"],
            "momentum_bitwise": mom_equal, "worst_in_bf16_ulps": worst}


def serve_pieces(torch, device: str, d: int = SERVE_D, reps: int = 5
                 ) -> dict:
    """One served round split into its host pieces (median ms of ``reps``):
    the announcement's device-to-host copy, the pool's gradients and wire,
    the wire's device-to-host copy, 13 update frames encoded (CRC32 over
    each payload) and decoded, the padded bank filled on the host and
    copied to the device, and the aggregate-and-apply step."""
    import numpy as np
    from repro_torch.serve import ByzantineRobustServer, ClientPool, protocol
    cfg = fig1_alie()
    loss_fn, params0, batch_fn, _ = serve_testbed(d, device)
    server = ByzantineRobustServer(cfg, params0, seed=0, device=device)
    pool = ClientPool(loss_fn, params0, cfg, batch_fn, device=device)
    ann = server.announce(timeout=1.0)
    n, p = cfg.n_workers, server.spec.padded_size
    box = {}

    def grads_wire():
        box["wire"] = pool.wire(ann)[0]

    def wire_d2h():
        box["host"] = box["wire"].cpu().numpy()

    def encode():
        box["frames"] = [protocol.encode_update(protocol.make_update(
            cfg, server.d, c, ann, box["host"][c])) for c in range(n)]

    def decode():
        box["updates"] = []
        for raw in box["frames"]:
            _, sender, payload = protocol.decode_frame(raw)
            box["updates"].append(protocol.decode_update(payload, sender))

    def bank_fill():
        bank = np.zeros((n, p), np.float32)
        for u in box["updates"]:
            bank[u.client_id] = u.values
        box["bank"] = bank

    def bank_h2d():
        box["bank_t"] = torch.from_numpy(box["bank"]).to(device)
        box["present"] = torch.ones(n, dtype=torch.bool, device=device)
        box["discount"] = torch.ones(n, device=device)

    def step():
        server.step(server.params_flat, server.server_state, box["bank_t"],
                    box["present"], box["discount"])

    pieces = {"announce_d2h": server._host_params,
              "pool_grads_wire": grads_wire, "wire_d2h": wire_d2h,
              "encode_crc32": encode, "decode_crc32": decode,
              "bank_fill": bank_fill, "bank_h2d": bank_h2d, "step": step}
    out = {}
    for name, fn in pieces.items():
        times = []
        for _ in range(reps + 1):
            sync(torch, device)
            t0 = time.perf_counter()
            fn()
            sync(torch, device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(times[1:])[len(times[1:]) // 2]
    log("serve round pieces (median ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()) + f"; total "
        f"{sum(out.values()):.3f}")
    return out


def serve_profile(torch, device: str, d: int = SERVE_D,
                  rounds: int = 5) -> dict:
    """Device busy and idle share of in-process served rounds (after a
    warm-up round), from ``profile_window``; the batcher thread's kernels
    are on the card's timeline like the pool's."""
    from repro_torch.serve import (ByzantineRobustServer, ClientPool,
                                   run_service)
    cfg = fig1_alie()
    loss_fn, params0, batch_fn, _ = serve_testbed(d, device)
    server = ByzantineRobustServer(cfg, params0, seed=0, device=device)
    pool = ClientPool(loss_fn, params0, cfg, batch_fn, device=device)
    run_service(server, pool, 1, stop=False)
    try:
        return profile_window(
            torch, lambda i: run_service(server, pool, 1, stop=False),
            rounds, "serve")
    finally:
        server.stop()


def serve_phase(torch, device: str = "cuda", d: int = SERVE_D,
                rounds: int = SERVE_ROUNDS, short: int = SERVE_SHORT_ROUNDS,
                partial_rounds: int = SERVE_PARTIAL_ROUNDS,
                chaos_rounds: int = SERVE_CHAOS_ROUNDS) -> dict:
    """The streaming parameter server (``repro_torch.serve``) at d =
    1,048,576: (1) fig1-alie in process, each round bitwise
    ``Simulator.rollout`` on the same draws, one pairdist and one CWTM
    launch a round; (2) the ``rosdhb/foe/median`` cell, kernel path against
    plain path; (3) loopback and TCP bitwise the in-process server; (4)
    partial participation under the clock, then kernel against plain path
    driven lock-step; (5) ``combined`` chaos over TCP and the kill-restart
    resuming bitwise; (6) bfloat16 server arithmetic, kernel against plain;
    (7) times. ``cpu`` only to rehearse the script's logic."""
    import numpy as np
    from repro_torch.core import Simulator
    from repro_torch.serve import (ClientBehavior, ServeConfig, get_chaos,
                                   run_chaos, run_lockstep)
    from repro_torch.testing import RecordingDraws, SeedWordDraws
    on_card = device == "cuda"
    out = {}

    # (1) fig1-alie, in process, full participation: round by round the
    # simulator's trajectory on the same draws
    recs = []

    def recording(ann):
        recs.append(RecordingDraws(SeedWordDraws(ann.mask_key, ann.atk_key,
                                                 device)))
        return recs[-1]

    run = serve_run(torch, device, serve_cfg(), rounds, draws_for=recording,
                    snapshots=True, d=d)
    serve_check_launches("fig1-alie", run["launches"], rounds,
                         ("pairdist", "cwtm"), device)
    loss_fn, params0, batch_fn, tg = serve_testbed(d, device)
    sim = Simulator(loss_fn, params0, serve_cfg(), device=device)
    st = sim.init(seed=0)
    unequal = []
    for t, rec in enumerate(recs):
        st, _ = sim.round(st._replace(draws=rec.replay()), batch_fn(t))
        if not torch.equal(st.params_flat, run["params"][t]):
            unequal.append(t)
    log(f"serve fig1-alie d={d}: {rounds} rounds in process, launches "
        f"{ {k: run['launches'][k] for k in ('pairdist', 'cwtm')} }, rounds"
        f" not bitwise the simulator's: {unequal}")
    if unequal:
        raise AssertionError(f"serve fig1-alie: rounds {unequal} differ from "
                             f"Simulator.rollout")
    out["parity"] = {"rounds": rounds, "launches": run["launches"],
                     "bitwise_rounds": rounds - len(unequal)}

    # (2) rosdhb/foe/median: the median kernel once a round
    finals = {}
    for use_kernels in (True, False):
        run = serve_run(torch, device, serve_cfg(use_kernels,
                                                 SERVE_MEDIAN_CELL), short,
                        d=d)
        if use_kernels:
            serve_check_launches("median cell", run["launches"], short,
                                 ("pairdist", "median"), device)
            med_launches = run["launches"]
        finals[use_kernels] = run["server"].params_flat
    diff = float((finals[True] - finals[False]).abs().max())
    scale = float(finals[False].abs().max())
    log(f"serve {SERVE_MEDIAN_CELL}: launches "
        f"{ {k: med_launches[k] for k in ('pairdist', 'median')} }, kernel vs "
        f"plain path after {short} rounds max |d| {diff:.3g} of max |w| "
        f"{scale:.4f} (bound 1e-5 relative, the quadratic phase's)")
    if diff > 1e-5 * scale:
        raise AssertionError("serve median cell: kernel and plain paths "
                             "disagree")
    out["median"] = {"rounds": short, "launches": med_launches,
                     "max_abs_diff": diff}

    # (3) + (7) the transports, timed: in process, loopback, TCP
    from repro_torch import kernels as K
    run = serve_run(torch, device, serve_cfg(), short, d=d)
    serve_check_launches("in-process", run["launches"], short,
                         ("pairdist", "cwtm"), device)
    want = run["server"].params_flat.cpu().numpy()
    transports = {"in_process": {**serve_times(run["summary"]),
                                 "peak_mib": run["peak_mib"],
                                 "launches": run["launches"]}}
    serve_log_times("in-process", transports["in_process"])
    for kind in ("loopback", "tcp"):
        sc = dataclasses.replace(get_chaos("fault-free"), transport=kind)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        res = run_chaos(serve_cfg(), params0, batch_fn, loss_fn, sc, short,
                        seed=0, device=device)
        launches = K.launches()
        serve_check_launches(kind, launches, short, ("pairdist", "cwtm"),
                             device)
        transports[kind] = {
            **serve_times(res.summaries[0]), "launches": launches,
            "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                         if device == "cuda" else float("nan")),
            "bitwise": bool(np.array_equal(res.final_params, want))}
        serve_log_times(kind, transports[kind])
        if not transports[kind]["bitwise"] or res.step_traces != [1]:
            raise AssertionError(f"serve {kind}: not bitwise the in-process "
                                 f"server (step_traces {res.step_traces})")
    out["transports"] = transports
    # (7) one round's host pieces
    out["pieces"] = serve_pieces(torch, device, d)

    # (4) partial participation under the clock
    beh = dict(drop_prob=0.2, late_prob=0.1, seed=0)
    run = serve_run(torch, device, serve_cfg(), partial_rounds,
                    behavior=ClientBehavior(**beh),
                    serve=ServeConfig(timeout_s=0.05, staleness_window=2),
                    d=d)
    s = run["summary"]
    fired = s["rounds"]
    serve_check_launches("partial", run["launches"], fired,
                         ("pairdist", "cwtm"), device)
    loss0 = honest_loss(torch, run["server"].params_flat.new_zeros(
        run["server"].params_flat.shape), run["targets"])
    loss1 = honest_loss(torch, run["server"].params_flat, run["targets"])
    log(f"serve partial participation: {fired} rounds, fired_by "
        f"{s['fired_by']}, participation {s['participation_histogram']}, "
        f"staleness {s['staleness_histogram']}, launches "
        f"{ {k: run['launches'][k] for k in ('pairdist', 'cwtm')} }, honest "
        f"loss {loss0:.4f} -> {loss1:.4f}")
    if not (math.isfinite(loss1) and loss1 < loss0):
        raise AssertionError("serve partial: honest loss did not fall")
    if len(s["participation_histogram"]) < 2:
        raise AssertionError("serve partial: participation did not spread")
    partial = {**serve_times(s), "peak_mib": run["peak_mib"],
               "launches": run["launches"], "loss0": loss0, "loss": loss1,
               "participation_histogram": s["participation_histogram"],
               "fired_by": s["fired_by"]}
    # the same behaviour driven lock-step (the rows each round fixed by the
    # pool's fates, not the clock): kernel path against plain path
    finals, rows = {}, {}
    for use_kernels in (True, False):
        run = serve_run(torch, device, serve_cfg(use_kernels), partial_rounds,
                        runner=run_lockstep, behavior=ClientBehavior(**beh),
                        serve=ServeConfig(staleness_window=2), d=d)
        if use_kernels:
            serve_check_launches("partial lock-step", run["launches"],
                                 partial_rounds, ("pairdist", "cwtm"),
                                 device)
        finals[use_kernels] = run["server"].params_flat
        rows[use_kernels] = [(r.client_ids, r.staleness)
                             for r in run["results"]]
    diff = float((finals[True] - finals[False]).abs().max())
    scale = float(finals[False].abs().max())
    log(f"serve partial lock-step: participation "
        f"{sorted({len(r[0]) for r in rows[True]})}, kernel vs plain path "
        f"after {partial_rounds} rounds max |d| {diff:.3g} of max |w| "
        f"{scale:.4f} (bound 1e-5 relative, the quadratic phase's)")
    if rows[True] != rows[False] or diff > 1e-5 * scale:
        raise AssertionError("serve partial lock-step: kernel and plain "
                             "paths disagree")
    partial["lockstep_max_abs_diff"] = diff
    out["partial"] = partial

    # (5) chaos over TCP: combined faults, then the kill-restart bitwise
    sc = dataclasses.replace(get_chaos("combined"), transport="tcp")
    K.reset_launches()
    res = run_chaos(serve_cfg(), params0, batch_fn, loss_fn, sc,
                    chaos_rounds, seed=0, device=device)
    launches = K.launches()
    fired = sum(x["rounds"] for x in res.summaries)
    log(f"serve chaos combined over tcp: {chaos_rounds} rounds, terminated "
        f"{res.all_rounds_terminated()}, restarts {res.restarts}, "
        f"step_traces {res.step_traces}, injected {res.injected}, clients "
        f"{res.client_stats}, fired {fired}, launches "
        f"{ {k: launches[k] for k in ('pairdist', 'cwtm')} }")
    if not (res.all_rounds_terminated() and res.step_traces == [1, 1]
            and sum(res.injected.values()) > 0
            and res.client_stats["retries"] > 0):
        raise AssertionError("serve chaos combined: failed its checks")
    serve_check_launches("chaos", launches, fired, ("pairdist", "cwtm"),
                         device)
    kill = {}
    for name in ("fault-free", "kill-restart"):
        kill[name] = run_chaos(
            serve_cfg(), params0, batch_fn, loss_fn,
            dataclasses.replace(get_chaos(name), transport="tcp"),
            chaos_rounds, seed=0, device=device)
    bitwise = bool(np.array_equal(kill["kill-restart"].final_params,
                                  kill["fault-free"].final_params))
    log(f"serve kill-restart over tcp: restarts "
        f"{kill['kill-restart'].restarts}, bitwise the uninterrupted run: "
        f"{bitwise}")
    if not bitwise or kill["kill-restart"].restarts != 1:
        raise AssertionError("serve kill-restart: did not resume bitwise")
    out["chaos"] = {"rounds": chaos_rounds, "fired": fired,
                    "launches": launches, "injected": res.injected,
                    "client_stats": res.client_stats,
                    "step_traces": res.step_traces,
                    "kill_restart_bitwise": bitwise}

    # (6) bfloat16 server arithmetic: each round's step on the card (the
    # kernels) against the kernels' plain versions on the CPU, same inputs
    out["bf16"] = serve_bf16(torch, device, short, d)
    # a profiled window of served rounds last (a profiler slows the
    # launches that follow it in the process)
    out["profile"] = serve_profile(torch, device, d) if on_card else None

    return out


STREAM_ROUNDS = 100      # fig1-alie on the CNN, pre-stacked and streamed
STREAM_CHUNK, STREAM_DEPTH = 16, 2   # 6 chunks and a 4-round tail
STREAM_TAU = 0.85        # the paper's accuracy target
STREAM_TAU_CHUNK = 10
STREAM_TAU_CAP = 600
STREAM_GRID_ROUNDS, STREAM_GRID_CHUNK = 40, 8
TT1_SEEDS = (0, 1)       # transformer-table1: 4 cells x 2 seeds = 8 lanes
TT1_ROUNDS, TT1_CHUNK, TT1_CHECK = 16, 4, 2
TT1_TOL_LOSS = 5e-3      # the LLM check's bfloat16 bar (relative)
GATE_BYTES, GATE_ROUNDS, GATE_CHUNK = 128 * 1024, 48, 4
COST_STEPS = 100         # rounds of each calibration probe
COST_MODEL_OUT = ROOT / "build" / "chip_smoke" / "COST_MODEL_torch.json"


def pure_mnist_batches(ds, batch: int, seed: int = 0):
    """A batch function of the dataset that is a pure function of the round
    (``np.random.default_rng((seed, t))``), so a stream and a stacked
    schedule, or two banks, see the same rounds."""
    import numpy as np

    def batch_fn(t):
        rng = np.random.default_rng((seed, int(t)))
        idx = rng.integers(0, ds.per_worker, size=(ds.n_workers, batch))
        return {"images": np.stack([ds.images[w, idx[w]]
                                    for w in range(ds.n_workers)]),
                "labels": np.stack([ds.labels[w, idx[w]]
                                    for w in range(ds.n_workers)])}
    return batch_fn


def same_run(torch, label: str, a, am: dict, b, bm: dict) -> None:
    """Two runs bitwise: parameters, server banks, every per-round metric
    (bit patterns: a lane that diverged holds NaN, which ``torch.equal``
    never calls equal)."""
    def same(x, y):
        return x.shape == y.shape and (
            torch.equal(bits(torch, x), bits(torch, y))
            if x.is_floating_point() else torch.equal(x, y))
    diffs = [] if same(a.params_flat, b.params_flat) else ["params"]
    diffs += [f"server.{i}" for i, (x, y) in enumerate(zip(a.server,
                                                           b.server))
              if isinstance(x, torch.Tensor) and not same(x, y)]
    diffs += [k for k in bm if not same(am[k], bm[k])]
    if set(am) != set(bm) or diffs:
        raise AssertionError(f"stream {label}: not bitwise: {diffs}")


def check_launch_counts(label: str, got: dict, want: dict) -> None:
    got = {k: got[k] for k in want}
    if got != want:
        raise AssertionError(f"stream {label}: launches {got}, expected "
                             f"{want}")


def stream_split(torch, sim, stacked, rounds: int, device, timed) -> dict:
    """Where a streamed round's time goes: the chunks' copies to the card
    (every chunk taken at once), then ``rounds`` rounds on batches already
    on the card, against the same rounds on host batches that each round
    copies (the materialised rollout's way)."""
    from repro_torch.data.stream import StackedChunkSource
    from repro_torch.utils import tree as T
    n = rounds // STREAM_CHUNK
    src = StackedChunkSource(stacked, rounds, STREAM_CHUNK, device=device)
    chunks, take_s = timed(lambda: src.take(n))
    on_card = [T.tree_map(lambda l: l[i], c) for c in chunks
               for i in range(STREAM_CHUNK)]
    on_host = [T.tree_map(lambda l: l[t], stacked)
               for t in range(n * STREAM_CHUNK)]

    def run(batches):
        st = sim.init(0)
        for b in batches:
            st, _ = sim.round(st, b)
        return st
    times = {}
    for label, batches in (("host", on_host), ("card", on_card),
                           ("card", on_card), ("host", on_host)):
        times.setdefault(label, []).append(
            timed(lambda: run(batches))[1] / len(batches) * 1e3)
    out = {"take_ms_per_chunk": take_s / n * 1e3,
           "round_ms_batch_on_card": min(times["card"]),
           "round_ms_batch_on_host": min(times["host"])}
    log(f"stream cnn split: {n} chunks of {STREAM_CHUNK} rounds copied to "
        f"the {device} in {take_s * 1e3:.3f} ms "
        f"({out['take_ms_per_chunk']:.3f} a chunk); a round on a batch "
        f"already there {out['round_ms_batch_on_card']:.3f} ms, on a host "
        f"batch it copies {out['round_ms_batch_on_host']:.3f} ms (best of 2 "
        f"each, in turns host, card, card, host)")
    return out


def stream_phase(torch, device: str = "cuda", rounds: int = STREAM_ROUNDS,
                 tau_cap: int = STREAM_TAU_CAP,
                 grid_rounds: int = STREAM_GRID_ROUNDS,
                 tt1_rounds: int = TT1_ROUNDS, gate_rounds: int = GATE_ROUNDS,
                 cost_steps: int = COST_STEPS, per_worker: int = 800,
                 card: str = "") -> dict:
    """Streamed rollouts (``Simulator.rollout_streaming``) with early exit
    at tau, the streamed grid, the transformer testbed and the cost model
    on the card: (1) fig1-alie on the CNN, 100 rounds pre-stacked and then
    from a pure batch function, bitwise ``Simulator.rollout``; (2) time to
    accuracy 0.85, checked against a fixed run evaluated every chunk; (3)
    the ``table1`` grid streamed, bitwise the materialised grid; (4)
    ``transformer-table1`` streamed through ``run_scenarios`` (flash under
    ``torch.func``), its first rounds against the plain path and the CPU;
    (5) the host-memory gate; (6) the cost model's calibration. cuDNN keeps
    to its deterministic algorithms here: the bitwise checks compare two
    runs of the same convolutions. ``cpu`` only to rehearse the script's
    logic."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _stream_phase(torch, device, rounds, tau_cap, grid_rounds,
                             tt1_rounds, gate_rounds, cost_steps,
                             per_worker, card)
    finally:
        torch.backends.cudnn.deterministic = det


def _stream_phase(torch, device, rounds, tau_cap, grid_rounds, tt1_rounds,
                  gate_rounds, cost_steps, per_worker, card) -> dict:
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.adversary import registry as R
    from repro_torch.core import costmodel as CM
    from repro_torch.core import mnist_testbed
    from repro_torch.core import sweep as SW
    from repro_torch.core.simulator import Simulator, stack_batches
    on_card = device == "cuda"
    out = {}

    def timed(fn):
        sync(torch, device)
        t0 = time.perf_counter()
        res = fn()
        sync(torch, device)
        return res, time.perf_counter() - t0

    # (1) fig1-alie on the CNN: stacked, then from a pure batch function
    cfg = fig1_alie()
    loss_fn, params0, bf, eval_fn, eval_batch = mnist_testbed(
        13, per_worker=per_worker, batch=60, seed=0, device=device)
    pure = pure_mnist_batches(bf.ds, 60)
    sim = Simulator(loss_fn, params0, cfg, eval_fn=eval_fn, device=device)
    stacked = stack_batches(pure, rounds)
    sim.rollout(sim.init(0), stack_batches(pure, 2))  # warm-up
    (want, wm), mat_s = timed(lambda: sim.rollout(sim.init(0), stacked))
    runs = {}
    for label, feed in (("stacked", stacked), ("prefetcher", pure)):
        K.reset_launches()
        (st, m, info), secs = timed(lambda: sim.rollout_streaming(
            sim.init(0), feed, rounds, chunk_size=STREAM_CHUNK,
            prefetch_depth=STREAM_DEPTH))
        launches = K.launches()
        same_run(torch, f"cnn {label}", st, m, want, wm)
        n = rounds if on_card else 0
        check_launch_counts(f"cnn {label}", launches,
                            {"pairdist": n, "cwtm": n})
        runs[label] = {"ms_per_round": secs / rounds * 1e3,
                       "launches": launches, "bitwise": True,
                       **{k: info[k] for k in (
                           "rounds_run", "dispatches", "chunk_bytes",
                           "host_high_water_bytes",
                           "device_buffer_bytes")}}
        log(f"stream cnn {label}: {rounds} rounds (chunk {STREAM_CHUNK}, "
            f"depth {STREAM_DEPTH}, tail {rounds % STREAM_CHUNK}) bitwise "
            f"Simulator.rollout (params, momentum, every metric), "
            f"{secs / rounds * 1e3:.3f} ms a round against "
            f"{mat_s / rounds * 1e3:.3f} materialised, launches "
            f"{ {k: launches[k] for k in ('pairdist', 'cwtm')} }, "
            f"dispatches {info['dispatches']}, host high water "
            f"{info['host_high_water_bytes']} B")
    out["cnn"] = {"rounds": rounds, "materialised_ms_per_round":
                  mat_s / rounds * 1e3, **runs,
                  "split": stream_split(torch, sim, stacked, rounds,
                                        device, timed)}

    # (2) time to tau: accuracy 0.85, one eval a chunk, capped
    K.reset_launches()
    (st, m, info), wall = timed(lambda: sim.rollout_streaming(
        sim.init(0), pure, tau_cap, chunk_size=STREAM_TAU_CHUNK,
        prefetch_depth=STREAM_DEPTH, tau=STREAM_TAU, eval_batch=eval_batch))
    r = info["rounds_run"]
    per_round_bytes = sim.payload_bytes_per_round()
    # the fixed run: rollout over the same schedule, chunk by chunk, with
    # the same eval after each chunk (no early exit)
    fixed, accs, state = [], [], sim.init(0)
    ev = sim._on_device(eval_batch)
    for c in range(r // STREAM_TAU_CHUNK):
        state, fm = sim.rollout(state, stack_batches(
            pure, STREAM_TAU_CHUNK, start=c * STREAM_TAU_CHUNK))
        fixed.append(fm)
        with torch.no_grad():
            accs.append(float(eval_fn(sim.params(state), ev)["acc"]))
    fixed = {k: torch.cat([f[k] for f in fixed]) for k in fixed[0]}
    for k in m:
        if not torch.equal(m[k], fixed[k][:r]):
            raise AssertionError(f"stream tau: {k} is not the fixed run's "
                                 f"prefix")
    hits = [i for i, a in enumerate(accs) if a >= STREAM_TAU]
    first = (hits[0] + 1) * STREAM_TAU_CHUNK if hits else None
    if info["early_exit"] != bool(hits) or (hits and first != r) or (
            not hits and r != tau_cap):
        raise AssertionError(f"stream tau: stopped at {r} (early exit "
                             f"{info['early_exit']}), the fixed run first "
                             f"reaches {STREAM_TAU} at {first}")
    if info["last_metric"] != accs[-1]:
        raise AssertionError("stream tau: last_metric is not the fixed "
                             "run's last eval")
    out["tau"] = {"tau": STREAM_TAU, "cap": tau_cap,
                  "rounds_run": r, "early_exit": info["early_exit"],
                  "cap_first": not info["early_exit"],
                  "last_metric": info["last_metric"],
                  "dispatches": info["dispatches"], "wall_s": wall,
                  "bytes_per_round": per_round_bytes,
                  "bytes_to_tau": per_round_bytes * r,
                  "acc_per_chunk": accs, "launches": K.launches()}
    log(f"stream time to tau: acc >= {STREAM_TAU} "
        + (f"at round {r}" if info["early_exit"] else
           f"not reached by the cap of {tau_cap} rounds")
        + f" (early_exit {info['early_exit']}, last_metric "
        f"{info['last_metric']:.4f}, dispatches {info['dispatches']}), "
        f"{wall:.3f} s wall, {per_round_bytes * r} bytes "
        f"({per_round_bytes} a round); the metrics are the fixed run's "
        f"prefix and its per-chunk eval first reaches tau at {first}")

    # (3) the table1 grid on the CNN, streamed against materialised
    plan = SW.plan_grid(grid_cells("table1", True))
    bank = plan.banks[0]
    gsim = Simulator(loss_fn, params0, bank.cfg, eval_fn=eval_fn,
                     device=device)
    params = bank.scenario_params()
    gstacked = stack_batches(pure, grid_rounds)
    SW.fused_grid_rollout(gsim, params, GRID_SEEDS, gstacked, 1)  # warm-up
    (want, wm), mat_s = timed(lambda: SW.fused_grid_rollout(
        gsim, params, GRID_SEEDS, gstacked))
    K.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, lanes = SW.grid_lanes(gsim, params, GRID_SEEDS)
    (st, m, info), secs = timed(lambda: gsim.rollout_streaming(
        state, pure, grid_rounds, chunk_size=STREAM_GRID_CHUNK,
        prefetch_depth=STREAM_DEPTH, scenario=lanes))
    launches = K.launches()
    got, gm = SW._by_cell(st, m, bank.n_cells, len(GRID_SEEDS))
    same_run(torch, "grid table1", got, gm, want, wm)
    grid_check_launches("stream table1", launches, grid_rounds,
                        ("pairdist", "cwtm", "median"), on_card)
    out["grid"] = {"lanes": bank.n_cells * len(GRID_SEEDS),
                   "rounds": grid_rounds, "chunk": STREAM_GRID_CHUNK,
                   "ms_per_round": secs / grid_rounds * 1e3,
                   "materialised_ms_per_round": mat_s / grid_rounds * 1e3,
                   "launches": launches, "bitwise": True,
                   "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                                if on_card else None),
                   **{k: info[k] for k in ("dispatches", "chunk_bytes",
                                           "host_high_water_bytes")}}
    log(f"stream grid table1: {out['grid']['lanes']} lanes x {grid_rounds} "
        f"rounds (chunk {STREAM_GRID_CHUNK}, depth {STREAM_DEPTH}) bitwise "
        f"the materialised fused_grid_rollout, "
        f"{out['grid']['ms_per_round']:.3f} ms a round against "
        f"{out['grid']['materialised_ms_per_round']:.3f} materialised, "
        f"launches {launches}, host high water "
        f"{info['host_high_water_bytes']} B (the materialised schedule: "
        f"{grid_rounds * info['chunk_bytes'] // STREAM_GRID_CHUNK} B)")
    del gsim, want, st, got

    # (4) transformer-table1 streamed through run_scenarios
    spec = R.get_spec("transformer-table1")
    cells = spec.expand()
    tloss, tp0, tbatch, teval, teval_batch = SW._transformer_testbed(
        spec.n_workers, device=device)
    sims = {}

    def tt1_run(steps):
        return SW.run_scenarios(
            cells, loss_fn=tloss, params0=tp0, batches=tbatch,
            seeds=TT1_SEEDS, steps=steps, eval_fn=teval,
            eval_batch=teval_batch, device=device, streaming=True,
            stream_chunk_size=TT1_CHUNK, prefetch_depth=STREAM_DEPTH,
            sim_cache=sims)
    tt1_run(TT1_CHUNK)  # warm-up: the simulator and the libraries' set-up
    K.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rows, wall = timed(lambda: tt1_run(tt1_rounds))
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    layers = 2
    want_l = ({"flash_fwd": layers * tt1_rounds + layers,
               "flash_bwd": layers * tt1_rounds, "pairdist": tt1_rounds,
               "cwtm": tt1_rounds} if on_card else
              {k: 0 for k in ("flash_fwd", "flash_bwd", "pairdist",
                              "cwtm")})
    check_launch_counts("transformer-table1", launches, want_l)
    bad = [r["scenario"] for r in rows
           if not (math.isfinite(r["final_loss"]) and 0.0 <= r["acc"] <= 1.0)]
    if bad or len(rows) != len(cells) * len(TT1_SEEDS):
        raise AssertionError(f"stream transformer-table1: bad rows {bad}")
    for r in rows:
        log(f"stream transformer-table1 row {r['scenario']:40s} seed "
            f"{r['seed']} final_loss {r['final_loss']:.4f} acc "
            f"{r['acc']:.4f} comm_bytes {r['comm_bytes']}")
    # every lane's first rounds: kernels on the card against the plain
    # path on the card and on the CPU, the same parameters and draws
    tplan = SW.plan_grid(cells)
    if len(tplan.banks) != 1 or tplan.singles:
        raise AssertionError(f"transformer-table1: {tplan.describe()}")
    losses = {}
    for dev, kern in ((device, True), (device, False), ("cpu", False)):
        lf = SW._transformer_testbed(spec.n_workers, device=dev,
                                     use_kernels=kern)[0]
        bank = SW.plan_grid(SW.with_kernels(cells, kern)).banks[0]
        s = Simulator(lf, tp0, bank.cfg, device=dev)
        k = bank.cfg.sparsifier.k(s.d)
        draws = [grid_replay(torch, dev, TT1_CHECK, s.d, k, 0, sd)
                 for sd in TT1_SEEDS]
        _, tm = SW.fused_grid_rollout(s, bank.scenario_params(), TT1_SEEDS,
                                      tbatch, TT1_CHECK, draws=draws)
        losses[(dev, kern)] = tm["loss"].float().cpu()
    kern = losses[(device, True)]
    rel_plain = float(((kern - losses[(device, False)]).abs()
                       / losses[(device, False)].abs()).max())
    rel_cpu = float(((kern - losses[("cpu", False)]).abs()
                     / losses[("cpu", False)].abs()).max())
    log(f"stream transformer-table1: {len(cells)} cells x {len(TT1_SEEDS)} "
        f"seeds = {len(cells) * len(TT1_SEEDS)} lanes of {spec.n_workers} "
        f"workers, {tt1_rounds} rounds (chunk {TT1_CHUNK}, depth "
        f"{STREAM_DEPTH}), {wall:.3f} s wall with the plan and the eval "
        f"({wall / tt1_rounds * 1e3:.3f} ms a round), peak "
        f"{peak} MiB, launches {launches}; first {TT1_CHECK} rounds of every "
        f"lane, kernels vs plain path on the card max rel loss "
        f"{rel_plain:.3g}, vs the cpu {rel_cpu:.3g} (bound {TT1_TOL_LOSS:g})")
    if max(rel_plain, rel_cpu) > TT1_TOL_LOSS:
        raise AssertionError("stream transformer-table1: the kernel path "
                             "disagrees with the plain path")
    out["transformer_table1"] = {
        "lanes": len(cells) * len(TT1_SEEDS), "workers": spec.n_workers,
        "rounds": tt1_rounds, "chunk": TT1_CHUNK, "wall_s": wall,
        "ms_per_round": wall / tt1_rounds * 1e3, "peak_mib": peak,
        "launches": launches, "rel_loss_plain": rel_plain,
        "rel_loss_cpu": rel_cpu,
        "rows": [{k: r[k] for k in ("scenario", "seed", "final_loss",
                                    "acc")} for r in rows]}

    # (5) the host-memory gate on the transformer testbed
    cell = cells[0]
    s = Simulator(tloss, tp0, cell.cfg, device=device)
    try:
        stack_batches(tbatch, gate_rounds, max_bytes=GATE_BYTES)
        raise AssertionError("stream gate: stack_batches did not refuse")
    except ValueError as e:
        refusal = str(e).split(", over the")[0]
    _, gm, info = s.rollout_streaming(s.init(0), tbatch, gate_rounds,
                                      chunk_size=GATE_CHUNK,
                                      prefetch_depth=STREAM_DEPTH)
    ok = (info["rounds_run"] == gate_rounds
          and info["host_high_water_bytes"] <= GATE_BYTES
          and bool(torch.isfinite(gm["loss"]).all()))
    log(f"stream gate ({cell.label}): stack_batches of {gate_rounds} rounds "
        f"under {GATE_BYTES} B refused ({refusal}); rollout_streaming "
        f"(chunk {GATE_CHUNK}, depth {STREAM_DEPTH}) ran "
        f"{info['rounds_run']} rounds, host high water "
        f"{info['host_high_water_bytes']} B")
    if not ok:
        raise AssertionError(f"stream gate: {info}")
    out["gate"] = {"limit_bytes": GATE_BYTES, "rounds": gate_rounds,
                   **{k: info[k] for k in ("rounds_run", "chunk_bytes",
                                           "host_high_water_bytes")}}

    # (6) the cost model's calibration
    source = (f"chip_smoke.py stream phase: costmodel.calibrate, table1 on "
              f"the quadratic (d = 64), {cost_steps} rounds, 4 seeds, "
              f"{card or device}")
    model, probes = CM.calibrate(steps=cost_steps, device=device,
                                 source=source)
    if on_card:
        model.save(str(COST_MODEL_OUT))
    fit = dataclasses.asdict(model)
    # the fit's own plan of the grid it was measured on
    table1 = SW.grid_scenarios(CM.CALIBRATION_ALGOS, CM.CALIBRATION_ATTACKS,
                               CM.CALIBRATION_AGGS, n_honest=10, f=3,
                               ratio=0.1, gamma=0.05)
    programs = SW.plan_grid(table1, cost_model=model, rounds=cost_steps,
                            n_seeds=4).n_programs
    log(f"stream cost model: probes {json.dumps(probes)}; fit "
        f"{json.dumps(fit)}; its plan of the Table-1 grid: {programs} "
        f"bank(s)")
    out["cost_model"] = {"probes": probes, "fit": fit,
                         "table1_programs": programs}
    return out


# ----------------------------------------------------------------------- #
# prefill and greedy decode (repro_torch.launch.serve)
# ----------------------------------------------------------------------- #

DECODE_ARCH = "llama32_vision_11b"  # full width and depth: 40 layers
DECODE_F32_LAYERS = 5   # one group: 4 self-attention layers, 1 cross layer
# Prefill and each decode step against the train-mode forward over the
# same teacher-forced sequence, as max |diff| / max |h|. float32: the plain
# attention in prefill and decode, the float32 flash kernel (on the card)
# in the train-mode forward, all in float32 and summed in other orders
# (decode attention over the cache against the kernel's online softmax,
# matmuls of other row counts); ~1e-6 on the CPU at d_model 512.
DECODE_TOL_F32 = 1e-4
# bfloat16: the train-mode forward takes the flash kernel (P rounded to
# bf16 inside its online softmax) where prefill and decode take the plain
# attention (the normalised probabilities rounded to bf16), and cuBLAS sums
# matmuls of other row counts in other orders: bf16 rounding (2^-9
# relative) through 36-40 layers; 0.017 on the CPU at d_model 512.
DECODE_TOL_BF16 = 5e-2
# the ring at its real window: qwen25_3b under long_500k (window 8,192),
# batch 1, a prompt of 9 query chunks of 1,024, so the ring wraps
RING = ("qwen25_3b", 9216, 16)
# wider coverage, timed: MQA with head dim 256 (the plain attention in
# prefill and decode, the flash kernels in the train-mode forward they are
# held against), tied embeddings and a 256k vocabulary; embedding inputs
# and the one-hot feed; mistral_large_123b at full width cut to 4 layers
DECODE_WIDE = (("gemma_2b", ()), ("musicgen_medium", ()),
               ("mistral_large_123b", ("--n-layers", "4")))
# the audio family's train path: musicgen_medium at full width cut to 2
# layers, seq 4096, 8 workers of one sequence, f = 1
AUDIO_LAYERS, AUDIO_STEPS, AUDIO_CHECK_STEPS = 2, 4, 2


def self_layers(cfg) -> int:
    """Self-attention applications of ``cfg``'s train-mode forward: every
    layer of the attention families but the vlm's cross layers; none in
    the ssm family; the hybrid's shared block once a group."""
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def flash_keys(cfg) -> tuple:
    """The launch counters ``(forward, backward)`` of the flash kernels
    ``cfg``'s train-mode attention takes: the float32 kernels' at model
    dtype float32, the bfloat16 ones' otherwise."""
    return (("flash_fwd_f32", "flash_bwd_f32") if cfg.dtype == "float32"
            else ("flash_fwd", "flash_bwd"))


def flash_layers(cfg, on_card: bool) -> int:
    """Flash forward launches of one train-mode forward, under the counter
    of :func:`flash_keys`: one per self-attention application where the
    kernels take its q, k and v (their own ``refusal``, asked on the card
    about tensors of the config's heads, head dim and dtype, with the zero
    pad; never MLA, whose attention is the plain one in the reference
    too), on the card only."""
    if not on_card or cfg.use_mla:
        return 0
    import torch

    from repro_torch.kernels.flash_attention.flash import refusal
    dt = getattr(torch, cfg.dtype)
    q = torch.zeros((1, 1, cfg.n_heads, cfg.resolved_head_dim), dtype=dt,
                    device="cuda")
    k = torch.zeros((1, 1, cfg.n_kv_heads, cfg.resolved_head_dim),
                    dtype=dt, device="cuda")
    takes = refusal(q, k, k, True, cfg.sliding_window, 0, pad=True) is None
    return self_layers(cfg) if takes else 0


def teacher_forced(torch, cfg, params, prompt: dict, steps: int,
                   max_len=None, full: bool = True,
                   prompt_only: bool = False) -> dict:
    """Prefill ``prompt`` into caches of ``max_len`` positions (default
    prompt + ``steps``), greedy-decode ``steps`` tokens through
    ``forward(mode="decode")`` keeping each step's hidden state, then (with
    ``full``) the train-mode forward over the prompt and the decoded tokens
    (teacher-forced; padded past the end to a whole number of the plain
    attention's 1,024-query chunks, which causality leaves unread). Returns
    the generated tokens, max |diff| / max |h| of the prefill and of each
    step, the flash forward launches of the train-mode forward alone (the
    kernel of the model's dtype, :func:`flash_keys`; ``flash_fwd_other``
    the other dtype's, summed over every train-mode forward), and the
    prefill's and the steps' wall ms (each ends in a synchronise).
    ``prompt_only`` holds the prefill against the train-mode forward over
    the prompt alone instead (``rel_prefill``; its launches
    ``flash_fwd_prompt``): an MoE layer routes the same tokens the same way
    only in groups of the same tokens, so at a capacity that binds that is
    the prefill's counterpart.

    MoE models: the prefill's and the steps' expert choices are recorded
    and the train-mode forwards replay them (``moe.RouteLog``), so that
    both sides route every token alike; the forwards are also run on
    their own choices, and the choices that differ (``flipped``: rows of a
    layer whose k experts differ) and those runs' errors (``free_*``) are
    reported beside."""
    from repro_torch import kernels as K
    from repro_torch.models import cache_init, forward, logits_fn
    from repro_torch.models import moe as MOE
    from repro_torch.models.decode import one_hot

    key = "tokens" if cfg.input_kind == "tokens" else "embeddings"
    b, s = prompt[key].shape[:2]
    dev = prompt[key].device

    def feed(tok):
        return tok if key == "tokens" else one_hot(tok, cfg.d_model)

    def next_tok(h):
        return torch.argmax(logits_fn(params, cfg, h), -1)

    def wall(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        caches = cache_init(cfg, b, max_len or s + steps, device=dev)
        wall(0.0)
        t0 = time.perf_counter()
        with MOE.routes(MOE.RouteLog()) as pre_routes:
            pre, caches, _ = forward(params, cfg, prompt, mode="prefill",
                                     caches=caches)
        toks, hs, step_routes = [next_tok(pre[:, -1:])], [], []
        prefill_ms, step_ms = wall(t0), []
        for i in range(steps):
            t0 = time.perf_counter()
            db = {key: feed(toks[-1])}
            if cfg.family == "vlm":
                db["image_embeddings"] = prompt["image_embeddings"]
            with MOE.routes(MOE.RouteLog()) as log_i:
                h, caches, _ = forward(params, cfg, db, mode="decode",
                                       pos=s + i, caches=caches)
            step_routes.append(log_i.calls)
            hs.append(h[:, 0])
            toks.append(next_tok(h))
            step_ms.append(wall(t0))
        del caches
        out = {"tokens": torch.cat(toks, dim=1), "prefill_ms": prefill_ms,
               "step_ms": step_ms, "rel_steps": [], "flash_fwd": None,
               "flash_fwd_other": 0}
        own = flash_keys(cfg)[0]
        other = next(k for k in ("flash_fwd", "flash_fwd_f32") if k != own)
        finite = all(bool(torch.isfinite(h).all()) for h in [pre] + hs)
        moe = bool(pre_routes.calls)

        def train_forward(batch, replay=None):
            """``(hidden float32, flash launches, choices)``: on the
            replayed choices, or on its own (recorded)."""
            if dev.type == "cuda":
                torch.cuda.synchronize()
            K.reset_launches()
            with MOE.routes(MOE.RouteLog(replay)) as log:
                h, _, _ = forward(params, cfg, batch, mode="train")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = K.launches()
            out["flash_fwd_other"] += launches[other]
            return h.float(), launches[own], log.calls

        def flipped(given, own):
            return sum(int((a.sort(1).values != c.sort(1).values).any(1)
                           .sum()) for a, c in zip(given, own))

        def rel(a, ref, scale):
            return float((a.float() - ref).abs().max()) / scale

        if prompt_only:
            ref, out["flash_fwd_prompt"], _ = train_forward(
                prompt, pre_routes.calls if moe else None)
            scale = float(ref.abs().max())
            out.update(rel_prefill=rel(pre, ref, scale), max_h=scale)
            finite = finite and bool(torch.isfinite(ref).all())
            if moe:
                free, _, own = train_forward(prompt)
                out.update(free_rel_prefill=rel(pre, free, scale),
                           flipped_prefill=flipped(pre_routes.calls, own))
                del free
            del ref
        if full:
            seq = [prompt[key]] + [feed(t) for t in toks[:steps]]
            n = s + steps
            pad = (-n) % 1024 if n > 1024 else 0
            if pad:
                seq.append(torch.zeros_like(seq[-1][:, :1]).expand(
                    *((b, pad) + tuple(seq[-1].shape[2:]))))
            batch = {**prompt, key: torch.cat(seq, dim=1)}
            given = None
            if moe:
                # each MoE layer's choices over the whole sequence, [B, n,
                # k] flattened as the forward flattens its tokens
                given = []
                for j, c in enumerate(pre_routes.calls):
                    k = c.shape[-1]
                    rows = [c.reshape(b, s, k)] + [
                        r[j].reshape(b, 1, k) for r in step_routes]
                    given.append(torch.cat(rows, dim=1).reshape(-1, k))
                if pad:
                    raise ValueError("replayed choices cover no padding")
            ref, out["flash_fwd"], _ = train_forward(batch, given)
            ref = ref[:, :n]
            scale = float(ref.abs().max())
            if not prompt_only:
                out.update(rel_prefill=rel(pre, ref[:, :s], scale),
                           max_h=scale)
            out["rel_steps"] = [rel(h, ref[:, s + i], scale)
                                for i, h in enumerate(hs)]
            finite = finite and bool(torch.isfinite(ref).all())
            if moe:
                free, _, own = train_forward(batch)
                free = free[:, :n]
                out.update(free_rel_steps=[rel(h, free[:, s + i], scale)
                                           for i, h in enumerate(hs)],
                           flipped_full=flipped(given, own))
                if not prompt_only:
                    out["free_rel_prefill"] = rel(pre, free[:, :s], scale)
                del free
    out["finite"] = finite
    return out


def serve_case(torch, label: str, argv: list, tol: float,
               on_card: bool) -> dict:
    """``launch.serve.run(argv)`` with the launch counts read around it
    (the plain attention: no kernel), its times and peak memory; then its
    tokens held against :func:`teacher_forced` on the same parameters and
    prompts, within ``tol`` of max |h|."""
    from repro_torch import kernels as K
    from repro_torch.launch import serve
    from repro_torch.utils.tree import tree_leaves

    K.reset_launches()
    res = serve.run(argv, log=log)
    launches = {k: v for k, v in K.launches().items() if v}
    cfg = res["cfg"]
    steps = res["tokens"].shape[1] - 1
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "batch": res["tokens"].shape[0],
           "prompt": next(iter(res["batch"].values())).shape[1],
           "tokens": res["tokens"].shape[1],
           **{k: res[k] for k in ("prefill_ms", "decode_ms",
                                  "decode_ms_per_step", "tokens_per_s",
                                  "peak_mib")}, "serve_launches": launches}
    n_params = sum(t.numel() for t in tree_leaves(res["params"]))
    rec["params"] = n_params
    del res["caches"]
    # the same caches' length as the run's, so the same kernels: its
    # greedy tokens again, bit for bit
    chk = teacher_forced(torch, cfg, res["params"], res["batch"], steps,
                         max_len=rec["prompt"] + rec["tokens"])
    same = torch.equal(chk["tokens"], res["tokens"][:, :steps + 1])
    want_flash = flash_layers(cfg, on_card)
    rec.update(rel_prefill=chk["rel_prefill"], rel_steps=chk["rel_steps"],
               max_h=chk["max_h"], check_flash_fwd=chk["flash_fwd"],
               tokens_reproduced=same, tol=tol,
               warm_prefill_ms=chk["prefill_ms"],
               warm_step_ms=chk["step_ms"])
    log(f"decode {label}: {cfg.name} layers={cfg.n_layers} d_model="
        f"{cfg.d_model} dtype={cfg.dtype} params={n_params:,}; prefill "
        f"{rec['prefill_ms']:.3f} ms, {rec['decode_ms_per_step']} ms a "
        f"decode step, {rec['tokens_per_s']} tokens/s, peak "
        f"{rec['peak_mib']} MiB, launches {launches}; against the train-mode "
        f"forward: prefill {chk['rel_prefill']:.3g}, steps "
        f"{', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of max|h| "
        f"{chk['max_h']:.4g} (bar {tol:g}), flash forward launches "
        f"{chk['flash_fwd']} (expected {want_flash}), tokens reproduced "
        f"{same}; again: prefill {chk['prefill_ms']:.3f} ms, steps "
        f"{', '.join(f'{v:.3f}' for v in chk['step_ms'])} ms")
    bad = max([chk["rel_prefill"]] + chk["rel_steps"]) > tol
    if launches or not chk["finite"] or not same or bad or \
            chk["flash_fwd"] != want_flash or chk["flash_fwd_other"]:
        raise AssertionError(f"decode {label}: {rec}")
    del res, chk
    return rec


def decode_profile(torch, arch: str, steps: int = 3, extra=()) -> dict:
    """A profiled window of ``steps`` greedy decode steps of ``arch`` at the
    serving launcher's defaults on the card (``extra``: more launcher
    flags), after a prefill, one warm-up step and ``steps`` unprofiled
    steps timed on the host clock: the device's busy time a step, and its
    idle share both against the profiled window's wall time (which the
    profiler lengthens) and against the unprofiled steps' time."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.models import (cache_init, forward, logits_fn,
                                    make_decode_step, model_init)

    args = serve.parse_args(["--arch", arch, *extra])
    dev = torch.device("cuda")
    cfg = serve.model_config(args, dev)
    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in serve.make_prompt(
        cfg, args.batch, args.prompt_len, np.random.default_rng(0)).items()}
    s = args.prompt_len
    caches = cache_init(cfg, args.batch, s + 2 * steps + 1, device=dev)
    with torch.no_grad():
        h, caches, _ = forward(params, cfg, prompt, mode="prefill",
                               caches=caches)
        tok = torch.argmax(logits_fn(params, cfg, h[:, -1:]), -1)
    step = make_decode_step(cfg, prompt.get("image_embeddings"))
    box = [tok, caches]

    def one(i):
        box[0], box[1] = step(params, box[0], box[1], s + i)

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        one(1 + i)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    out = profile_window(torch, lambda i: one(1 + steps + i), steps,
                         f"decode {arch}")
    out["unprofiled_ms_per_round"] = plain_ms
    out["idle_share_unprofiled"] = 1.0 - min(
        1.0, out["device_busy_ms_per_round"] / plain_ms)
    log(f"decode {arch}: {plain_ms:.3f} ms a step unprofiled, just before "
        f"the window; device busy {out['device_busy_ms_per_round']:.3f} ms "
        f"of it: idle share {out['idle_share_unprofiled']:.3f} (the "
        f"profiled window's {out['idle_share']:.3f} counts the profiler's "
        f"own cost)")
    del params, prompt, box
    torch.cuda.empty_cache()
    return out


def decode_profiles(torch, cases) -> dict:
    """:func:`decode_profile` of each ``(arch, extra flags)``, last in a
    process: the profiler slows the launches that follow it."""
    return {arch: decode_profile(torch, arch, extra=extra)
            for arch, extra in cases}


DECODE_PROFILED = ((DECODE_ARCH, ()), ("musicgen_medium", ()))


def decode_phase(torch, device: str = "cuda", profile: bool = True) -> dict:
    """Prefill and greedy decode through ``repro_torch.launch.serve`` (the
    reference's defaults: batch 4, prompt 32, 8 tokens): (1) llama32_vision_11b
    at full width and depth in bfloat16, timed, each step against the
    train-mode forward (the flash kernel, one launch a self-attention
    layer); (2) the same at full width cut to one group in float32 (the
    float32 flash kernel in its train-mode forward); (3) the
    ring at its real window (qwen25_3b, long_500k's 8,192, a 9,216-token
    prompt, 16 steps); (4) gemma_2b, musicgen_medium and mistral_large_123b
    (4 layers), timed and self-consistent; (5) the audio family's train
    path through ``launch.train`` (musicgen_medium, 2 layers), its launch
    counts and first steps against the plain path; (6) profiled decode
    steps of llama32_vision_11b and musicgen_medium (the card only; with
    ``profile=False`` the caller takes them later). On the CPU (rehearsal)
    every model is the launchers' reduced one."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.configs.base import ArchSpec, model_for_shape
    from repro_torch.launch import serve, train
    from repro_torch.models import model_init

    on_card = device == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    t_phase = time.perf_counter()
    out = {}

    def done():
        if on_card:
            torch.cuda.empty_cache()

    # (1) full width and depth, bfloat16
    out["vlm_bf16"] = serve_case(torch, "vlm bf16", ["--arch", DECODE_ARCH] +
                                 dev_args, DECODE_TOL_BF16, on_card)
    done()
    # (2) float32 at full width, one group with its cross layer
    args = serve.parse_args(["--arch", DECODE_ARCH, "--n-layers",
                            str(DECODE_F32_LAYERS)] + dev_args)
    dev = torch.device(device)
    cfg = serve.model_config(args, dev).with_overrides(dtype="float32")
    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in serve.make_prompt(
        cfg, args.batch, args.prompt_len, np.random.default_rng(0)).items()}
    chk = teacher_forced(torch, cfg, params, prompt, args.tokens - 1)
    # the train-mode forward takes the float32 flash kernel once a
    # self-attention layer (4 of the group's 5)
    want = flash_layers(cfg, on_card)
    log(f"decode vlm f32: {cfg.name} layers={cfg.n_layers} d_model="
        f"{cfg.d_model}: against the train-mode forward prefill "
        f"{chk['rel_prefill']:.3g}, steps "
        f"{', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of max|h| "
        f"{chk['max_h']:.4g} (bar {DECODE_TOL_F32:g}), float32 flash "
        f"forward launches {chk['flash_fwd']} (expected {want}), bf16 "
        f"{chk['flash_fwd_other']}")
    if not chk["finite"] or max([chk["rel_prefill"]] + chk["rel_steps"]) \
            > DECODE_TOL_F32 or chk["flash_fwd"] != want or \
            chk["flash_fwd_other"]:
        raise AssertionError(f"decode vlm f32: {chk}")
    out["vlm_f32"] = {"layers": cfg.n_layers, "tol": DECODE_TOL_F32,
                      "check_flash_fwd_f32": chk["flash_fwd"],
                      **{k: chk[k] for k in ("rel_prefill", "rel_steps",
                                             "max_h")}}
    del params, prompt, chk
    done()

    # (3) the ring buffer at the long-context window, wrapped by the prompt
    ring_arch, ring_prompt, ring_steps = RING
    args = serve.parse_args(["--arch", ring_arch] + dev_args)
    base = serve.model_config(args, dev)
    cfg = model_for_shape(ArchSpec(model=base, citation=""),
                          INPUT_SHAPES["long_500k"])
    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in serve.make_prompt(
        cfg, 1, ring_prompt, np.random.default_rng(0)).items()}
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    chk = teacher_forced(torch, cfg, params, prompt, ring_steps)
    ring_s = time.perf_counter() - t0
    want = flash_layers(cfg, on_card)
    log(f"decode ring: {cfg.name} layers={cfg.n_layers} window="
        f"{cfg.sliding_window} prompt={ring_prompt} (wraps: "
        f"{ring_prompt > cfg.sliding_window}) steps={ring_steps}: against "
        f"the windowed train-mode forward prefill {chk['rel_prefill']:.3g}, "
        f"steps {', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of "
        f"max|h| {chk['max_h']:.4g} (bar {DECODE_TOL_BF16:g}), flash forward "
        f"launches {chk['flash_fwd']} (expected {want}), {ring_s:.2f} s with "
        f"the check; prefill {chk['prefill_ms']:.3f} ms, steps "
        f"{', '.join(f'{v:.3f}' for v in chk['step_ms'])} ms")
    if not chk["finite"] or max([chk["rel_prefill"]] + chk["rel_steps"]) \
            > DECODE_TOL_BF16 or chk["flash_fwd"] != want or \
            chk["flash_fwd_other"] or \
            ring_prompt <= cfg.sliding_window:
        raise AssertionError(f"decode ring: {chk}")
    out["ring"] = {"arch": cfg.name, "layers": cfg.n_layers,
                   "window": cfg.sliding_window, "prompt": ring_prompt,
                   "steps": ring_steps, "tol": DECODE_TOL_BF16,
                   "check_flash_fwd": chk["flash_fwd"], "wall_s": ring_s,
                   **{k: chk[k] for k in ("rel_prefill", "rel_steps",
                                          "max_h", "prefill_ms",
                                          "step_ms")}}
    del params, prompt, chk
    done()

    # (4) wider coverage
    for name, extra in DECODE_WIDE:
        out[name] = serve_case(torch, name, ["--arch", name, *extra] +
                               dev_args, DECODE_TOL_BF16, on_card)
        done()

    # (5) the audio family's train path on the kernels
    argv = ["--arch", "musicgen_medium", "--n-layers", str(AUDIO_LAYERS),
            "--n-workers", str(LLM_WORKERS), "--global-batch",
            str(LLM_WORKERS), "--f", "1", "--ratio", "0.05", "--gamma",
            str(LLM_GAMMA), "--seed", "0"] + dev_args
    K.reset_launches()
    res = train.run(argv + ["--steps", str(AUDIO_STEPS)], log=log)
    launches = K.launches()
    plan = res["plan"]
    check_launches("decode audio train", launches, llm_launches(
        plan.model, plan, AUDIO_STEPS, on_card, block_compress=compressions,
        block_decompress=0, momentum_scatter=payload_slices))
    losses, norms = res["losses"], res["dir_norms"]
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"decode audio train: non-finite {losses}")
    peak = (res["peak_bytes"] / 2**20 if res["peak_bytes"] is not None
            else None)
    step_ms = res["step_ms"]
    del res
    done()
    plain = train.run(argv + ["--steps", str(AUDIO_CHECK_STEPS)], plain=True,
                      log=log)
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    rel_r = max(abs(a - b) / abs(b) for a, b in zip(norms,
                                                   plain["dir_norms"]))
    log(f"decode audio train: musicgen_medium layers={plan.model.n_layers} "
        f"D={plan.flat_spec.padded_size:,} seq={plan.shape.seq_len} "
        f"n={plan.n_workers}: losses {losses}, |R| {norms}, wall ms "
        f"{', '.join(f'{v:.3f}' for v in step_ms)}, peak {peak} MiB, "
        f"launches {launches}; kernel vs plain over {AUDIO_CHECK_STEPS} "
        f"steps: "
        f"loss max rel {rel_l:.3g} (bound {LLM_TOL_LOSS:g}), |R| max rel "
        f"{rel_r:.3g} (bound {LLM_TOL_DIR:g})")
    if rel_l > LLM_TOL_LOSS or rel_r > LLM_TOL_DIR:
        raise AssertionError("decode audio train: kernel and plain paths "
                             "disagree")
    out["audio_train"] = {
        "layers": plan.model.n_layers, "D": plan.flat_spec.padded_size,
        "seq": plan.shape.seq_len, "workers": plan.n_workers,
        "steps": AUDIO_STEPS, "losses": losses, "dir_norms": norms,
        "step_ms": step_ms, "peak_mib": peak, "launches": launches,
        "plain_rel_loss": rel_l, "plain_rel_dir": rel_r}
    del plain
    done()
    # (6) where a decode step's time goes, last: the profiler slows the
    # launches that follow it in its process (the full run takes them
    # after the families phase)
    if on_card and profile:
        out["profile"] = decode_profiles(torch, DECODE_PROFILED)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"decode: phase wall {out['wall_s']:.1f} s")
    return out


# ----------------------------------------------------------------------- #
# the MoE, MLA, SSM and hybrid families, served and trained
# ----------------------------------------------------------------------- #

# served at the launcher's defaults (batch 4, prompt 32, 8 tokens), bf16:
# dbrx_132b at full width cut to 4 layers (40 hold ~490 GiB of float32
# masters), the others at full width and depth
FAMILY_SERVE = (("dbrx_132b", ("--n-layers", "4")),
                ("deepseek_v2_lite_16b", ()), ("mamba2_1_3b", ()),
                ("zamba2_7b", ()))
# cuts at full width, (arch, layers, dtype): deepseek_v2_lite_16b's dense
# layer and one MoE layer in float32; zamba2_7b's first group and one
# trailing mamba2 block in float32 and in bfloat16; zamba2_7b at full depth
# in float32 (its bfloat16 run at full depth is held to its floor, below)
FAMILY_CUTS = (("deepseek_v2_lite_16b", 2, "float32"),
               ("zamba2_7b", 7, "float32"), ("zamba2_7b", 7, "bfloat16"),
               ("zamba2_7b", 81, "float32"))
# Served at full depth in bfloat16 and held to its own rounding floor, not
# to DECODE_TOL_BF16: at zamba2_7b's 81 layers a bfloat16 rounding
# difference anywhere grows to ~5% of max |h| by the last layer. The floor
# is measured in the same call on the served model: its prefill against the
# train-mode forward over prompt + tokens, both on the plain attention (the
# same algorithm over the first 32 positions, differing only in the
# matrices' row counts). The prefill and every decode step against the
# train-mode forward (on the flash kernels) must stay within
# FAMILY_FLOOR_FACTOR times that floor, and the floor itself within
# FAMILY_FLOOR_MAX of max |h|, so that a broken plain path cannot raise its
# own bar. On an H100 80GB HBM3 at 700 W the floor read 0.0536 and the
# gaps 0.036-0.062, at most 1.16 times the floor (``python3 chip_smoke.py
# floor``, and the families phase; PERF.md). The float32 model at full
# depth and the bfloat16 one cut to 7 layers hold the same checks to their
# bars.
FAMILY_BF16_FLOOR = ("zamba2_7b",)
FAMILY_FLOOR_FACTOR = 1.5
FAMILY_FLOOR_MAX = 0.1
# The bfloat16 models at full depth whose served gap grows with depth
# (mamba2_1_3b: 48 layers, zamba2_7b: 81 and its shared attention block's
# applications): each block's output in prefill and decode against the
# same block's in the train-mode forward, in units of that block's
# max |h| (:func:`layer_gaps`), logged; the bars above stay the checks.
FAMILY_LAYER_GAPS = ("mamba2_1_3b", "zamba2_7b")
# mamba2_1_3b through a long prompt: 16 whole chunks of 256 and a padded
# 17th (the chunk recurrence, the pad, the conv state), then 16 steps
FAMILY_LONG = ("mamba2_1_3b", 4100, 16)
# the train paths: (arch, layers, bank dtype), full width, seq 4096, 8
# workers, f = 1, ALIE, CWTM, global Block-RandK 0.05, the streamed step
# (each worker's row compressed as its gradient exists: no [n, D] gradient
# bank); bfloat16 banks at D ~ 1e9, where two float32 [8, D] banks would
# fill 66 GB; gemma_2b's (D = 744,499,200) takes the flash kernels at head
# dim 256 (MQA); the vlm's (VLM_BANK: 5 layers, the first with a cross
# layer) at float8 banks and at the reference's bfloat16 ones, its payload
# round 128 windows a step; qwen25_3b's (D = 776,485,888; QKV bias, 16
# query heads on 2 KV heads, an untied 151,936-row head) at bfloat16 banks;
# mistral_large_123b's one 12288-wide layer (D = 2,189,463,552; 96 query
# heads on 8) at float8 banks, 131 windows a step; dbrx_132b's one layer
# (DBRX_BANK: D = 4,492,216,320; 16 experts of 10752, top 4; 48 query heads
# on 8) at float8 banks, 268 windows a step
FAMILY_TRAIN = (("deepseek_v2_lite_16b", 2, "bfloat16"),
                ("mamba2_1_3b", 2, "float32"),
                ("zamba2_7b", 6, "bfloat16"),
                ("gemma_2b", 2, "bfloat16"),
                (VLM_BANK[0], 5, VLM_BANK[2]),
                ("qwen25_3b", 2, "bfloat16"),
                ("mistral_large_123b", 1, "float8_e4m3fn"),
                (DBRX_BANK[0], 1, DBRX_BANK[2]),
                (VLM_BANK[0], 5, "bfloat16"))
FAMILY_STEPS, FAMILY_CHECK_STEPS = 4, 2


@contextlib.contextmanager
def layer_outputs():
    """Record every block's output by the forward's mode while the context
    is open: ``{"prefill" | "decode" | "train": [(kind, float32 [B, S,
    D])]}`` in call order (``kind`` "attn" or "ssm"), by wrapping the
    decoder stack's block functions."""
    from repro_torch.models import transformer as TR
    rec = {"prefill": [], "decode": [], "train": []}
    names = {"_attn_block_apply": "attn", "_ssm_block_apply": "ssm"}
    orig = {n: getattr(TR, n) for n in names}

    def wrap(name):
        def block(*args, **kw):
            out = orig[name](*args, **kw)
            x = out[0] if isinstance(out, tuple) else out
            rec[kw["mode"]].append((names[name], x.detach().float()))
            return out
        return block
    try:
        for n in names:
            setattr(TR, n, wrap(n))
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(TR, n, fn)


def layer_gaps(rec: dict, prompt: int, steps: int) -> dict:
    """Per block of :func:`layer_outputs`'s record of one
    :func:`teacher_forced` check: the served output (the prefill's
    positions, then each decode step's) against the train-mode forward's
    over the same ``prompt + steps`` positions, as max|diff| / max|train|
    of that block. Returns ``{"kinds", "gaps"}``."""
    import torch
    pre, dec, train = rec["prefill"], rec["decode"], rec["train"]
    n = len(pre)
    if len(train) != n or len(dec) != n * steps:
        raise ValueError(f"layer_gaps: {n} prefill, {len(dec)} decode, "
                         f"{len(train)} train block outputs for {steps} "
                         f"steps")
    gaps = []
    for j in range(n):
        served = torch.cat([pre[j][1]] + [dec[i * n + j][1]
                                          for i in range(steps)], dim=1)
        ref = train[j][1][:, :prompt + steps]
        gaps.append(float((served - ref).abs().max() / ref.abs().max()))
    return {"kinds": [kind for kind, _ in pre], "gaps": gaps}


def family_serve_case(torch, arch: str, extra, dev_args: list,
                      on_card: bool) -> tuple:
    """``launch.serve.run`` of ``arch`` (the plain attention: no kernel
    launches), its times and peak memory, then the checks against the
    train-mode forward. An MoE layer's capacity depends on the group's
    token count, so where it binds (the configs' factor 1.25) the prefill
    routes as the train-mode forward over the prompt alone does, and is
    held against that; the greedy tokens are reproduced at 1.25; each
    decode step (4 tokens: never over capacity, which is at least k) is
    held against the teacher-forced forward at a factor of E/k, where no
    group drops a choice, with its prefill. A bfloat16 model of
    :data:`FAMILY_BF16_FLOOR` is held to :data:`FAMILY_FLOOR_FACTOR` times
    its floor measured here (see there) in place of DECODE_TOL_BF16.
    Returns the record and the session (parameters, prompt)."""
    from repro_torch import kernels as K
    from repro_torch.launch import serve
    from repro_torch.utils.tree import tree_leaves

    K.reset_launches()
    res = serve.run(["--arch", arch, *extra] + dev_args, log=log)
    launches = {k: v for k, v in K.launches().items() if v}
    cfg = res["cfg"]
    b, n_tok = res["tokens"].shape
    steps = n_tok - 1
    s = next(iter(res["batch"].values())).shape[1]
    rec = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "batch": b,
           "prompt": s, "tokens": n_tok,
           "params": sum(t.numel() for t in tree_leaves(res["params"])),
           **{k: res[k] for k in ("prefill_ms", "decode_ms",
                                  "decode_ms_per_step", "tokens_per_s",
                                  "peak_mib")}, "serve_launches": launches}
    del res["caches"]
    moe = cfg.family == "moe"
    per_layer = arch in FAMILY_LAYER_GAPS and cfg.dtype == "bfloat16"
    with (layer_outputs() if per_layer else contextlib.nullcontext()) as lo:
        chk = teacher_forced(torch, cfg, res["params"], res["batch"], steps,
                             max_len=s + n_tok, full=not moe,
                             prompt_only=moe)
    if per_layer:
        rec["layer_gaps"] = layer_gaps(lo, s, steps)
        gaps = rec["layer_gaps"]["gaps"]
        # the largest step from one block to the next against the median
        # step: a block whose gap jumps where the others grow smoothly
        rises = sorted(b_ - a for a, b_ in zip(gaps, gaps[1:]))
        rec["layer_gaps"]["max_rise"] = rises[-1] if rises else 0.0
        rec["layer_gaps"]["median_rise"] = (rises[len(rises) // 2]
                                            if rises else 0.0)
        log(f"families {cfg.name}: per block against the train-mode "
            f"forward, of each block's max|h| ({len(gaps)} blocks, "
            f"{rec['layer_gaps']['kinds'].count('attn')} attention): "
            + ", ".join(f"{g:.3g}" for g in gaps)
            + f"; largest rise {rec['layer_gaps']['max_rise']:.3g}, "
            f"median rise {rec['layer_gaps']['median_rise']:.3g}")
        del lo
    same = torch.equal(chk["tokens"], res["tokens"][:, :steps + 1])
    rec.update(rel_prefill=chk["rel_prefill"], max_h=chk["max_h"],
               tokens_reproduced=same, warm_prefill_ms=chk["prefill_ms"],
               warm_step_ms=chk["step_ms"])
    finite = chk["finite"]
    if moe:
        cap = cfg.n_experts / cfg.top_k
        rec.update(check_flash_fwd_prompt=chk["flash_fwd_prompt"],
                   flipped_prefill_125=chk["flipped_prefill"],
                   free_rel_prefill_125=chk["free_rel_prefill"])
        chk = teacher_forced(torch, cfg.with_overrides(capacity_factor=cap),
                             res["params"], res["batch"], steps,
                             max_len=s + n_tok)
        rec.update(capacity_factor_steps=cap,
                   rel_prefill_unbound=chk["rel_prefill"])
        finite = finite and chk["finite"]
    floor = None
    if arch in FAMILY_BF16_FLOOR and cfg.dtype == "bfloat16":
        floor = teacher_forced(
            torch, cfg.with_overrides(use_flash_attention=False),
            res["params"], res["batch"], steps,
            max_len=s + n_tok)["rel_prefill"]
    bar = DECODE_TOL_BF16 if floor is None else FAMILY_FLOOR_FACTOR * floor
    rec.update(rel_steps=chk["rel_steps"], check_flash_fwd=chk["flash_fwd"],
               tol=bar, floor=floor)
    want_flash = flash_layers(cfg, on_card)
    rels = [rec["rel_prefill"]] + chk["rel_steps"] + (
        [rec["rel_prefill_unbound"]] if moe else [])
    if moe:
        rec.update(flipped_prefill=rec.pop("flipped_prefill_125"),
                   free_rel_prefill=rec.pop("free_rel_prefill_125"),
                   flipped_full=chk["flipped_full"],
                   free_rel_steps=chk["free_rel_steps"])
        log(f"families {cfg.name}: on their own choices the train-mode "
            f"forwards route {rec['flipped_prefill']} (prompt) and "
            f"{rec['flipped_full']} (teacher-forced) token-layers to "
            f"other experts than prefill and decode did: prefill "
            f"{rec['free_rel_prefill']:.3g}, steps "
            f"{', '.join(f'{v:.3g}' for v in rec['free_rel_steps'])} of "
            f"max|h| (not held to the bar; the checks replay the choices)")
    log(f"families {cfg.name}: layers={cfg.n_layers} d_model={cfg.d_model} "
        f"dtype={cfg.dtype} params={rec['params']:,}; prefill "
        f"{rec['prefill_ms']:.3f} ms, {rec['decode_ms_per_step']} ms a "
        f"decode step, {rec['tokens_per_s']} tokens/s, peak "
        f"{rec['peak_mib']} MiB, launches {launches}; against the train-mode "
        f"forward: prefill {rec['rel_prefill']:.3g}"
        + (f" (over the prompt alone; at capacity factor {cap:g} "
           f"{rec['rel_prefill_unbound']:.3g})" if moe else "")
        + f", steps {', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of "
        f"max|h| {rec['max_h']:.4g} ("
        + (f"bar {DECODE_TOL_BF16:g}" if floor is None else
           f"bar {FAMILY_FLOOR_FACTOR:g} x the floor {floor:.4g} = "
           f"{bar:.4g}, the floor's own bar {FAMILY_FLOOR_MAX:g}; worst "
           f"gap {max(rels) / max(floor, 1e-30):.3f} x the floor")
        + f"), flash "
        f"forward launches {chk['flash_fwd']} (expected {want_flash}), "
        f"tokens reproduced {same}")
    if launches or not finite or not same or max(rels) > bar or \
            (floor is not None and floor > FAMILY_FLOOR_MAX) or \
            chk["flash_fwd"] != want_flash or chk["flash_fwd_other"] \
            or (moe and rec["check_flash_fwd_prompt"] != want_flash):
        raise AssertionError(f"families {cfg.name}: {rec}")
    session = {"cfg": cfg, "params": res["params"]}
    del res, chk
    return rec, session


def family_cut_case(torch, arch: str, layers: int, dtype: str,
                    dev_args: list, on_card: bool) -> dict:
    """The arch at full width cut to ``layers`` in ``dtype``: the prefill
    and each decode step against the teacher-forced train-mode forward
    within 1e-4 (float32) or 5e-2 (bfloat16) of max |h| (MoE at a capacity
    factor of E/k, where nothing drops, the choices replayed), with the
    flash forward launches of a bfloat16 train-mode forward."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.models import model_init

    args = serve.parse_args(["--arch", arch, "--n-layers", str(layers)]
                            + dev_args)
    dev = torch.device("cuda" if on_card else "cpu")
    cfg = serve.model_config(args, dev).with_overrides(dtype=dtype)
    if cfg.family == "moe":
        cfg = cfg.with_overrides(capacity_factor=cfg.n_experts / cfg.top_k)
    tol = DECODE_TOL_F32 if dtype == "float32" else DECODE_TOL_BF16
    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0))
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in serve.make_prompt(
        cfg, args.batch, args.prompt_len, np.random.default_rng(0)).items()}
    chk = teacher_forced(torch, cfg, params, prompt, args.tokens - 1)
    want = flash_layers(cfg, on_card)
    log(f"families {cfg.name} {dtype}: layers={cfg.n_layers} d_model="
        f"{cfg.d_model}: against the train-mode forward prefill "
        f"{chk['rel_prefill']:.3g}, steps "
        f"{', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of max|h| "
        f"{chk['max_h']:.4g} (bar {tol:g}), flash forward launches "
        f"{chk['flash_fwd']} (expected {want})")
    if not chk["finite"] or max([chk["rel_prefill"]] + chk["rel_steps"]) \
            > tol or chk["flash_fwd"] != want or chk["flash_fwd_other"]:
        raise AssertionError(f"families {cfg.name} {dtype} {layers}: {chk}")
    del params, prompt
    return {"arch": cfg.name, "layers": cfg.n_layers, "dtype": dtype,
            "tol": tol, "check_flash_fwd": chk["flash_fwd"],
            **{k: chk[k] for k in ("rel_prefill", "rel_steps", "max_h")}}


def train_key(arch: str, mdt: str) -> str:
    """The families phase's key of a :data:`FAMILY_TRAIN` path: the arch,
    and its bank dtype where the arch has more than one path."""
    dtypes = [m for a, _, m in FAMILY_TRAIN if a == arch]
    return arch if len(dtypes) == 1 else f"{arch}/{mdt}"


def family_train_case(torch, arch: str, layers: int, mdt: str,
                      dev_args: list, on_card: bool) -> dict:
    """``launch.train`` on ``arch`` at full width cut to ``layers`` (the
    payload route, streamed: compress once a worker (:func:`compressions`),
    ``momentum_scatter`` and CWTM once a window of its round
    (:func:`payload_slices`), no decompress; the flash kernels once a
    self-attention application and worker), ``FAMILY_STEPS`` steps with
    finite losses, its peak and held MiB beside the dry run's reckoning of
    the same cut (``launch.dryrun.run_one``: the step's floor and the held
    state), then its first ``FAMILY_CHECK_STEPS`` against the plain
    path."""
    from repro_torch import kernels as K
    from repro_torch.launch import dryrun, train

    argv = ["--arch", arch, "--n-layers", str(layers), "--n-workers",
            str(LLM_WORKERS), "--global-batch", str(LLM_WORKERS), "--f", "1",
            "--ratio", "0.05", "--gamma", str(LLM_GAMMA), "--seed", "0",
            "--momentum-dtype", mdt] + dev_args
    label = f"families train {arch}"
    K.reset_launches()
    res = train.run(argv + ["--steps", str(FAMILY_STEPS)], log=log)
    launches = K.launches()
    plan = res["plan"]
    check_launches(label, launches, llm_launches(
        plan.model, plan, FAMILY_STEPS, on_card, block_compress=compressions,
        block_decompress=0, momentum_scatter=payload_slices))
    losses, norms = res["losses"], res["dir_norms"]
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{label}: non-finite {losses} {norms}")
    peak = (res["peak_bytes"] / 2**20 if res["peak_bytes"] is not None
            else None)
    held = (res["held_bytes"] / 2**20 if res["held_bytes"] is not None
            else None)
    step_ms = res["step_ms"]
    bank = str(res["state"].server.momentum.dtype).split(".")[-1]
    del res
    if on_card:
        torch.cuda.empty_cache()
    # the dry run of the card's cut (full width: on the CPU the run above
    # is the reduced model, so the two are not comparable there)
    rep = dryrun.run_one(arch, "train_4k", n_layers=layers,
                         n_workers=LLM_WORKERS, global_batch=LLM_WORKERS,
                         ratio=0.05, momentum_dtype=mdt, verbose=False)
    pred = {"step_floor_mib": rep["state_bytes_total"] / 2**20,
            "held_mib": rep["held_bytes"] / 2**20,
            "streamed": rep["streamed"]}
    log(f"{label}: peak {peak} MiB, held {held} MiB; dry run (the card's "
        f"cut, {'streamed' if rep['streamed'] else 'bank'} step): floor "
        f"{pred['step_floor_mib']:.1f} MiB, held {pred['held_mib']:.1f} "
        f"MiB, fits {rep['state_fits']}")
    plain = train.run(argv + ["--steps", str(FAMILY_CHECK_STEPS)],
                      plain=True, log=log)
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                   plain["losses"]))
    rel_r = max(abs(a - b) / abs(b) for a, b in zip(norms,
                                                   plain["dir_norms"]))
    plain_ms, plain_peak = plain["step_ms"], plain["peak_bytes"]
    del plain
    if on_card:
        torch.cuda.empty_cache()
    log(f"{label}: layers={plan.model.n_layers} D="
        f"{plan.flat_spec.padded_size:,} bank width {plan.bank_width:,} "
        f"({bank}, {payload_slices(plan)} windows a payload round) seq="
        f"{plan.shape.seq_len} n={plan.n_workers}: losses "
        f"{losses}, |R| {norms}, wall ms "
        f"{', '.join(f'{v:.3f}' for v in step_ms)}, peak {peak} MiB, "
        f"launches {launches}; kernel vs plain over {FAMILY_CHECK_STEPS} "
        f"steps: loss max rel {rel_l:.3g} (bound {LLM_TOL_LOSS:g}), |R| max "
        f"rel {rel_r:.3g} (bound {LLM_TOL_DIR:g}); plain steps "
        f"{', '.join(f'{v:.3f}' for v in plain_ms)} ms")
    if rel_l > LLM_TOL_LOSS or rel_r > LLM_TOL_DIR or bank != mdt:
        raise AssertionError(f"{label}: kernel and plain paths disagree")
    return {"arch": arch, "layers": plan.model.n_layers,
            "slices": payload_slices(plan),
            "D": plan.flat_spec.padded_size, "bank_width": plan.bank_width,
            "bank_dtype": bank, "seq": plan.shape.seq_len,
            "workers": plan.n_workers, "steps": FAMILY_STEPS,
            "losses": losses, "dir_norms": norms, "step_ms": step_ms,
            "peak_mib": peak, "held_mib": held, "launches": launches,
            "dryrun": pred, "plain_rel_loss": rel_l,
            "plain_rel_dir": rel_r, "plain_step_ms": plain_ms,
            "plain_peak_mib": (plain_peak / 2**20 if plain_peak is not None
                               else None)}


def families_phase(torch, device: str = "cuda") -> dict:
    """The MoE, MLA, SSM and hybrid families through the launchers: (a)-(d)
    dbrx_132b (4 layers), deepseek_v2_lite_16b, mamba2_1_3b and zamba2_7b
    (full depth) served in bfloat16 (:func:`family_serve_case`), the cuts
    of :data:`FAMILY_CUTS` (:func:`family_cut_case`), mamba2_1_3b through a
    4,100-token prompt and 16 steps; (e) the train paths of
    :data:`FAMILY_TRAIN` (:func:`family_train_case`). The decode steps'
    profiles are taken later (:data:`FAMILY_PROFILED`). On the CPU
    (rehearsal) every model is the launchers' reduced one."""
    import numpy as np

    from repro_torch.launch import serve

    on_card = device == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    t_phase = time.perf_counter()
    out = {"serve": {}, "cuts": {}, "train": {}}

    def done():
        if on_card:
            torch.cuda.empty_cache()

    for arch, extra in FAMILY_SERVE:
        rec, session = family_serve_case(torch, arch, extra, dev_args,
                                         on_card)
        out["serve"][arch] = rec
        if arch == FAMILY_LONG[0]:
            _, n_prompt, n_steps = FAMILY_LONG
            cfg = session["cfg"]
            prompt = {k: torch.from_numpy(v).to(device) for k, v in
                      serve.make_prompt(cfg, 1, n_prompt,
                                        np.random.default_rng(0)).items()}
            t0 = time.perf_counter()
            chk = teacher_forced(torch, cfg, session["params"], prompt,
                                 n_steps)
            wall = time.perf_counter() - t0
            chunks = -(-n_prompt // min(cfg.ssm_chunk, n_prompt))
            log(f"families {cfg.name} long prompt: {n_prompt} tokens "
                f"({chunks} chunks of {cfg.ssm_chunk}, the last padded), "
                f"{n_steps} steps: against the train-mode forward prefill "
                f"{chk['rel_prefill']:.3g}, steps "
                f"{', '.join(f'{v:.3g}' for v in chk['rel_steps'])} of "
                f"max|h| {chk['max_h']:.4g} (bar {DECODE_TOL_BF16:g}); "
                f"prefill {chk['prefill_ms']:.3f} ms, steps "
                f"{', '.join(f'{v:.3f}' for v in chk['step_ms'])} ms, "
                f"{wall:.2f} s with the check")
            if not chk["finite"] or max([chk["rel_prefill"]]
                                        + chk["rel_steps"]) \
                    > DECODE_TOL_BF16 or n_prompt % cfg.ssm_chunk == 0:
                raise AssertionError(f"families long prompt: {chk}")
            out["long"] = {"arch": cfg.name, "layers": cfg.n_layers,
                           "prompt": n_prompt, "steps": n_steps,
                           "chunks": chunks, "wall_s": wall,
                           "tol": DECODE_TOL_BF16,
                           **{k: chk[k] for k in ("rel_prefill", "rel_steps",
                                                  "max_h", "prefill_ms",
                                                  "step_ms")}}
            del prompt, chk
        del session
        done()
    for arch, layers, dtype in FAMILY_CUTS:
        out["cuts"][f"{arch}/{layers}/{dtype}"] = family_cut_case(
            torch, arch, layers, dtype, dev_args, on_card)
        done()
    for arch, layers, mdt in FAMILY_TRAIN:
        out["train"][train_key(arch, mdt)] = family_train_case(
            torch, arch, layers, mdt, dev_args, on_card)
        done()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"families: phase wall {out['wall_s']:.1f} s")
    return out


FAMILY_PROFILED = tuple((arch, tuple(extra)) for arch, extra in FAMILY_SERVE)


def floor_phase(torch, device: str = "cuda",
                archs=("zamba2_7b", "mamba2_1_3b")) -> dict:
    """Where the bfloat16 decode checks' gap comes from at depth (the
    evidence for :data:`FAMILY_BF16_FLOOR`; ``python3 chip_smoke.py
    floor``, a partial run): each arch at the serving launcher's defaults
    through :func:`teacher_forced` with the flash kernels or the plain
    attention in the train-mode forward, and with the SSM state kept in
    the cache's bfloat16 or in float32."""
    import numpy as np

    import repro_torch.models as M
    from repro_torch.launch import serve
    from repro_torch.models import model_init

    real = M.cache_init

    def f32_state(cfg, b, n, dtype=None, device=None):
        c = real(cfg, b, n, dtype=dtype, device=device)
        for key in ("blocks", "tail_blocks"):
            if c.get(key) is not None:
                c[key]["state"] = c[key]["state"].float()
        return c

    dev = torch.device(device)
    dev_args = [] if device == "cuda" else ["--device", "cpu"]
    out = {}
    try:
        for arch in archs:
            args = serve.parse_args(["--arch", arch] + dev_args)
            cfg = serve.model_config(args, dev).with_overrides(
                dtype="bfloat16")
            params = model_init(cfg, torch.Generator(device=dev)
                                .manual_seed(0))
            prompt = {k: torch.from_numpy(v).to(dev) for k, v in
                      serve.make_prompt(cfg, args.batch, args.prompt_len,
                                        np.random.default_rng(0)).items()}
            for attn in ("flash", "plain"):
                for state in ("bfloat16", "float32"):
                    M.cache_init = f32_state if state == "float32" else real
                    c = cfg if attn == "flash" else cfg.with_overrides(
                        use_flash_attention=False)
                    chk = teacher_forced(torch, c, params, prompt,
                                         args.tokens - 1)
                    out[f"{arch}/{attn}/{state}"] = {
                        k: chk[k] for k in ("rel_prefill", "rel_steps",
                                            "flash_fwd")}
                    log(f"floor {arch}: {attn} attention in the train-mode "
                        f"forward, SSM state in {state}: prefill "
                        f"{chk['rel_prefill']:.4g}, steps "
                        f"{', '.join(f'{v:.4g}' for v in chk['rel_steps'])}"
                        f" of max|h|, flash launches {chk['flash_fwd']}")
            del params, prompt
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        M.cache_init = real
    return out


# ----------------------------------------------------------------------- #
# the paper's experiments (benchmarks/bench_torch_*.py)
# ----------------------------------------------------------------------- #

PAPER_FIG1_OUT = ROOT / "build" / "chip_smoke" / "fig1_torch_quick.json"
PAPER_CHECK_ROUNDS = GRID_ROUNDS  # quadratic rows, card against the CPU
PAPER_FIG1_CHECK_ROUNDS = 20      # fig1's (0.05, 5) cell, the same
PAPER_AGG_SHAPE = (20, 1_000_000)  # the aggregators suite's bank, f = 4
# every shape the suites hand the kernels, (kernel, [B, n, D], f), each
# held against the plain version at the kernels phase's bars: the
# aggregator rules; fig1's CWTM alone at the CNN's D, f = max(f, 1);
# table1 and a momentum beta's 3 lanes; global_vs_local; the breakdown
# and heterogeneity runs (f = max(f, 1))
PAPER_KERNEL_CASES = (
    (("pairdist", (1,) + PAPER_AGG_SHAPE, 4), ("cwtm", (1,) + PAPER_AGG_SHAPE,
                                               4),
     ("median", (1,) + PAPER_AGG_SHAPE, 4),
     ("cwtm", (1, 10, 11958), 1), ("cwtm", (1, 15, 11958), 5))
    + tuple((k, (b, 13, 64), 3) for b in (1, 3) for k in ("pairdist", "cwtm"))
    + (("pairdist", (1, 12, 64), 2), ("cwtm", (1, 12, 64), 2),
       ("pairdist", (1, 13, 48), 1))
    + tuple(("cwtm", (1, 13, 48), f) for f in range(1, 7)))


def paper_finite(suite: str, row: dict) -> bool:
    """Every number of a row finite, except where the reference's protocol
    makes it infinite: fig1's bytes to tau (never reached) and a breakdown
    distance that blew up (``_run`` maps it to inf)."""
    loose = {"fig1": "comm_bytes_to_tau", "breakdown": "dist"}.get(suite)
    for k, v in row.items():
        if k in ("name", "derived", "launches", "kernel_calls"):
            continue
        for x in (v if isinstance(v, list) else [v]):
            if isinstance(x, (int, float)) and not math.isfinite(x) \
                    and not (k == loose and x == float("inf")):
                return False
    return True


def paper_launched(fn):
    """``(fn(), the kernel launches fn made)``, nonzero counts only."""
    from repro_torch import kernels as K
    before = K.launches()
    out = fn()
    return out, {k: v - before[k] for k, v in K.launches().items()
                 if v != before[k]}


def paper_check_aggregators(torch, device: str) -> dict:
    """Each rule of the aggregators suite once on its bank on ``device``
    against ``make_aggregator(cfg, device="cpu")`` on the same bank: the
    median within atol 1e-6, the others within rtol = atol = 1e-5 (the
    kernels phase's median and CWTM bars)."""
    from benchmarks import bench_torch_aggregators as AG
    from repro_torch.core import make_aggregator
    x = AG.server_bank(*PAPER_AGG_SHAPE, device)
    xc = x.cpu()
    out = {}
    for label, cfg, _ in AG.rules(4):
        got = make_aggregator(cfg, device=device)(x).cpu()
        want = make_aggregator(cfg, device="cpu")(xc)
        err = float((got.double() - want.double()).abs().max())
        tol = 1e-6 if label == "median" else 1e-5
        ok = tuple(got.shape) == (PAPER_AGG_SHAPE[1],) and bool(
            torch.allclose(got, want, rtol=0.0 if label == "median" else tol,
                           atol=tol))
        out[label] = {"max_abs_err": err, "tol": tol, "ok": ok}
    log(f"paper aggregators at {list(PAPER_AGG_SHAPE)}, {device} against "
        f"the cpu: " + ", ".join(f"{k} {v['max_abs_err']:.3g} (bar "
                                f"{v['tol']:g})" for k, v in out.items()))
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"paper aggregators: {bad} disagree with the "
                             f"cpu")
    return out


def paper_check_runs(torch, device: str, rounds: int,
                     fig1_rounds: int) -> dict:
    """The suites' runs, card against the port's CPU path on the same
    targets and numpy draws (:func:`grid_replay`), each with its launches:
    table1's five rows, beta 0.9's three lanes, global_vs_local's
    (0.05, global) and breakdown's f = 2 cell at ``rounds`` rounds, each
    distance within rel 1e-4 (the grid phase's table1 bar); fig1's
    (0.05, 5) cell at ``fig1_rounds``: rounds and bytes equal, the
    parameters within 1e-4 of max |w| and the accuracy within one of the
    2,000 eval images."""
    from benchmarks import (bench_torch_breakdown as BD,
                            bench_torch_common as C,
                            bench_torch_global_vs_local as GL,
                            bench_torch_momentum as M,
                            bench_torch_table1 as T1)

    def replay(dev, cfg, d, steps, seed):
        return grid_replay(torch, dev, steps, d, cfg.sparsifier.k(d),
                           cfg.n_workers, seed)

    mom_cfg = T1.cell_config("rosdhb", 0.1, 0.05, 13, 3)
    gl_cfg, bd_cfg = GL.cell_config(0.05, False), BD.cell_config(13, 2)
    f1_cfg = C.protocol_config(ratio=0.05, f=5)

    def table1(dev):
        got, rows = T1.table1_rows(rounds, device=dev, draws_fn=lambda _, c:
                                   replay(dev, c, T1.D, rounds, T1.SEED))
        return ([got[k] for k in sorted(got)], sum(
            (collections.Counter(r["kernel_calls"]) for r in rows),
            collections.Counter()))

    def momentum(dev):
        rows = M.run(device=dev, steps=rounds, betas=(0.9,),
                     draws_fn=lambda s: replay(dev, mom_cfg, M.D, rounds, s))
        return rows[0]["dists"], rows[0]["kernel_calls"]

    def glob(dev):
        return [GL._dist(0.05, False, rounds, 0, device=dev,
                         draws=replay(dev, gl_cfg, GL.D, rounds, 0))], \
            C.kernel_launches(gl_cfg.aggregator, rounds, dev)

    def breakdown(dev):
        return [BD._run(13, 2, 0.2, steps=rounds, device=dev,
                        draws=replay(dev, bd_cfg, BD.D, rounds, 0))], \
            C.kernel_launches(bd_cfg.aggregator, rounds, dev)

    cases = {"table1": table1, "momentum/beta=0.9": momentum,
             "glob_vs_local/ratio=0.05/global": glob,
             "breakdown/f=2_of_13": breakdown}
    out, bad = {}, []
    for name, fn in cases.items():
        (got, want_l), launches = paper_launched(lambda: fn(device))
        (want, _), _ = paper_launched(lambda: fn("cpu"))
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        log(f"paper {name} at {rounds} rounds, {device} vs cpu on the same "
            f"draws: {got} against {want}, max rel {rel:.3g} (bar 1e-4), "
            f"launches {launches} (expected {dict(want_l)})")
        out[name] = {"rounds": rounds, "card": got, "cpu": want, "rel": rel,
                     "launches": launches}
        if not rel <= 1e-4 or launches != dict(want_l):
            bad.append(name)

    def fig1(dev):
        return C.run_protocol(f1_cfg, steps=fig1_rounds, device=dev,
                              draws=replay(dev, f1_cfg, 11958, fig1_rounds, 0))

    (res, st), launches = paper_launched(lambda: fig1(device))
    res_c, st_c = fig1("cpu")
    w, wc = st.params_flat.cpu(), st_c.params_flat
    dw = float((w - wc).abs().max() / wc.abs().max())
    want_l = C.kernel_launches(f1_cfg.aggregator, fig1_rounds, device)
    same = {k: res[k] == res_c[k] for k in ("rounds", "comm_bytes_to_tau")}
    log(f"paper fig1/ratio=0.05/f=5 at {fig1_rounds} rounds, {device} vs "
        f"cpu on the same draws: {res} against {res_c}, max |d| / max |w| "
        f"{dw:.3g} (bar 1e-4), launches {launches} (expected {want_l})")
    out["fig1/ratio=0.05/f=5"] = {"rounds": fig1_rounds, "card": res,
                                  "cpu": res_c, "rel_params": dw,
                                  "launches": launches}
    if not (all(same.values()) and dw <= 1e-4 and launches == want_l
            and abs(res["final_acc"] - res_c["final_acc"]) <= 1 / 2000):
        bad.append("fig1/ratio=0.05/f=5")
    if bad:
        raise AssertionError(f"paper: card and cpu disagree, or launches "
                             f"off, on {bad}")
    return out


def paper_phase(torch, device: str = "cuda",
                check_rounds: int = PAPER_CHECK_ROUNDS,
                fig1_rounds: int = PAPER_FIG1_CHECK_ROUNDS) -> dict:
    """The paper's experiments through ``benchmarks/bench_torch_run.py``:
    fig1 quick, table1 (and its ordering assert), the beta ablation, global
    against local masks, the breakdown and heterogeneity sweeps and the
    aggregator rules, every row printed, each suite's wall time; every row
    finite (:func:`paper_finite`) with the launches its suite states
    (``kernel_calls``: the rules' kernels times the rounds run). Then the
    checks, whose launches count in no row: every kernel against its plain
    version at each shape the suites hand it (:data:`PAPER_KERNEL_CASES`),
    the aggregator rules against the CPU's
    (:func:`paper_check_aggregators`), and the suites' runs against the
    CPU's on the same draws (:func:`paper_check_runs`). ``cpu`` only to
    rehearse the script's logic (no launches are expected there)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import bench_torch_run

    t_phase = time.perf_counter()
    PAPER_FIG1_OUT.parent.mkdir(parents=True, exist_ok=True)
    suites = bench_torch_run.run(device=device,
                                 fig1_out=str(PAPER_FIG1_OUT),
                                 suites=bench_torch_run.PAPER_SUITES)
    out = {"suites": {}}
    for suite, res in suites.items():
        bad = []
        for row in res["rows"]:
            want = row.get("kernel_calls", {})
            if row["launches"] != want or not paper_finite(suite, row):
                bad.append((row["name"], row["launches"], want))
        log(f"paper {suite}: {len(res['rows'])} rows, wall "
            f"{res['wall_s']:.1f} s, launches "
            f"{[r['launches'] for r in res['rows']]}")
        if bad:
            raise AssertionError(f"paper {suite}: rows not finite or with "
                                 f"other launches than expected: {bad}")
        out["suites"][suite] = {"wall_s": res["wall_s"],
                                "rows": list(res["rows"])}

    t_checks = time.perf_counter()
    if device == "cuda":
        recs = [kernel_case(torch, name, shape, f, torch.float32, False,
                            seed=400 + i)
                for i, (name, shape, f) in enumerate(PAPER_KERNEL_CASES)]
        for r in recs:
            log(f"paper kernel {r['name']} {r['shape']} f={r['f']}: max abs "
                f"err {r['max_abs_err']:.3g} ({r['tolerance']}) "
                f"{'ok' if r['ok'] else 'FAIL'}")
        if not all(r["ok"] for r in recs):
            raise AssertionError("paper: a kernel disagrees with its plain "
                                 "version at a suite's shape")
        out["kernel_cases"] = [{k: r[k] for k in ("name", "shape", "f",
                                                  "max_abs_err")}
                               for r in recs]
    out["aggregators_check"] = paper_check_aggregators(torch, device)
    out["checks"] = paper_check_runs(torch, device, check_rounds,
                                     fig1_rounds)
    out["checks_s"] = time.perf_counter() - t_checks
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"paper: checks {out['checks_s']:.1f} s, phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------- #
# the roofline: the card's peaks, the kernel bench, the dry run's bytes
# --------------------------------------------------------------------- #

BENCHES = ("llm", "serve", "chaos", "sweep")
BENCHES_OUT = ROOT / "build" / "chip_smoke"
#: The kernels each bench's cells launch on the card (NNM+CWTM in every
#: bench; the median in the median cells and the grids; the LLM launch
#: path's payload route in bench_llm's host-memory gate).
BENCH_KERNELS = {"llm": ("pairdist", "cwtm", "block_compress",
                         "momentum_scatter"),
                 "serve": ("pairdist", "cwtm", "median"),
                 "chaos": ("pairdist", "cwtm", "median"),
                 "sweep": ("pairdist", "cwtm", "median")}


def benches_phase(torch, device: str = "cuda", cuts=None) -> dict:
    """The reference's four remaining benches through the port
    (``benchmarks/bench_torch_{llm,serve,chaos,sweep}.py``), each with its
    gates (the wall-clock ones on the card only), its JSON and the sweep's
    fitted cost model written under ``build/chip_smoke/``; the launch
    counts set to 0 just before each bench and read just after, each of
    its kernels (:data:`BENCH_KERNELS`) launched at least once on the card.
    The benches run at the reference's sizes (134.4 s on an H100 80GB
    HBM3 at 700 W); ``cuts`` (``{bench: {argument: value}}``, named
    arguments of each bench's ``run()``) cut them, to rehearse on the
    CPU."""
    import importlib
    from repro_torch import kernels as K
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cuts = cuts or {}
    BENCHES_OUT.mkdir(parents=True, exist_ok=True)
    # the CNN parity gates compare convolutions bitwise
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.perf_counter()
    out = {}
    try:
        for name in BENCHES:
            mod = importlib.import_module(f"benchmarks.bench_torch_{name}")
            kw = dict(cuts.get(name, {}))
            if name == "sweep":
                kw.setdefault("cost_model_out",
                              str(BENCHES_OUT / "COST_MODEL_torch_sweep.json"))
            K.reset_launches()
            t0 = time.perf_counter()
            res = mod.run(out=str(BENCHES_OUT / f"BENCH_torch_{name}.json"),
                          device=device, **kw)
            wall = time.perf_counter() - t0
            launches = K.launches()
            idle = [k for k in BENCH_KERNELS[name] if not launches[k]]
            log(f"benches {name}: {wall:.1f} s, cuts {kw}, launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            if device == "cuda" and idle:
                raise AssertionError(f"benches {name}: kernels {idle} never "
                                     f"launched")
            out[name] = {"wall_s": wall, "cuts": kw, "launches": launches,
                         "results": res}
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"benches: phase wall {out['wall_s']:.1f} s")
    return out


COPY_BYTES = 1 << 31  # one device-to-device copy: 2 GiB read, 2 GiB written
COPY_REPS = 20
# the dry run's held state (parameters, banks, the adversary's memory)
# against the device bytes a run's setup left allocated: the same tensors,
# so only the allocator's 512-byte rounding and the draws' generator
# separate them
HELD_TOL = 1e-2
BENCH_KERNELS_OUT = ROOT / "build" / "chip_smoke" / "BENCH_torch_kernels.json"


def copy_bandwidth(torch, nbytes: int = COPY_BYTES,
                   reps: int = COPY_REPS) -> dict:
    """Device-to-device copy bandwidth: ``dst.copy_(src)`` of ``nbytes``,
    timed with CUDA events over ``reps`` copies; the bytes moved are the
    read and the write."""
    src = torch.ones(nbytes // 4, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(torch, lambda: dst.copy_(src), reps)
    del src, dst
    torch.cuda.empty_cache()
    rate = 2 * nbytes / (ms / 1e3)
    return {"bytes": nbytes, "ms": ms, "bytes_per_s": rate,
            "share_of_peak": rate / peak_rates()["bytes"]}


def dryrun_cuts(llm=None, families=None) -> list:
    """``(label, run_one kwargs, run record)`` of the card's train runs
    whose memory this run read (the record's ``peak_mib`` and
    ``held_mib``): the LLM step (2 layers of stablelm_3b, 8 workers of one
    sequence, Block-RandK at 0.05) at its bank dtypes, and the families'
    train paths at their layer counts and dtypes."""
    cuts = []
    base = dict(arch_id="stablelm_3b", shape_name="train_4k",
                n_layers=LLM_LAYERS, n_workers=LLM_WORKERS,
                global_batch=LLM_WORKERS, ratio=0.05)
    if llm is not None:
        cuts.append(("llm float32", dict(base, momentum_dtype="float32"),
                     llm))
        for key, dt in (("bf16", "bfloat16"), ("float16", "float16"),
                        ("float8_e4m3fn", "float8_e4m3fn")):
            opt = llm.get("options", {}).get(key)
            if opt is not None:
                cuts.append((f"llm {dt}", dict(base, momentum_dtype=dt),
                             opt))
        for dt, opt in llm.get("options", {}).get("dasha", {}).items():
            cuts.append((f"llm dasha {dt}", dict(base, algo="dasha",
                                                 momentum_dtype=dt), opt))
    for arch, layers, mdt in FAMILY_TRAIN:
        key = train_key(arch, mdt)
        if families is not None and key in families.get("train", {}):
            cuts.append((f"{key} train", dict(
                base, arch_id=arch, n_layers=layers, momentum_dtype=mdt),
                families["train"][key]))
    return cuts


def roofline_phase(torch, device: str = "cuda", llm=None,
                   families=None, bench_shapes=None) -> dict:
    """The roofline's inputs on the card: ``detect_hardware()`` must read
    the H100; the device-to-device copy bandwidth beside the published
    3.35 TB/s (a reading, not a bound); ``bench_torch_kernels`` with its
    gates (its JSON written to :data:`BENCH_KERNELS_OUT`); and the dry run
    (``repro_torch.launch.dryrun.run_one``) at the cuts this run trained,
    each predicted held state within rel :data:`HELD_TOL` of the bytes the
    run's setup left allocated and each predicted state no larger than
    the peak ``torch.cuda.max_memory_allocated()`` read for that run
    (``llm`` and ``families``: those phases' records; without them one
    LLM step is run here for its readings; ``bench_shapes`` replaces the
    bench's shapes, to rehearse on the CPU)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import bench_torch_kernels
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import detect_hardware

    t0 = time.perf_counter()
    out = {"card": gpu_line() if device == "cuda" else "cpu"}
    hw = detect_hardware()
    out["hardware"] = hw.name
    log(f"roofline: card {out['card']}")
    log(f"roofline: detect_hardware() = {hw.name} (peak {hw.peak_flops:g} "
        f"FLOP/s bf16, {hw.hbm_bw:g} B/s HBM)")
    if device == "cuda" and hw.name != "h100":
        raise AssertionError(f"roofline: detect_hardware() read {hw.name} "
                             f"on {torch.cuda.get_device_name(0)}")
    if device == "cuda":
        bw = copy_bandwidth(torch)
        log(f"roofline: device-to-device copy {bw['bytes']} B in "
            f"{bw['ms']:.4f} ms: {bw['bytes_per_s']:.6g} B/s (read and "
            f"write), {bw['share_of_peak']:.4f} of the published "
            f"{peak_rates()['bytes']:g} B/s (a reading, not a bound)")
        out["copy"] = bw
    BENCH_KERNELS_OUT.parent.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    bench = bench_torch_kernels.run(
        out=str(BENCH_KERNELS_OUT), device=device,
        shapes=bench_shapes or bench_torch_kernels.SHAPES)
    out["bench_kernels_s"] = time.perf_counter() - t1
    log(f"roofline: bench_torch_kernels gates {bench['gates']} "
        f"({out['bench_kernels_s']:.1f} s)")
    out["bench_kernels"] = {k: {m: row[m] for m in (
        "jnp_us", "dispatch_us", "speedup_vs_jnp", "floor_ratio",
        "dispatch_parity_rel")} for k, row in bench["aggregation"].items()}
    if llm is None and families is None:
        res = llm_run(torch, device, "roofline step", llm_argv(device, 1), 1,
                      block_compress=compressions, block_decompress=0,
                      momentum_scatter=payload_slices)
        llm = {"peak_mib": res["peak_mib"], "held_mib": res["held_mib"]}
        del res
        if device == "cuda":
            torch.cuda.empty_cache()
    checks, bad = [], []
    for label, kw, run in dryrun_cuts(llm, families):
        rep = dryrun.run_one(verbose=False, **kw)
        pred = rep["state_bytes_total"] / 2**20
        held = rep["held_bytes"] / 2**20
        peak_mib, held_mib = run["peak_mib"], run["held_mib"]
        # NaN on the CPU, which reads no device memory
        ratio, held_rel = pred / peak_mib, abs(held / held_mib - 1.0)
        parts = ", ".join(f"{k} {v / 2**20:.1f}"
                          for k, v in rep["state_bytes"].items())
        log(f"roofline dry run {label}: predicted held state {held:.1f} MiB "
            f"against {held_mib:.1f} MiB the setup left allocated (rel "
            f"{held_rel:.3g}, bound {HELD_TOL:g}); predicted state "
            f"{pred:.1f} MiB ({parts}), measured peak {peak_mib:.1f} MiB, "
            f"state/peak {ratio:.4f}; step "
            f"FLOPs {rep['step_flops']}, eager bytes "
            f"{rep['eager_bytes']['model'] + rep['eager_bytes']['server']:.6g}"
            f", roofline {rep['roofline']['compute_s'] * 1e3:.3f} ms compute"
            f", {rep['roofline']['memory_s'] * 1e3:.3f} ms memory")
        checks.append({"label": label, "predicted_mib": pred,
                       "peak_mib": peak_mib, "ratio": ratio,
                       "predicted_held_mib": held, "held_mib": held_mib,
                       "held_rel": held_rel,
                       "roofline": rep["roofline"],
                       "step_flops": rep["step_flops"],
                       "eager_bytes": rep["eager_bytes"]})
        if device == "cuda" and not (pred <= peak_mib
                                     and held_rel <= HELD_TOL):
            bad.append(label)
    out["dryrun"] = checks
    out["wall_s"] = time.perf_counter() - t0
    log(f"roofline: phase wall {out['wall_s']:.1f} s")
    if bad:
        raise AssertionError(f"roofline: the dry run's state exceeds the "
                             f"measured peak, or its held state is not "
                             f"the one the run allocated: {bad}")
    return out


def split_record(rec) -> dict:
    """The device and host µs per call of a timed case's kernel and
    library call."""
    out = {}
    for who in ("kernel", "library"):
        t = rec[who]
        for k in ("device_us", "device_ops", "host_us"):
            out[f"{who}_{k}"] = t[k] if t is not None else None
    return out


# ----------------------------------------------------------------------- #
# RoSDHB's server round at float16 and float8_e4m3fn compute
# ----------------------------------------------------------------------- #


def lowp_cfg(cdt: str, mdt: str, n: int = LLM_WORKERS, f: int = 1,
             pre_nnm: bool = False, sparsifier=None, rule: str = "cwtm"):
    from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                                  AttackConfig, SparsifierConfig)
    return AlgorithmConfig(
        name="rosdhb", n_workers=n, f=f, gamma=0.05, beta=0.9,
        sparsifier=sparsifier or SparsifierConfig(
            kind="block", ratio=0.05, block_size=LLM_BS),
        aggregator=AggregatorConfig(name=rule, f=f, pre_nnm=pre_nnm),
        attack=AttackConfig(name="alie", z=1.5 if n == 13 else None),
        momentum_dtype=mdt, server_compute_dtype=cdt)


def compare_rounds(torch, label: str, got: tuple, want: tuple) -> dict:
    """A round on the card against the same round on the CPU: the bank
    bitwise, the direction bitwise but where the kernels' float32 sums
    round across a step of the compute dtype (CWTM's weighted sum against
    the plain version's sum times 1/k), within one step there or within
    the sums' rounding (:func:`narrow_steps`); the coordinates that are
    not bitwise are counted."""
    (r_g, m_g), (r_c, m_c) = got, want
    m_g = m_g.cpu()
    bank_off = bits(torch, m_g) != bits(torch, m_c)
    bank = not bool(bank_off.any())
    if not bank:  # where and what, before the check fails
        idx = bank_off.nonzero()[:4]
        log(f"{label}: bank differs at {int(bank_off.sum()):,} entries, "
            f"rows {sorted(set(idx[:, 0].tolist()))}, e.g. at "
            f"{idx.tolist()}: card "
            f"{[float(m_g[tuple(i)]) for i in idx.tolist()]}, cpu "
            f"{[float(m_c[tuple(i)]) for i in idx.tolist()]}")
    r_g = r_g.cpu()
    n_off = int((bits(torch, r_g) != bits(torch, r_c)).sum())
    worst = int(narrow_steps(torch, r_g, r_c, finite_max(torch, m_c)).max())
    finite = bool(torch.isfinite(r_g.float()).all())
    ok = bank and worst <= 1 and finite
    log(f"{label}: card vs cpu bank bitwise {bank}, direction "
        f"{r_g.numel() - n_off:,} of {r_g.numel():,} coordinates bitwise, "
        f"{n_off:,} not (worst {worst} step of "
        f"{str(r_g.dtype).split('.')[-1]} past {SUM_ROUNDING:g} of the "
        f"momenta's max |m|), finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: card and cpu disagree")
    return {"bank_bitwise": bank, "dir_coords": r_g.numel(),
            "dir_off_one_step": n_off, "dir_worst_steps": worst}


def lowp_round_inputs(torch, cfg, d: int, seed: int, device: str):
    """A bfloat16 gradient bank, a momentum bank in ``momentum_dtype`` and
    the round's block ids, from ``seed``."""
    import numpy as np
    from repro_torch.core import algorithms as alg
    from repro_torch.utils.dtypes import to_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg.n_workers
    g = torch.empty((n, d), dtype=torch.bfloat16, device=device)
    m = torch.empty((n, d), dtype=alg.BANK_DTYPES[cfg.momentum_dtype],
                    device=device)
    for i in range(n):  # a row at a time: float32 draws of [8, D] are big
        g[i] = torch.randn(d, generator=gen, device=device) * 3
        m[i] = to_dtype(torch.randn(d, generator=gen, device=device) * 20,
                        m.dtype)
    nb = d // LLM_BS
    ids = np.random.default_rng(seed).permutation(nb)[:kept_blocks(d)]
    return g, m, ids


def lowp_round(torch, cfg, g, m, ids, device: str) -> tuple:
    """One RoSDHB server round on ``device``: ``(direction, bank, launches,
    ms)``."""
    from repro_torch import kernels as K
    from repro_torch.core import algorithms as alg
    from repro_torch.core import make_aggregator
    from repro_torch.testing import ReplayDraws
    state = alg.init_state(cfg, 1, device=device)._replace(momentum=m)
    agg = make_aggregator(cfg.aggregator, device=device)
    sync(torch, device)
    K.reset_launches()
    t0 = time.perf_counter()
    r, new, _ = alg.server_round(cfg, state, g,
                                 ReplayDraws(device, permutations=[ids]),
                                 agg=agg)
    sync(torch, device)
    return r, new.momentum, K.launches(), (time.perf_counter() - t0) * 1e3


def cnn_bank(torch, device: str):
    """The fig1-alie CNN's gradient bank ``[13, D]`` (one batch of its
    testbed, float32) and D."""
    from repro_torch.core import Simulator, mnist_testbed
    from repro_torch.utils import tree as T
    loss_fn, params0, batch_fn, _, _ = mnist_testbed(
        13, per_worker=100, batch=60, seed=0, device=device)
    sim = Simulator(loss_fn, params0, fig1_alie(), device=device)
    params = T.tree_unravel(sim.init(seed=0).params_flat, sim.spec)
    grads, _ = sim._grad_fn(params, sim._on_device(batch_fn(0)))
    return T.stacked_ravel(grads, sim.spec).detach(), sim.d


def compute_dtypes_phase(torch, device: str = "cuda") -> dict:
    """RoSDHB's round at ``server_compute_dtype`` float16 and float8_e4m3fn
    on the card: (b) at [8, LLM_D] with a bfloat16 wire, float32 and float8
    banks, CWTM (the dense route: compress and decompress, the momentum in
    the compute dtype, CWTM on its momenta), then the same round at
    LOWP_CHECK_D columns against the CPU (:func:`compare_rounds`); (c) the
    fig1-alie CNN round (n = 13, NNM+CWTM, and the median, on the CNN's
    own gradient bank), three rounds card against CPU; (d) the LLM cut's launcher at float8
    compute, 2 steps against its plain path. Every count is the kernels'
    launches in those runs."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import algorithms as alg
    from repro_torch.core import make_aggregator
    from repro_torch.launch import train
    from repro_torch.testing import ReplayDraws
    on_card = device == "cuda"
    out = {"rounds": {}, "cnn": {}, "launches": {}}
    total = {k: 0 for k in K.kernel_wrappers()}
    # the sort kernels' launches on each compute dtype's momenta
    by_class = {dt: {k: 0 for k in SORT_KERNELS} for dt in LOWP_DTYPES}

    def add(launches, cdt):
        for k, v in launches.items():
            total[k] += v
            if k in SORT_KERNELS:
                by_class[cdt][k] += v

    d_full = LLM_D if on_card else LOWP_CHECK_D
    for cdt, mdt in LOWP_ROUNDS:
        cfg = lowp_cfg(cdt, mdt)
        label = f"compute dtypes round {cdt} over {mdt} banks"
        g, m, ids = lowp_round_inputs(torch, cfg, d_full, 51, device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        r, bank, launches, ms = lowp_round(torch, cfg, g, m, ids, device)
        peak = (torch.cuda.max_memory_allocated() / 2**20 if on_card
                else None)
        add(launches, cdt)
        finite = bool(torch.isfinite(r.float()).all())
        want = {"block_compress": 1, "block_decompress": 1, "cwtm": 1,
                "momentum_scatter": 0, "pairdist": 0}
        if not on_card:
            want = {k: 0 for k in want}
        log(f"{label} [{LLM_WORKERS}, {d_full:,}] bfloat16 wire: "
            f"{ms:.3f} ms (host clock), peak {peak} MiB, direction "
            f"{r.dtype} finite {finite}, launches {launches}")
        check_launches(label, launches, want)
        if not finite or r.dtype != alg.COMPUTE_DTYPES[cdt] or \
                bank.dtype != alg.BANK_DTYPES[mdt]:
            raise AssertionError(f"{label}: {r.dtype}, {bank.dtype}, "
                                 f"finite {finite}")
        del g, m, r, bank
        if on_card:
            torch.cuda.empty_cache()
        # the same round at LOWP_CHECK_D columns, card against CPU
        g, m, ids = lowp_round_inputs(torch, cfg, LOWP_CHECK_D, 52, "cpu")
        r_c, m_c, _, cpu_ms = lowp_round(torch, cfg, g, m.clone(), ids,
                                         "cpu")
        r_g, m_g, chk, _ = lowp_round(torch, cfg, g.to(device),
                                      m.to(device), ids, device)
        add(chk, cdt)
        cmp = compare_rounds(torch, f"{label} [{LLM_WORKERS}, "
                             f"{LOWP_CHECK_D:,}]", (r_g, m_g), (r_c, m_c))
        out["rounds"][f"{cdt}/{mdt}"] = {
            "D": d_full, "ms": ms, "peak_mib": peak, "launches": launches,
            "check_D": LOWP_CHECK_D, "check_cpu_ms": cpu_ms, **cmp}
        del g, m, r_c, m_c, r_g, m_g
    # (c) the CNN's fig1-alie round, three rounds card against CPU
    from repro_torch.core import SparsifierConfig
    g32, d = cnn_bank(torch, "cpu")
    k = fig1_alie().sparsifier.k(d)
    perms = replay_indices(3, d, k, 7)
    for cdt, rule in [(c, r) for c in LOWP_DTYPES
                      for r in ("nnm_cwtm", "median")]:
        cfg = lowp_cfg(cdt, "float32", n=13, f=F, pre_nnm=rule != "median",
                       sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
                       rule=rule.split("_")[-1])
        runs = {}
        for dev in ("cpu", device):
            agg = make_aggregator(cfg.aggregator, device=dev)
            state = alg.init_state(cfg, d, device=dev)
            draws = ReplayDraws(dev, permutations=perms)
            K.reset_launches()
            rs = []
            for _ in range(3):
                r, state, _ = alg.server_round(cfg, state, g32.to(dev),
                                               draws, agg=agg)
                rs.append(r)
            runs[dev] = (rs, state.momentum, K.launches())
        add(runs[device][2], cdt)
        label = f"compute dtypes cnn fig1-alie {cdt} {rule}"
        want = ({"pairdist": 3, "cwtm": 3, "median": 0}
                if rule != "median" else
                {"pairdist": 0, "cwtm": 0, "median": 3})
        if not on_card:
            want = {k: 0 for k in want}
        check_launches(label, runs[device][2], want)
        cmp = [compare_rounds(torch, f"{label} round {t}",
                              (runs[device][0][t], runs[device][1]),
                              (runs["cpu"][0][t], runs["cpu"][1]))
               for t in range(3)]
        out["cnn"][f"{cdt}/{rule}"] = {"D": d, "rounds": 3,
                                       "launches": runs[device][2],
                                       "checks": cmp}
        del runs
    # (d) the LLM cut's launcher at float8 compute (bfloat16 banks: the
    # dense round's float32 transients of [8, D] beside float32 banks would
    # not fit), 2 steps against its plain path
    argv = llm_argv(device, LLM_CHECK_STEPS) + [
        "--momentum-dtype", "bfloat16", "--server-compute-dtype",
        "float8_e4m3fn"]
    K.reset_launches()
    res = train.run(argv, log=log)
    launches = K.launches()
    add(launches, "float8_e4m3fn")
    plan = res["plan"]
    label = "compute dtypes llm float8"
    check_launches(label, launches, llm_launches(
        plan.model, plan, LLM_CHECK_STEPS, on_card, block_compress=1,
        block_decompress=1, momentum_scatter=0,
        cwtm=lambda _: 1))
    losses, norms = res["losses"], res["dir_norms"]
    peak = (res["peak_bytes"] / 2**20 if res["peak_bytes"] is not None
            else None)
    step_ms = res["step_ms"]
    del res
    if on_card:
        torch.cuda.empty_cache()
    plain = train.run(argv, plain=True, log=log)
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                   plain["losses"]))
    # |R| is a float8 scalar: equal, or one float8 step (2^-3 relative)
    rel_r = max(abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(norms, plain["dir_norms"]))
    log(f"{label}: D={plan.flat_spec.padded_size:,} losses {losses}, |R| "
        f"{norms} (float8), steps "
        f"{', '.join(f'{v:.3f}' for v in step_ms)} ms, peak {peak} MiB, "
        f"launches {launches}; against the plain path loss max rel "
        f"{rel_l:.3g} (bound {LLM_TOL_LOSS:g}), |R| {plain['dir_norms']} "
        f"(max rel {rel_r:.3g}, bound 0.125)")
    if not all(math.isfinite(v) for v in losses + norms) or \
            rel_l > LLM_TOL_LOSS or rel_r > 0.125:
        raise AssertionError(f"{label}: kernel and plain paths disagree")
    out["llm"] = {"D": plan.flat_spec.padded_size, "losses": losses,
                  "dir_norms": norms, "step_ms": step_ms, "peak_mib": peak,
                  "launches": launches, "plain_rel_loss": rel_l,
                  "plain_rel_dir": rel_r, "plain_step_ms": plain["step_ms"]}
    del plain
    if on_card:
        torch.cuda.empty_cache()
    out["launches"], out["launches_by_class"] = total, by_class
    log(f"compute dtypes: launches {total}, the sort kernels' by compute "
        f"dtype {by_class}")
    return out


def kernel_record(results, randk, flash, cnn, quad, llm, grid,
                  serve, stream, decode, families, paper, lowp) -> dict:
    """The ``{"kernels": [...]}`` line: every kernel of the port, its
    launches on the main paths and its numbers at its main path's shape.
    ``launches`` is the CNN path's count (the median's first path is the
    grid: its ``launches`` is the grid's); ``launches_serve`` the served
    fig1-alie path's (20 rounds in process; the median's from the
    ``rosdhb/foe/median`` cell); ``launches_stream`` the streamed paths'
    (the CNN's 100 rounds, the table1 grid's 40, transformer-table1's 16
    rounds and its eval); ``launches_audio_train`` musicgen_medium's train
    path (2 layers, 4 steps); ``launches_families_train`` the families'
    train paths (4 steps each); the flash forward's
    ``launches_decode_checks`` and ``launches_families_checks`` the
    train-mode forwards that the decode and families phases hold prefill
    and decode against; ``launches_paper`` the paper phase's suites
    (``benchmarks/bench_torch_run.py``, each suite's sum over its rows)."""
    record = {"kernels": []}
    for name in SORT_KERNELS:
        recs = [r for r in results[name] if "ms" in r
                and r["dtype"] not in SORT_LOWP_DTYPES]
        head = recs[0]  # the CNN path's shape
        grid_launches = grid["table1"]["launches"][name]
        record["kernels"].append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": (grid_launches if name == "median"
                         else cnn["launches"][name]),
            "launches_cnn": cnn["launches"][name],
            "launches_grid": grid_launches,
            "launches_grid_per_round": grid["table1"]["launches_per_round"][
                name],
            "launches_quadratic": quad["rosdhb"]["kernel"]["launches"][name],
            "launches_quadratic_dasha": quad["dasha"]["kernel"][
                "launches"][name],
            "launches_llm": llm["launches"][name],
            "launches_serve": (serve["median"] if name == "median"
                               else serve["parity"])["launches"][name],
            "launches_stream": {
                "cnn": stream["cnn"]["stacked"]["launches"][name],
                "grid": stream["grid"]["launches"][name],
                "transformer_table1": stream["transformer_table1"][
                    "launches"][name]},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            "device_us": head["kernel"]["device_us"],
            "host_us": head["kernel"]["host_us"],
            "shapes": [{**{k: r[k] for k in ("shape", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "max_abs_err")},
                        **split_record(r)} for r in recs]})
    timed_randk = randk["block"][-1]
    timed_flash = flash[-1]
    flash_shapes = [rec for rec in flash if "flash_fwd" in rec
                    and rec["dtype"] == "bfloat16"]
    for name, rec, err, shape in (
            ("block_compress", timed_randk,
             timed_randk["max_abs_err"]["block_compress"],
             timed_randk["shape"]),
            ("block_decompress", timed_randk,
             timed_randk["max_abs_err"]["block_decompress"],
             timed_randk["shape"]),
            ("flash_fwd", timed_flash, timed_flash["errs"]["out"],
             timed_flash["case"]),
            ("flash_bwd", timed_flash, max(timed_flash["errs"][k] for k in
                                           ("dq", "dk", "dv")),
             timed_flash["case"])):
        t = rec[name]
        record["kernels"].append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": llm["launches"][name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": shape})
        if name.startswith("block"):
            record["kernels"][-1].update(
                device_us=t.get("device_us"), host_us=t["host_us"],
                shapes=[{"shape": r["shape"], "dtype": r["dtype"],
                         "max_abs_err": r["max_abs_err"][name],
                         **{k: r[name].get(k) for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "device_us", "host_us")}}
                        for r in randk["block"] if name in r])
        if name.startswith("flash"):
            record["kernels"][-1].update(
                device_us=t.get("device_us"), host_us=t["host_us"],
                library_device_us=t.get("library_device_us"),
                launches_stream=stream["transformer_table1"]["launches"][
                    name],
                shapes=[{"shape": r["case"], **{k: r[name].get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_us", "host_us", "library_device_us")}}
                    for r in flash_shapes])
            kernels = [f"{k}<{d}>" for k in (
                ["flash_fwd_kernel", "flash_fwd_short_kernel"]
                if name == "flash_fwd" else
                ["flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dkdv_sum_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dq_ds_kernel"])
                for d in flash_dims("flash_attention", k)]
            record["kernels"][-1]["kernel_over_library"] = (
                t["ms"] / t["library_ms"] if t["library_ms"] else None)
            record["kernels"][-1]["ptxas"] = {
                k: FLASH_PTXAS.get(k) for k in kernels}
            record["kernels"][-1]["sass"] = {
                k: FLASH_SASS.get(k) for k in kernels}
    # the float32 kernels: their numbers at the LLM path's shape (the first
    # of their timed rows at it), their launches on the float32 LLM cut
    f32_shapes = [rec for rec in flash if "flash_fwd" in rec
                  and rec["dtype"] == "float32"]
    f32_path = next(r for r in f32_shapes if tuple(r["case"]) == FLASH_PATH)
    for name, err, kernels in (
            ("flash_fwd", f32_path["errs"]["out"], ["flash_fwd_ffma_kernel"]),
            ("flash_bwd", max(f32_path["errs"][k] for k in ("dq", "dk",
                                                            "dv")),
             ["flash_bwd_ffma_delta_kernel", "flash_bwd_ffma_dkdv_kernel",
              "flash_bwd_ffma_dkdv_sum_kernel",
              "flash_bwd_ffma_dq_kernel", "flash_bwd_ffma_dq_ds_kernel"])):
        t = f32_path[name]
        kernels = [f"{k}<{d}>" for k in kernels
                   for d in flash_dims("flash_attention_f32", k)]
        record["kernels"].append({
            "name": f"{name}_f32", "route": "cuda",
            **KERNELS[f"{name}_f32"], "dtype": "float32",
            "launches": llm["f32"]["launches"][f"{name}_f32"],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": f32_path["case"],
            "device_us": t.get("device_us"), "host_us": t["host_us"],
            "library_device_us": t.get("library_device_us"),
            "kernel_over_library": (t["ms"] / t["library_ms"]
                                    if t["library_ms"] else None),
            "shapes": [{"shape": r["case"], "nsplit": r.get("nsplit"),
                        "kernel_f64": r["errs"].get("kernel_f64"),
                        "plain_f64": r["errs"].get("plain_f64"),
                        **{k: r[name].get(k) for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "device_us", "host_us",
                            "library_device_us")}}
                       for r in f32_shapes],
            "ptxas": {k: FLASH_PTXAS.get(k) for k in kernels},
            "sass": {k: FLASH_SASS.get(k) for k in kernels}})
    # decompress runs on the main path no more; the local-mask run keeps it
    decompress = next(k for k in record["kernels"]
                      if k["name"] == "block_decompress")
    decompress["launches_local_masks"] = llm["options"]["local_masks"][
        "launches"]["block_decompress"]
    # the momentum kernel at the LLM path's float32 bank first, then bf16
    recs = [r for r in randk["momentum"] if "ms" in r]
    head = recs[0]
    record["kernels"].append({
        "name": "momentum_scatter", "route": "cuda",
        **KERNELS["momentum_scatter"],
        "launches": llm["launches"]["momentum_scatter"],
        "launches_bf16": llm["options"]["bf16"]["launches"][
            "momentum_scatter"],
        "max_abs_err": max(r["max_abs_err"] for r in randk["momentum"]),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "shape")},
        "device_us": head.get("device_us"), "host_us": head["host_us"],
        "shapes": [{k: r.get(k) for k in ("shape", "dtype", "window", "ms",
                                          "plain_ms", "bound_ms",
                                          "max_abs_err", "device_us",
                                          "host_us")}
                   for r in recs]})
    audio = decode["audio_train"]["launches"]
    for k in record["kernels"]:
        k["launches_audio_train"] = audio[k["name"]]
        k["launches_paper"] = {
            suite: sum(r["launches"].get(k["name"], 0) for r in v["rows"])
            for suite, v in paper["suites"].items()}
        k["launches_families_train"] = {
            arch: t["launches"][k["name"]]
            for arch, t in families["train"].items()}
    flash_fwd = record["kernels"][[k["name"] for k in record["kernels"]]
                                  .index("flash_fwd")]
    flash_fwd["launches_decode_checks"] = {
        name: decode[name]["check_flash_fwd"] for name in
        ("vlm_bf16", "ring") + tuple(a for a, _ in DECODE_WIDE)}
    flash_fwd["launches_families_checks"] = {
        arch: rec["check_flash_fwd"]
        for arch, rec in families["serve"].items()}
    flash_fwd_f32 = next(k for k in record["kernels"]
                         if k["name"] == "flash_fwd_f32")
    flash_fwd_f32["launches_decode_checks"] = {
        "vlm_f32": decode["vlm_f32"]["check_flash_fwd_f32"]}
    flash_fwd_f32["launches_families_checks"] = {
        name: rec["check_flash_fwd"]
        for name, rec in families["cuts"].items()
        if rec["dtype"] == "float32"}
    # the sort kernels' float16 and float8_e4m3fn input classes: their
    # launches on the compute dtypes phase's runs, their numbers at the
    # CNN's shape
    for name in SORT_KERNELS:
        for dt in LOWP_DTYPES:
            recs = [r for r in results[name] if "ms" in r
                    and r["dtype"] == dt]
            head = recs[0]
            record["kernels"].append({
                "name": f"{name}_{dt}", "dtype": dt, "route": "cuda",
                **KERNELS[name],
                "launches": lowp["launches_by_class"][dt][name],
                "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "device_us": head["kernel"].get("device_us"),
                "shapes": [{**{k: r[k] for k in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")}, **split_record(r)} for r in recs]})
    # the float16 and float8 banks' variants of compress, decompress and
    # the momentum kernel: their timed cases at the LLM path's bank, their
    # launches in the LLM runs at those dtypes (decompress: none, the
    # payload route has no dense wire)
    for dt in LOWP_DTYPES:
        launches = llm["options"][dt]["launches"]
        blk = next(r for r in randk["block"] if r["dtype"] == dt
                   and "seed" in r and r["shape"] == [LLM_WORKERS, LLM_D])
        mom = next(r for r in randk["momentum"] if r["dtype"] == dt
                   and "ms" in r and r["shape"] == [LLM_WORKERS, LLM_D])
        t = blk["block_compress"]
        record["kernels"].append({
            "name": f"block_compress_{dt}", "route": "cuda",
            **KERNELS["block_compress"], "dtype": dt,
            "launches": launches["block_compress"],
            "max_abs_err": blk["max_abs_err"]["block_compress"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "host_us")},
            "device_us": t.get("device_us"), "shape": blk["shape"]})
        t = blk["block_decompress"]
        record["kernels"].append({
            "name": f"block_decompress_{dt}", "route": "cuda",
            **KERNELS["block_decompress"], "dtype": dt,
            "launches": launches["block_decompress"],
            "max_abs_err": blk["max_abs_err"]["block_decompress"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "host_us")},
            "device_us": t.get("device_us"), "shape": blk["shape"]})
        record["kernels"].append({
            "name": f"momentum_scatter_{dt}", "route": "cuda",
            **KERNELS["momentum_scatter"], "dtype": dt,
            "launches": launches["momentum_scatter"],
            **{k: mom[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "host_us", "shape")},
            "device_us": mom.get("device_us")})
    # the kernel a window at a time: the vlm's float8 bank at its first and
    # last window, and over the step's windows as the round launches them
    wins = [r for r in randk["momentum"] if "ms" in r and "window" in r]
    first, last = wins[0], wins[-1]
    sweep = randk["momentum_sweep"][0]
    vlm_train = families["train"][train_key(VLM_BANK[0], VLM_BANK[2])]
    dbrx_train = families["train"][train_key(DBRX_BANK[0], DBRX_BANK[2])]
    record["kernels"].append({
        "name": "momentum_scatter_window", "route": "cuda",
        **KERNELS["momentum_scatter"], "dtype": VLM_BANK[2],
        "launches": vlm_train["launches"]["momentum_scatter"],
        "max_abs_err": max(r["max_abs_err"] for r in randk["momentum"]
                           if "window" in r),
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "host_us", "shape",
                                 "window")},
        "device_us": first.get("device_us"),
        "last_window": {k: last.get(k) for k in (
            "window", "ms", "plain_ms", "bound_ms", "device_us", "host_us")},
        "step_windows": sweep["windows"],
        "step_sweep": {name: {k: sweep[name].get(k) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "device_us",
            "device_ops", "host_us")} for name in ("momentum_scatter",
                                                   "cwtm")}})
    record["kernels"] += dbrx_kernel_records(randk, dbrx_train)
    return record


def dbrx_kernel_records(randk, dbrx_train) -> list:
    """The kernels line's records of dbrx_132b's train path (its launches
    ``dbrx_train``'s): compress on one worker's row at a time, the
    momentum kernel (and CWTM) over the step's 268 windows, from the randk
    phase's timed cases."""
    out = []
    row = next(r for r in randk["block"]
               if r["shape"] == list(RANDK_DBRX[:2])
               and r["dtype"] == RANDK_DBRX[5])
    t = row["block_compress"]
    out.append({
        "name": "block_compress_row", "route": "cuda",
        **KERNELS["block_compress"], "dtype": RANDK_DBRX[5],
        "launches": dbrx_train["launches"]["block_compress"],
        "max_abs_err": row["max_abs_err"]["block_compress"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "host_us")},
        "device_us": t.get("device_us"), "shape": row["shape"]})
    dbrx_sweep = randk["momentum_sweep"][1]
    t = dbrx_sweep["momentum_scatter"]
    out.append({
        "name": "momentum_scatter_window_sweep", "route": "cuda",
        **KERNELS["momentum_scatter"], "dtype": DBRX_BANK[2],
        "launches": dbrx_train["launches"]["momentum_scatter"],
        "max_abs_err": dbrx_sweep["max_abs_err"],
        **{k: t.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_us", "host_us")},
        "shape": dbrx_sweep["shape"], "step_windows": dbrx_sweep["windows"],
        "cwtm_sweep": {k: dbrx_sweep["cwtm"].get(k) for k in (
            "ms", "bound_ms", "bound_by", "device_us", "device_ops",
            "host_us")},
        "cwtm_launches": dbrx_train["launches"]["cwtm"]})
    return out


def ptxas_table(report: str) -> dict:
    """``{kernel<D>: {"registers", "spill_stores", "spill_loads"}}`` from
    ``-Xptxas -v`` (the registers a thread starts with; ``setmaxnreg`` then
    moves them between warpgroups)."""
    import re
    out, name, spill = {}, None, (0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d+([a-z_]+_kernel)(?:IL[ij](\d+)E)?", line)
            name = (f"{m[1]}<{m[2]}>" if m and m[2] else
                    (m[1] if m else None))
            spill = (0, 0)
        elif "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill", line)
            spill = (int(nums[0]), int(nums[1])) if len(nums) == 2 else spill
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            key = name
            while key in out:  # instances that differ only in their types
                key += "'"
            out[key] = {"registers": regs, "spill_stores": spill[0],
                        "spill_loads": spill[1]}
    return out


#: The flash kernels of each library (``csrc/<name>.cu``): the bfloat16
#: ones on the tensor cores, the float32 ones (``ffma``) on the CUDA cores;
#: each is built at every head dim of its library's :func:`flash_dims`.
FLASH_KERNELS = {
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_short_kernel",
                        "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                        "flash_bwd_dkdv_sum_kernel", "flash_bwd_dq_kernel",
                        "flash_bwd_dq_ds_kernel"),
    "flash_attention_f32": ("flash_fwd_ffma_kernel",
                            "flash_bwd_ffma_delta_kernel",
                            "flash_bwd_ffma_dkdv_kernel",
                            "flash_bwd_ffma_dkdv_sum_kernel",
                            "flash_bwd_ffma_dq_kernel",
                            "flash_bwd_ffma_dq_ds_kernel")}


def flash_dims(lib: str, kernel: str = "") -> tuple:
    """The head dims a flash library is built for (``flash.head_dims``),
    or those of one of its kernels: each library builds dq from dS^T
    (``flash_bwd_dq_ds_kernel``, ``flash_bwd_ffma_dq_ds_kernel``) at
    ``flash.DS_DIMS`` and the recomputing dq at the others."""
    import torch

    from repro_torch.kernels.flash_attention.flash import DS_DIMS, head_dims
    dims = head_dims(torch.float32 if lib == "flash_attention_f32" else None)
    if kernel.endswith("dq_ds_kernel"):
        return tuple(d for d in dims if d in DS_DIMS)
    if kernel.endswith("dq_kernel"):
        return tuple(d for d in dims if d not in DS_DIMS)
    return dims
#: ptxas's registers and spills of the flash kernels, from this run's build.
FLASH_PTXAS: dict = {}
#: The same of the sort kernels (``csrc/sorted_weight.cu``, ``pairdist.cu``).
SORT_PTXAS: dict = {}
#: Instructions in each flash kernel's SASS (``cuobjdump -sass``): HGMMA
#: (wgmma), UTMALDG (TMA loads), HMMA (mma.sync, what WMMA becomes), FFMA
#: (float32 fused multiply-add on the CUDA cores), TF32 (any instruction
#: on tf32 operands).
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "FFMA", "TF32")
FLASH_SASS: dict = {}


def sass_counts(library: Path) -> dict:
    """``{kernel<D>: {op: count}}`` for the flash kernels of ``library``,
    from ``cuobjdump -sass`` (beside ``nvcc``); raises if the tool is
    missing or fails."""
    import re
    import shutil
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.exists():
        raise FileNotFoundError(f"no cuobjdump beside {nvcc}: the flash "
                                f"kernels' instructions cannot be checked")
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d+([a-z_]+_kernel)ILi(\d+)E", line)
            name = f"{m[1]}<{m[2]}>" if m and "flash" in m[1] else None
            if name:
                out[name] = {op: 0 for op in SASS_OPS}
        elif name:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
    return out


def main() -> int:
    # the families' train steps allocate a 30.6 GiB float32 result beside
    # 46 GiB of banks and parameters: without expandable segments the
    # caching allocator's split blocks leave no room for it (on an H100
    # 80GB HBM3: 31.2 GiB reserved but unallocated at the failure)
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    if len(sys.argv) > 2 and sys.argv[1] == "--flash-ab":
        # the flash kernels against other versions', in turns
        log(f"gpu: {gpu_line()}")
        records = flash_ab(torch, [Path(a).resolve() for a in sys.argv[2:]])
        out = ROOT / "build" / "chip_smoke" / "flash_ab.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"gpu": gpu_line(), "records": records},
                                  indent=1))
        log(json.dumps(records))
        return 3
    if len(sys.argv) > 2 and sys.argv[1] == "--sort-ab":
        # the sort kernels against other versions', in turns
        log(f"gpu: {gpu_line()}")
        records = sort_ab(torch, [Path(a).resolve() for a in sys.argv[2:]])
        out = ROOT / "build" / "chip_smoke" / "sort_ab.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"gpu": gpu_line(), "records": records},
                                  indent=1))
        log(gpu_line())
        return SORT_AB_EXIT
    if len(sys.argv) > 2 and sys.argv[1] == "--device-times":
        # one JSON line: profile_cases in a fresh process
        cases = json.loads(sys.argv[2])
        print(json.dumps(device_times(torch, cases["sort"], cases["flash"],
                                      cases.get("randk", ()))))
        return 0

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
        table = ptxas_table(report)
        for kernel, regs in table.items():
            log(f"  ptxas {kernel}: {regs['registers']} registers, spill "
                f"stores {regs['spill_stores']} B, spill loads "
                f"{regs['spill_loads']} B")
        if name in FLASH_KERNELS:
            FLASH_PTXAS.update(table)
        elif name in ("sorted_weight", "pairdist"):
            SORT_PTXAS.update(table)

    phases = set(sys.argv[1].split(",")) if len(sys.argv) > 1 else None

    def want(name):
        return phases is None or name in phases

    if phases is not None:
        # a partial run (kernel bring-up): no ok line
        def families_then_profiles(t):
            out = families_phase(t)
            out["profile"] = decode_profiles(t, FAMILY_PROFILED)
            return out

        for name, fn in (("kernels", kernel_phase), ("randk", randk_phase),
                         ("flash", flash_phase), ("quadratic", quadratic_phase),
                         ("llm", llm_phase), ("grid", grid_phase),
                         ("serve", serve_phase),
                         ("stream", lambda t: stream_phase(t, card=card)),
                         ("decode", decode_phase),
                         ("families", families_then_profiles),
                         ("floor", floor_phase), ("paper", paper_phase),
                         ("lowp", compute_dtypes_phase),
                         ("benches", benches_phase),
                         ("roofline", roofline_phase)):
            if want(name):
                out = fn(torch)
                if name == "kernels":
                    profile_cases(torch, out)
                elif name == "randk":
                    profile_cases(torch, {k: [] for k in SORT_KERNELS},
                                  randk=out)
        log(card)
        return 3
    results = kernel_phase(torch)
    randk = randk_phase(torch)
    flash = flash_phase(torch)
    torch.cuda.empty_cache()
    cnn = cnn_phase(torch)
    quad = quadratic_phase(torch)
    llm = llm_phase(torch)
    torch.cuda.empty_cache()
    lowp = compute_dtypes_phase(torch)
    torch.cuda.empty_cache()
    grid = grid_phase(torch)
    torch.cuda.empty_cache()
    serve = serve_phase(torch)
    torch.cuda.empty_cache()
    stream = stream_phase(torch, card=card)
    torch.cuda.empty_cache()
    paper = paper_phase(torch)
    torch.cuda.empty_cache()
    benches = benches_phase(torch)
    torch.cuda.empty_cache()
    decode = decode_phase(torch, profile=False)
    torch.cuda.empty_cache()
    families = families_phase(torch)
    torch.cuda.empty_cache()
    roofline = roofline_phase(torch, llm=llm, families=families)
    torch.cuda.empty_cache()
    # profiled decode steps last in this process (the profiler slows the
    # launches that follow it)
    profiles = decode_profiles(torch, DECODE_PROFILED + FAMILY_PROFILED)
    decode["profile"] = {a: profiles[a] for a, _ in DECODE_PROFILED}
    families["profile"] = {a: profiles[a] for a, _ in FAMILY_PROFILED}
    torch.cuda.empty_cache()
    profile_cases(torch, results, fresh_process=True,  # see profile_cases
                  flash=flash, randk=randk)
    record = kernel_record(results, randk, flash, cnn, quad, llm, grid,
                           serve, stream, decode, families, paper, lowp)
    log(json.dumps({"summary": {
        "cnn": {k: cnn[k] for k in ("rounds", "median_round_ms", "acc",
                                    "cpu_rel_diff", "profile")},
        "quadratic": {a: {k: {m: quad[a][k][m] for m in
                              ("ms_per_round", "peak_mib", "dist0", "dist")}
                          for k in ("kernel", "plain")}
                      for a in ("rosdhb", "dasha")},
        "server_round": randk["server_round"],
        "compute_dtypes": lowp,
        "llm": {k: llm[k] for k in ("steps", "losses", "step_ms",
                                    "median_step_ms", "peak_mib",
                                    "plain_rel_loss", "plain_rel_dir",
                                    "plain_step_ms", "profile", "options",
                                    "f32")},
        "flash_sdpa_fwd_bwd_ms": flash[-1].get("library_fwd_bwd_ms"),
        "grid": {"table1": {k: v for k, v in grid["table1"].items()
                            if k not in ("round_ms", "rows")},
                 "table1_check": grid["table1_check"],
                 "mimic_iid": grid["mimic_iid"],
                 "mixed_attacks": grid["mixed_attacks"]},
        "serve": serve,
        "stream": stream,
        "decode": decode,
        "families": families,
        "roofline": roofline,
        "benches": {k: ({m: v[m] for m in ("wall_s", "cuts", "launches")}
                        if isinstance(v, dict) else v)
                    for k, v in benches.items()},
        "paper": {"wall_s": paper["wall_s"],
                  "checks": paper["checks"],
                  "kernel_cases": paper["kernel_cases"],
                  "aggregators_check": paper["aggregators_check"],
                  "suites": {k: {"wall_s": v["wall_s"],
                                 "rows": [(r["name"], r["derived"])
                                          for r in v["rows"]]}
                             for k, v in paper["suites"].items()}}}},
        default=str))
    log(json.dumps(record))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
