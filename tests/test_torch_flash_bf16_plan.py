"""The bfloat16 flash kernels' launch plan and scratch, on the CPU.

``flash.dkdv_plan`` with the bfloat16 tiles (``flash.DKDV_TILES``, the
``Tiles<D>`` of ``csrc/flash_attention.cu``) splits the dk/dv kernel's
blocks where its grid would not fill the card, as the float32 one does:
each key block's (query head, query tile) units go in contiguous runs to
``nsplit`` blocks, whose float32 partial sums the sum pass adds in split
order before the one rounding to bfloat16. At head dim 256 dk/dv also
writes dS^T in bfloat16 for dq. Here the plan is held to the visibility
mask at the row-7b shapes and at ragged, windowed and offset ones, its runs
are summed as the kernels sum them, its tables and the entry's arguments
are the ``.cu``'s, and the scratch is sized for each shape. Pure Python:
no kernel runs."""

import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, attention_mask,
                                                 dkdv_plan)
from repro_torch.kernels.flash_attention import flash as FK

SMS = 132  # an H100's SMs
# (B, Sq, Sk, H, KV, D, causal, window, q_offset): the row-7b shapes (the
# LLM path's, table1's, musicgen's, zamba2's, gemma_2b's, the vlm's,
# qwen25_3b's, mistral's), with the split each takes on 132 SMs
TIMED = {(1, 4096, 4096, 32, 32, 80, True, None, 0): 1,
         (288, 32, 32, 2, 2, 64, True, None, 0): 1,
         (1, 4096, 4096, 24, 24, 64, True, None, 0): 1,
         (1, 4096, 4096, 32, 32, 112, True, None, 0): 1,
         (1, 4096, 4096, 8, 1, 256, True, None, 0): 9,
         (1, 4096, 4096, 32, 8, 128, True, None, 0): 1,
         (1, 4096, 4096, 16, 2, 128, True, None, 0): 9,
         (1, 4096, 4096, 96, 8, 128, True, None, 0): 1}
# ragged, windowed and offset shapes: Sk no multiple of a key block, GQA,
# MQA at 256 (64-key blocks), a window with q_offset > 0, non-causal
SMALL = [(1, 300, 1000, 8, 1, 256, True, 200, 700),
         (2, 250, 700, 16, 2, 80, True, 300, 450),
         (2, 129, 129, 8, 2, 112, True, None, 0),
         (1, 1000, 1000, 8, 2, 128, True, None, 0),
         (1, 257, 257, 4, 2, 64, True, 100, 0),
         (1, 63, 191, 8, 2, 112, False, None, 0),
         (2, 65, 193, 4, 1, 256, True, 70, 128),
         (1, 33, 97, 2, 1, 256, True, 40, 64)]


def _seen(mask, j0, keys):
    """The query rows that see some key of ``[j0, j0 + keys)``."""
    return np.nonzero(mask[:, j0:j0 + keys].any(1).numpy())[0]


def _check_cover(case, sms):
    b, sq, sk, h, kv, d, causal, window, q_offset = case
    plan = dkdv_plan(*case, sms=sms)
    keys, rows, nsplit = plan["keys"], plan["rows"], plan["nsplit"]
    assert (keys, rows) == FK.DKDV_TILES[d]
    nkb = -(-sk // keys)
    rep = h // kv
    assert len(plan["tiles"]) == nkb
    assert 1 <= nsplit and nkb * nsplit <= 65535
    assert FK.SPLIT_WAVES[torch.bfloat16] == 1
    assert (nsplit > 1) == (kv * b * nkb < sms and max(plan["tiles"]) * rep
                            > 1)
    mask = attention_mask(sq, sk, causal, window, q_offset, "cpu")
    for kb in range(nkb):
        seen = _seen(mask, kb * keys, keys)
        ntq = plan["tiles"][kb]
        if not len(seen):
            assert ntq == 0
        else:
            # the tiles from the first seeing row's (aligned down) cover
            # every seeing row, and none is wholly unseen
            begin = int(seen[0]) // rows * rows
            tile_of = (seen - begin) // rows
            assert tile_of.max() < ntq
            assert set(tile_of.tolist()) == set(range(ntq))
        bounds = [plan["runs"][(kb, s)] for s in range(nsplit)]
        # runs tile [0, rep * ntq) in order, without gap or overlap
        assert bounds[0][0] == 0 and bounds[-1][1] == rep * ntq
        assert all(u0 <= u1 for u0, u1 in bounds)
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    return plan


@pytest.mark.parametrize("case", list(TIMED), ids=[str(c) for c in TIMED])
def test_the_split_plan_covers_every_unit_once_at_the_timed_shapes(case):
    """Every (kv head, key block, query head, query tile) the mask needs is
    in exactly one run, and on 132 SMs the dk/dv grid splits where it
    holds under one wave of 132 blocks: 9 ways at gemma_2b's and
    qwen25_3b's 64 blocks, not at the vlm's and mistral's 256 (nor
    elsewhere)."""
    assert _check_cover(case, SMS)["nsplit"] == TIMED[case]


@pytest.mark.parametrize("sms", [SMS, 8, 1])
@pytest.mark.parametrize("case", SMALL, ids=[str(c) for c in SMALL])
def test_the_split_plan_covers_every_unit_once(case, sms):
    """As above at ragged, windowed and offset shapes, on cards of 132, 8
    and 1 SMs: every small grid on 132 SMs splits."""
    plan = _check_cover(case, sms)
    if sms == SMS:
        assert plan["nsplit"] > 1


def _unit_grads(q, k, v, dout, case, j0, keys, rows, begin, g, t, kvh):
    """dK (unscaled: dS^T Q) and dV of keys ``[j0, j0 + keys)`` of kv head
    ``kvh`` from query head ``kvh * rep + g``'s rows of query tile ``t``
    (rows ``begin + t * rows`` on), as the kernels' tiles compute them
    (float64)."""
    _, sq, sk, h, kv, d, causal, window, q_offset = case
    hh = kvh * (h // kv) + g
    lo, hi = begin + t * rows, min(begin + (t + 1) * rows, sq)
    jh = min(j0 + keys, sk)
    full = attention_mask(sq, sk, causal, window, q_offset, "cpu")
    s_all = (q[0, :, hh] @ k[0, :, kvh].T) / math.sqrt(d)
    p_all = torch.softmax(s_all.masked_fill(~full, -1e30), -1)
    delta = ((p_all @ v[0, :, kvh]) * dout[0, :, hh]).sum(-1)
    p = p_all[lo:hi, j0:jh]
    ds = p * (dout[0, lo:hi, hh] @ v[0, j0:jh, kvh].T - delta[lo:hi, None])
    return ds.T @ q[0, lo:hi, hh], p.T @ dout[0, lo:hi, hh]


@pytest.mark.parametrize("case", [(1, 150, 200, 4, 1, 256, True, 60, 50),
                                  (1, 200, 200, 4, 2, 112, False, None, 0)])
def test_the_split_runs_add_up_in_split_order(case):
    """Each run's unscaled dK and dV summed over its units in order, then
    the runs added as ``flash_bwd_dkdv_sum_kernel`` adds them (``dk = sum_s
    fma(part_k[s], scale, .)``, ``dv = sum_s part_v[s]``, s = 0, 1, ...)
    equal the plain gradients (float64, so the order is the only
    difference): the plan's runs are the whole sum."""
    b, sq, sk, h, kv, d = case[:6]
    rng = np.random.default_rng(4)
    q, k, v, dout = (torch.tensor(rng.normal(size=s), dtype=torch.float64)
                     for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                               (b, sq, h, d)))
    plan = dkdv_plan(*case, sms=8)
    keys, rows, nsplit = plan["keys"], plan["rows"], plan["nsplit"]
    assert nsplit > 1
    scale = 1.0 / math.sqrt(d)
    mask = attention_mask(sq, sk, case[6], case[7], case[8], "cpu")
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kvh in range(kv):
        for kb, ntq in enumerate(plan["tiles"]):
            j0 = kb * keys
            seen = _seen(mask, j0, keys)
            begin = int(seen[0]) // rows * rows if len(seen) else 0
            jh = min(j0 + keys, sk)
            acc_k = torch.zeros((jh - j0, d), dtype=torch.float64)
            acc_v = torch.zeros_like(acc_k)
            for s in range(nsplit):
                u0, u1 = plan["runs"][(kb, s)]
                part_k = torch.zeros_like(acc_k)
                part_v = torch.zeros_like(acc_v)
                for u in range(u0, u1):
                    gk, gv = _unit_grads(q, k, v, dout, case, j0, keys, rows,
                                         begin, u // ntq, u % ntq, kvh)
                    part_k += gk
                    part_v += gv
                acc_k = part_k * scale + acc_k
                acc_v = acc_v + part_v
            dk[0, j0:jh, kvh] = acc_k
            dv[0, j0:jh, kvh] = acc_v
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kr, vr = (t.repeat_interleave(h // kv, dim=2) for t in leaves[1:])
    logits = torch.einsum("bqhd,bkhd->bhqk", leaves[0], kr) * scale
    probs = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    _, want_k, want_v = torch.autograd.grad(out, leaves, dout)
    torch.testing.assert_close(dk, want_k, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dv, want_v, rtol=1e-10, atol=1e-10)


def _cu() -> str:
    return re.sub(r"//[^\n]*", "", (build.CSRC / "flash_attention.cu")
                  .read_text())


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def test_the_plan_tiles_are_the_kernel_tiles():
    """``DKDV_TILES`` is ``(Tiles<D>::kDkdvKeys, kBwdTile)`` of the .cu at
    every head dim it builds (``HEAD_DIMS``: the ``case`` labels of both
    entries), and ``DS_DIMS`` the head dims whose ``Tiles<D>`` take the
    dS^T path."""
    text = _cu()
    default = re.search(r"struct Tiles : TileSizes<(\d+), (\d+), (\d+), "
                        r"(true|false)>", text)
    special = {int(m[1]): m.groups()[1:] for m in re.finditer(
        r"struct Tiles<(\d+)> : TileSizes<(\d+), (\d+), (\d+), "
        r"(true|false)>", text)}
    built = sorted(int(x) for x in re.findall(
        r"case (\d+): return \(int\)fwd<", text))
    assert tuple(built) == HEAD_DIMS == tuple(sorted(FK.DKDV_TILES))
    assert sorted(int(x) for x in re.findall(
        r"case (\d+):\s+return \(int\)bwd<", text)) == built
    rows = _const(text, "kBwdTile")
    for d in built:
        fwd_keys, dkdv_keys, dq_keys, ds = special.get(d, default.groups())
        assert FK.DKDV_TILES[d] == (int(dkdv_keys), rows)
        assert (ds == "true") == (d in FK.DS_DIMS)
    assert FK.DS_DIMS == (256,)


def test_the_ds_rows_are_whole_dq_blocks():
    """dS^T rows are padded to ``DQ_DS_ROWS``, the rows of a dq block
    (``kDqDsRows = kBlockRows = kBox * kConsumers``), as in the float32
    library."""
    text = _cu()
    assert "constexpr int kDqDsRows = kBlockRows;" in text
    assert "constexpr int kBlockRows = kBox * kConsumers;" in text
    assert FK.DQ_DS_ROWS == _const(text, "kBox") * _const(text, "kConsumers")


@pytest.mark.parametrize("case", list(TIMED) + SMALL,
                         ids=[str(c) for c in list(TIMED) + SMALL])
def test_the_backward_scratch_holds_the_split_and_the_ds_rows(case):
    """The bfloat16 backward's scratch in bytes: the split's float32
    partial sums ``[2, nsplit, B, Sk, KV, D]`` where it splits, then at
    head dim 256 dS^T ``[B, H, Sk, Sq]`` in bfloat16 with its rows padded
    to whole 128-row dq blocks (268 MB of dS^T at gemma_2b's shape); none
    at the LLM path's, musicgen's, zamba2's or table1's."""
    b, sq, sk, h, kv, d = case[:6]
    nsplit = dkdv_plan(*case, sms=SMS)["nsplit"]
    want = 4 * 2 * nsplit * b * sk * kv * d if nsplit > 1 else 0
    if d == 256:
        want += 2 * b * h * sk * (-(-sq // 128) * 128)
    assert FK.bwd_scratch(b, sq, sk, h, kv, d, nsplit) == want
    assert FK.bwd_scratch(b, sq, sk, h, kv, d, nsplit,
                          torch.bfloat16) == want
    if case in TIMED and TIMED[case] == 1:
        assert want == 0
    if case == (1, 4096, 4096, 8, 1, 256, True, None, 0):
        assert want - 4 * 2 * 9 * 4096 * 256 == 2 * 8 * 4096 * 4096


def test_flash_bwd_takes_the_split_before_b():
    """``flash_bwd``'s C parameters put the scratch and ``nsplit`` before
    B, as ``flash_bwd_f32``'s do, and ``build.SIGNATURES`` says so."""
    text = _cu()
    sig = re.search(r'int flash_bwd\(([^)]*)\)', text)[1]
    params = [" ".join(p.split()) for p in sig.split(",")]
    assert params[9:13] == ["void* dv", "void* part", "int nsplit", "int B"]
    row = build.SIGNATURES["flash_attention"]["flash_bwd"]
    assert row[10:12] == (build.P, build.I) and len(row) == len(params)
