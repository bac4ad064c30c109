"""The float32 flash kernels' launch plan and routing, on the CPU.

``flash.dkdv_plan`` splits the float32 dk/dv kernel's blocks where its grid
would not fill the card: each key block's (query head, query tile) units
go in contiguous runs to ``nsplit`` blocks, whose partial sums the sum pass
adds in split order. Here the plan is held to the visibility mask (every
pair a key block needs is in exactly one run, at the timed shapes and small
ones), its runs are summed as the kernels sum them and give the plain
gradients, its tile table is the ``.cu``'s, and head dim 112 is routed
unpadded at float32 (against the reference's attention at 112) as at
bfloat16."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (F32_HEAD_DIMS, HEAD_DIMS,
                                                 FlashAttention, attention_mask,
                                                 dkdv_plan, head_dims,
                                                 padded_dim)
from repro_torch.kernels.flash_attention import flash as FK
from repro_torch.kernels.flash_attention import ops as FO


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMS = 132  # an H100's SMs
# (B, Sq, Sk, H, KV, D, causal, window, q_offset): the four timed float32
# shapes (zamba2's, gemma_2b's, the vlm's, the LLM cut's), then small ones:
# windows, offsets, Sk no multiple of a key block, GQA, MQA, non-causal
TIMED = [(1, 4096, 4096, 32, 32, 112, True, None, 0),
         (1, 4096, 4096, 8, 1, 256, True, None, 0),
         (1, 4096, 4096, 32, 8, 128, True, None, 0),
         (1, 4096, 4096, 32, 32, 80, True, None, 0)]
SMALL = [(1, 300, 1000, 8, 1, 256, True, 200, 700),
         (2, 250, 700, 16, 2, 80, True, 300, 450),
         (2, 129, 129, 8, 2, 112, True, None, 0),
         (1, 257, 257, 4, 2, 64, True, 100, 0),
         (1, 63, 191, 8, 2, 128, False, None, 0),
         (2, 65, 193, 4, 1, 80, True, 70, 128),
         (1, 33, 97, 2, 1, 256, True, 40, 64)]


def _visible_rows(case, j0, keys):
    """The query rows that see some key of ``[j0, j0 + keys)``."""
    _, sq, sk, _, _, _, causal, window, q_offset = case
    mask = attention_mask(sq, sk, causal, window, q_offset, "cpu")
    return set(np.nonzero(mask[:, j0:j0 + keys].any(1).numpy())[0])


@pytest.mark.parametrize("sms", [SMS, 8, 1])
@pytest.mark.parametrize("case", TIMED + SMALL,
                         ids=[str(c) for c in TIMED + SMALL])
def test_the_split_plan_covers_every_unit_once(case, sms):
    """Every (kv head, key block, query head, query tile) the mask needs is
    in exactly one run: a key block's runs tile ``[0, rep * tiles)`` in
    order without gap or overlap, its tiles cover every query row that sees
    one of its keys, and at the timed shapes on 132 SMs only gemma_2b's
    grid (64 key blocks of one kv head) splits."""
    b, sq, sk, h, kv, d = case[:6]
    plan = dkdv_plan(*case, sms=sms, dtype=torch.float32)
    keys, rows, nsplit = plan["keys"], plan["rows"], plan["nsplit"]
    nkb = -(-sk // keys)
    rep = h // kv
    assert len(plan["tiles"]) == nkb
    assert 1 <= nsplit and nkb * nsplit <= 65535
    assert FK.SPLIT_WAVES[torch.float32] == 2
    assert (nsplit > 1) == (kv * b * nkb < 2 * sms and max(plan["tiles"]) * rep
                            > 1)
    if sms == SMS and case in TIMED:
        assert (nsplit > 1) == (d == 256)
    for kb in range(nkb):
        j0 = kb * keys
        seen = _visible_rows(case, j0, keys)
        ntq = plan["tiles"][kb]
        if not seen:
            assert ntq == 0
        else:
            begin = min(seen) // rows * rows
            covered = set(range(begin, begin + ntq * rows))
            assert seen <= covered
            # no tile is wholly unseen
            assert all(seen & set(range(begin + t * rows,
                                        begin + (t + 1) * rows))
                       for t in range(ntq))
        units = []
        for s in range(nsplit):
            u0, u1 = plan["runs"][(kb, s)]
            assert u0 <= u1
            units += range(u0, u1)
        assert units == list(range(rep * ntq))
        # each unit is one (query head, query tile) of the key block's
        pairs = {(u // ntq, u % ntq) for u in units} if ntq else set()
        assert pairs == {(g, t) for g in range(rep) for t in range(ntq)}


def _unit_grads(q, k, v, dout, case, j0, keys, rows, begin, g, t, kvh):
    """dK (unscaled: dS^T Q) and dV of keys ``[j0, j0 + keys)`` of kv head
    ``kvh`` from query head ``kvh * rep + g``'s rows of query tile ``t``
    (rows ``begin + t * rows`` on), as the kernels' tiles compute them
    (float64)."""
    _, sq, sk, h, kv, d, causal, window, q_offset = case
    hh = kvh * (h // kv) + g
    lo, hi = begin + t * rows, min(begin + (t + 1) * rows, sq)
    jh = min(j0 + keys, sk)
    scale = 1.0 / math.sqrt(d)
    qs, dos = q[0, lo:hi, hh], dout[0, lo:hi, hh]
    ks, vs = k[0, j0:jh, kvh], v[0, j0:jh, kvh]
    full = attention_mask(sq, sk, causal, window, q_offset, "cpu")
    s_all = (q[0, :, hh] @ k[0, :, kvh].T) * scale
    s_all = s_all.masked_fill(~full, -1e30)
    p_all = torch.softmax(s_all, -1)
    o = p_all @ v[0, :, kvh]
    delta = (o * dout[0, :, hh]).sum(-1)
    p = p_all[lo:hi, j0:jh]
    dp = dos @ vs.T
    ds = p * (dp - delta[lo:hi, None])
    return ds.T @ qs, p.T @ dos


@pytest.mark.parametrize("case", [(1, 150, 200, 4, 1, 64, True, 60, 50),
                                  (1, 96, 96, 4, 2, 80, False, None, 0)])
def test_the_split_runs_add_up_in_split_order(case):
    """Each run's unscaled dK and dV summed over its units in order, then
    the runs added as the sum pass adds them (``dk = sum_s fma(part_k[s],
    scale, .)``, ``dv = sum_s part_v[s]``, s = 0, 1, ...) equal the plain
    gradients: the plan's runs are the whole sum, in a fixed order."""
    b, sq, sk, h, kv, d = case[:6]
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.tensor(rng.normal(size=s), dtype=torch.float64)
                     for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                               (b, sq, h, d)))
    plan = dkdv_plan(*case, sms=2, dtype=torch.float32)
    keys, rows, nsplit = plan["keys"], plan["rows"], plan["nsplit"]
    assert nsplit > 1
    scale = 1.0 / math.sqrt(d)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for kvh in range(kv):
        for kb, ntq in enumerate(plan["tiles"]):
            j0 = kb * keys
            seen = _visible_rows(case, j0, keys)
            begin = min(seen) // rows * rows if seen else 0
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
    # the dense attention in float64 (attention_ref computes in float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    mask = attention_mask(sq, sk, case[6], case[7], case[8], "cpu")
    kr, vr = (t.repeat_interleave(h // kv, dim=2) for t in leaves[1:])
    logits = torch.einsum("bqhd,bkhd->bhqk", leaves[0], kr) * scale
    probs = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    _, want_k, want_v = torch.autograd.grad(out, leaves, dout)
    torch.testing.assert_close(dk, want_k, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dv, want_v, rtol=1e-10, atol=1e-10)


def test_the_plan_tiles_are_the_kernel_tiles():
    """``F32_DKDV_TILES`` is ``DkdvTile<D>`` of the .cu (16 RM keys a
    block, 16 KW query rows a tile), and the float32 library is built for
    ``F32_HEAD_DIMS``; ``flash_bwd_f32`` takes the split's scratch and
    ``nsplit`` before B."""
    text = (build.CSRC / "flash_attention_f32.cu").read_text()
    tiles = {int(m[1]): (16 * int(m[2]), 16 * int(m[3])) for m in re.finditer(
        r"struct DkdvTile<(\d+)> : Tile<\d+, (\d+), (\d+),", text)}
    assert tiles == FK.F32_DKDV_TILES
    assert tuple(sorted(tiles)) == F32_HEAD_DIMS
    assert sorted(int(x) for x in re.findall(
        r"case (\d+): return \(int\)fwd<", text)) == list(F32_HEAD_DIMS)
    sig = re.search(r'int flash_bwd_f32\(([^)]*)\)', text)[1]
    params = [" ".join(p.split()) for p in sig.split(",")]
    assert params[10:13] == ["void* part", "int nsplit", "int B"]


@pytest.mark.parametrize("case", TIMED + SMALL,
                         ids=[str(c) for c in TIMED + SMALL])
def test_the_backward_scratch_holds_the_split_and_the_ds_rows(case):
    """The float32 backward's scratch: the split's partial sums ``[2,
    nsplit, B, Sk, KV, D]`` where it splits, then at head dim 256 dS^T
    ``[B, H, Sk, Sq]`` with rows padded to whole 128-row dq blocks (the
    .cu's ``DqDsTile``, ``kDsPath``), float32 both, counted in bytes; none
    at the LLM cut's shape."""
    b, sq, sk, h, kv, d = case[:6]
    nsplit = dkdv_plan(*case, sms=SMS, dtype=torch.float32)["nsplit"]
    want = 2 * nsplit * b * sk * kv * d if nsplit > 1 else 0
    if d == 256:
        want += b * h * sk * (-(-sq // 128) * 128)
    assert FK.bwd_scratch(b, sq, sk, h, kv, d, nsplit,
                          torch.float32) == 4 * want
    if case == TIMED[-1]:
        assert want == 0
    text = (build.CSRC / "flash_attention_f32.cu").read_text()
    assert "constexpr bool kDsPath = D == 256;" in text
    assert FK.DS_DIMS == (256,) and FK.DQ_DS_ROWS == 16 * int(
        re.search(r"struct DqDsTile : Tile<D, (\d+),", text)[1])


def test_head_dim_112_is_native_at_float32_and_bfloat16():
    """Routing: both dtypes run the kernel at 112 as it is (the default
    scale), 192 zero-padded to 256, the other head dims as they are."""
    assert padded_dim(112, torch.float32) == 112
    assert padded_dim(112, torch.bfloat16) == padded_dim(112) == 112
    assert padded_dim(192, torch.float32) == padded_dim(192) == 256
    assert 112 in head_dims(torch.float32) and 112 in head_dims(None)
    assert head_dims(torch.bfloat16) == HEAD_DIMS == F32_HEAD_DIMS
    seen = []

    def attend(q, k, v, causal, window, q_offset, scale=None):
        seen.append((q.shape[-1], q.dtype, scale))
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)[0]
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 2, 112), dtype=dtype)
        out = FO.kernel_attention(attend, q, q, q, True, None, 0)
        assert out.shape == q.shape
    assert seen == [(112, torch.float32, None), (112, torch.bfloat16, None)]


@pytest.mark.parametrize("window,q_offset", [(None, 0), (40, 32)])
def test_float32_at_112_unpadded_matches_the_reference(window, q_offset):
    """Float32 at head dim 112 through the kernels' route as it runs on the
    card (no pad, the default scale 1/sqrt(112)), here on its plain
    version: out and the gradients against the reference's
    ``attention_ref`` at 112 and ``jax.grad`` of it, within 1e-5 of the
    largest entry."""
    rng = np.random.default_rng(112 + q_offset)
    sq, sk = 80, 80 + q_offset
    q, k, v, dout = (rng.normal(size=s).astype(np.float32) for s in (
        (2, sq, 4, 112), (2, sk, 2, 112), (2, sk, 2, 112), (2, sq, 4, 112)))

    def attend(q, k, v, causal, window, q_offset, scale=None):
        assert q.shape[-1] == 112 and scale is None
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)[0]
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = FO.kernel_attention(attend, *leaves, True, window, q_offset)

    def jloss(q, k, v):
        out = jax_attention_ref(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
        return jnp.sum(out * dout), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    pairs = [(got.detach().numpy(), np.asarray(want))] + list(zip(
        (g.numpy() for g in torch.autograd.grad(got, leaves,
                                                torch.tensor(dout))),
        (np.asarray(g) for g in grads)))
    for a, w in pairs:
        assert a.dtype == np.float32 and a.shape == w.shape
        assert float(np.abs(a - w).max()) <= 1e-5 * float(np.abs(w).max())


@pytest.mark.parametrize("d,dtype,pad,match", [
    (96, torch.float32, False, "head dims"),
    (320, torch.float32, True, "head dims"),
    (48, torch.float32, False, "head dims"),
    (192, torch.bfloat16, False, "head dims"),
    (112, torch.float16, True, "bfloat16 or float32"),
    (112, torch.float32, False, "needs CUDA"),
    (96, torch.float32, True, "needs CUDA")])
def test_the_float32_wrappers_refuse_what_the_kernels_do_not_take(
        d, dtype, pad, match):
    """``refusal`` names why (a head dim neither built nor padded, a dtype
    of neither library; on the CPU last of all the device), and the
    float32 wrappers raise it rather than fall back: on CPU tensors they
    launch nothing."""
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    why = FK.refusal(q, q, q, True, None, 0, pad=pad)
    assert why is not None and match in why[1]
    with pytest.raises((TypeError, ValueError)):
        FK.flash_fwd_f32_cuda(q, q, q)
    with pytest.raises((TypeError, ValueError)):
        FK.flash_bwd_f32_cuda(q, q, q, q, torch.zeros((1, 2, 8)), q)
    assert FK.flash_fwd_f32_cuda.launches == 0
    assert FK.flash_bwd_f32_cuda.launches == 0
