"""Block-RandK of the port against the reference: the plain compress and
decompress against the Pallas kernels (interpret mode), the block
``compressed_estimate`` (kernel round trip and dense path, global and local
masks) against the reference's with its own draws replayed, and the
``block_hash`` mask from the same uint32 seed. All bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels.randk import block_compress, block_decompress
from repro_torch.core import compression as C
from repro_torch.kernels.randk import (block_compress_cuda,
                                       block_compress_ref,
                                       block_decompress_ref, compress,
                                       decompress, slot_map)
from repro_torch.testing import ReplayDraws, TorchDraws


def _bank(n, d, seed, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=(n, d)) * 2).astype(dtype)


def _ids(nb, kb, seed, rows=None):
    rng = np.random.default_rng(seed)
    if rows is None:
        return rng.permutation(nb)[:kb].astype(np.int32)
    return np.stack([rng.permutation(nb)[:kb] for _ in range(rows)]
                    ).astype(np.int32)


@pytest.mark.parametrize("d,bs,kb", [(2048, 128, 4), (4096, 256, 7),
                                     (8192, 512, 3), (1024, 128, 8),
                                     (512, 128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local", [False, True])
def test_plain_block_kernels_match_pallas(d, bs, kb, dtype, local):
    """Bitwise against ``block_compress`` / ``block_decompress`` in
    interpret mode, row by row (the reference maps rows one at a time)."""
    n = 3
    g = _bank(n, d, d + kb)
    ids = _ids(d // bs, kb, bs, rows=n if local else None)
    alpha = (d // bs) / kb
    tg = torch.tensor(g).to(getattr(torch, dtype))
    got = block_compress_ref(tg, torch.tensor(ids), bs, alpha)
    dense = block_decompress_ref(got, torch.tensor(ids), bs, d)
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    for r in range(n):
        row_ids = jnp.asarray(ids[r] if local else ids)
        want = block_compress(jg[r], row_ids, bs, alpha, interpret=True)
        np.testing.assert_array_equal(got[r].float().numpy(),
                                      np.asarray(want, np.float32))
        want_d = block_decompress(want, row_ids, bs, d, interpret=True)
        np.testing.assert_array_equal(dense[r].float().numpy(),
                                      np.asarray(want_d, np.float32))


def test_decompress_writes_zeros_off_the_selected_blocks():
    g = torch.tensor(_bank(2, 1024, 0))
    ids = torch.tensor([5, 0], dtype=torch.int32)
    dense = decompress(compress(g, ids, block_size=128, alpha=4.0), ids,
                       block_size=128, d=1024)
    sel = torch.zeros(8, dtype=torch.bool)
    sel[[0, 5]] = True
    blocks = dense.reshape(2, 8, 128)
    assert torch.equal(blocks[:, ~sel], torch.zeros_like(blocks[:, ~sel]))
    assert torch.equal(blocks[:, sel], g.reshape(2, 8, 128)[:, sel] * 4.0)


def test_slot_map_global_and_local():
    got = slot_map(torch.tensor([3, 0, 6]), 8)
    assert got.tolist() == [1, -1, -1, 0, -1, -1, 2, -1]
    assert got.dtype == torch.int32
    loc = slot_map(torch.tensor([[1, 2], [7, 0]]), 8)
    assert loc.tolist() == [[-1, 0, 1, -1, -1, -1, -1, -1],
                            [1, -1, -1, -1, -1, -1, -1, 0]]


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        block_compress_cuda(torch.zeros(2, 512), torch.tensor([0]), 512, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        compress(torch.zeros(2, 512, device="meta"), torch.tensor([0]),
                 block_size=512, alpha=1.0)


def _cfgs(kind, ratio, bs, local, kernels):
    return (JC.SparsifierConfig(kind=kind, ratio=ratio, block_size=bs,
                                local=local, use_pallas=kernels),
            C.SparsifierConfig(kind=kind, ratio=ratio, block_size=bs,
                               local=local, use_kernels=kernels))


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("ratio", [0.05, 0.3])
def test_block_compressed_estimate_bitwise(local, kernels, ratio):
    """The port's Block-RandK estimate against the reference's (use_pallas
    True: the interpret-mode kernel round trip; False: the jnp mask
    multiply), from the reference's own block ids."""
    n, d, bs = 5, 128 * 48, 128
    jcfg, cfg = _cfgs("block", ratio, bs, local, kernels)
    g = _bank(n, d, 7)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(
        lambda g, k: JC.compressed_estimate(g, k, jcfg))(g, key))
    nb = d // bs
    kb = max(1, int(round(ratio * nb)))
    keys = jax.random.split(key, n) if local else [key]
    perms = [np.asarray(jax.random.permutation(k, nb)[:kb]) for k in keys]
    draws = ReplayDraws("cpu", permutations=perms)
    got = C.compressed_estimate(torch.tensor(g), draws, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert draws.remaining == 0


def test_block_kernel_path_needs_aligned_d():
    """d not a multiple of the block: the dense path, as the reference's
    ``_kernel_eligible`` rules (the mask covers the ragged last block)."""
    _, cfg = _cfgs("block", 0.5, 128, False, True)
    assert not C._kernel_eligible(cfg, 1000)
    assert C._kernel_eligible(cfg, 1024)
    g = torch.ones(2, 1000)
    out = C.compressed_estimate(g, TorchDraws(0, "cpu"), cfg)
    kept = (out[0] != 0).reshape(-1)
    assert torch.equal(out[0], out[1])
    assert int(kept.sum()) in (4 * 128, 3 * 128 + 1000 - 7 * 128)


@pytest.mark.parametrize("key_seed", [0, 1, 77, 2024])
@pytest.mark.parametrize("d,block,ratio", [(4096, 512, 0.05), (1000, 128, 0.3),
                                           (65536, 256, 0.5)])
def test_block_hash_mask_bitwise(key_seed, d, block, ratio):
    """Same uint32 seed, same mask: the reference's murmur-style hash over
    block ids (``compression.py:94-118``) from its key, the port's from the
    seed ``bits(key, (), uint32)`` that key gives."""
    key = jax.random.PRNGKey(key_seed)
    want = np.asarray(JC._block_hash_mask(key, d, ratio, block, jnp.float32))
    seed = int(jax.random.bits(key, (), jnp.uint32))
    got = C.make_mask(ReplayDraws("cpu", bits=[seed]), d, C.SparsifierConfig(
        kind="block_hash", ratio=ratio, block_size=block))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("local", [False, True])
def test_block_hash_compressed_estimate_bitwise(local):
    """The whole estimate from the reference's key: its seeds
    (``bits(key, (), uint32)`` per mask key) replayed into the port."""
    n, d = 4, 4096
    jcfg, cfg = _cfgs("block_hash", 0.25, 256, local, True)
    g = _bank(n, d, 11)
    key = jax.random.PRNGKey(21)
    want = np.asarray(JC.compressed_estimate(g, key, jcfg))
    keys = jax.random.split(key, n) if local else [key]
    bits = [int(jax.random.bits(k, (), jnp.uint32)) for k in keys]
    got = C.compressed_estimate(torch.tensor(g),
                                ReplayDraws("cpu", bits=bits), cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_draws_bits_are_uint32():
    draws = TorchDraws(5, "cpu")
    vals = [draws.bits_u32() for _ in range(64)]
    assert all(0 <= v < 2 ** 32 for v in vals)
    assert len(set(vals)) == 64
    with pytest.raises(LookupError):
        ReplayDraws("cpu").bits_u32()


@pytest.mark.parametrize("d", [4096, 1048576, 416_179_200])
def test_block_byte_accounting_equal(d):
    jcfg, cfg = _cfgs("block", 0.05, 512, False, True)
    assert C.payload_floats(d, cfg) == JC.payload_floats(d, jcfg)
    assert C.payload_bytes(d, cfg) == JC.payload_bytes(d, jcfg)
