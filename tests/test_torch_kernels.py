"""Kernel families of the port: their plain versions against the reference's
Pallas kernels (interpret mode) and jnp oracles on the CPU, and the CPU/CUDA
dispatch. The CUDA kernels themselves are held against their plain versions
on the card by ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cwtm import (cwtm_pallas_batched, cwtm_ref as jax_cwtm_ref,
                                cwtm_weights as jax_cwtm_weights,
                                sort_network_compares as jax_compares)
from repro.kernels.median import (median_pallas_batched,
                                  median_ref as jax_median_ref,
                                  median_weights as jax_median_weights)
from repro.kernels.pairdist import (pairdist_pallas_batched,
                                    pairdist_ref as jax_pairdist_ref)
from repro_torch import kernels as K
from repro_torch.kernels.cwtm import (cwtm, cwtm_cuda, cwtm_ref, cwtm_weights,
                                      sort_network_compares)
from repro_torch.kernels.median import (median, median_cuda, median_ref,
                                        median_weights)
from repro_torch.kernels.pairdist import pairdist, pairdist_cuda, pairdist_ref

# the reference's awkward-shape sweep (tests/test_kernels.py): n odd / not a
# power of two, d not a multiple of the tile, f=0, n-2f=1
AWKWARD = [(3, 13, 3, 300), (2, 7, 0, 130), (4, 5, 2, 257),
           (1, 19, 9, 128), (5, 4, 1, 64), (2, 16, 3, 1024)]


def _x(b, n, d, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(b, n, d)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("b,n,f,d", AWKWARD)
def test_cwtm_plain_matches_reference(b, n, f, d):
    x = _x(b, n, d, b * d + n)
    got = cwtm_ref(torch.tensor(x), f).numpy()
    for want in (cwtm_pallas_batched(jnp.asarray(x), f, block_d=256,
                                     interpret=True),
                 jax_cwtm_ref(jnp.asarray(x), f)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b,n,f,d", AWKWARD[:3])
def test_cwtm_plain_bf16(b, n, f, d):
    x = _x(b, n, d, 7)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_cwtm_ref(xb, f), np.float32)
    got = cwtm_ref(torch.tensor(x).to(torch.bfloat16), f)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("b,n,f,d", AWKWARD)
def test_median_plain_matches_reference(b, n, f, d):
    x = _x(b, n, d, b * d + n + 1)
    got = median_ref(torch.tensor(x)).numpy()
    for want in (median_pallas_batched(jnp.asarray(x), block_d=256,
                                       interpret=True),
                 jax_median_ref(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,n,f,d", AWKWARD[:4])
def test_sort_plain_versions_with_nan_match_the_reference(b, n, f, d):
    """NaN and +-inf among a coordinate's values (a float8 bank's ALIE rows
    can hold NaN): the median is NaN wherever a NaN is present, as the
    reference's ``jnp.median`` and its Pallas kernel give; CWTM sorts NaN
    last and trims it at a trimmed rank, as the reference's ``jnp.sort``
    oracle (the one its CPU rounds take) does."""
    x = _x(b, n, d, b * d + n + 3)
    rng = np.random.default_rng(d)
    cols = np.arange(d)
    for k in (1, 2):
        pick = cols[cols % 3 == k]
        for _ in range(k):
            x[:, rng.integers(n, size=pick.size), pick] = np.nan
    x[:, rng.integers(n), ::7] = np.inf
    x[:, rng.integers(n), ::11] = -np.inf
    got = median_ref(torch.tensor(x)).numpy()
    assert np.isnan(got).any()
    for want in (median_pallas_batched(jnp.asarray(x), block_d=256,
                                       interpret=True),
                 jax_median_ref(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cwtm_ref(torch.tensor(x), f).numpy(),
                               np.asarray(jax_cwtm_ref(jnp.asarray(x), f)),
                               rtol=1e-5, atol=1e-5)


def test_median_even_n_is_midpoint_not_lower():
    """``torch.median`` returns the lower middle; the port keeps jnp's
    midpoint."""
    x = torch.tensor([[[1.0], [2.0], [4.0], [8.0]]])
    assert float(median_ref(x)) == 3.0
    assert float(torch.median(x, dim=1).values) == 2.0


@pytest.mark.parametrize("b,n,f,d", AWKWARD)
def test_pairdist_plain_matches_reference(b, n, f, d):
    x = _x(b, n, d, b * d + n + 2)
    got = pairdist_ref(torch.tensor(x)).numpy()
    assert got.shape == (b, n, n)
    for want in (pairdist_pallas_batched(jnp.asarray(x), block_d=256,
                                         interpret=True),
                 jax_pairdist_ref(jnp.asarray(x))):
        # atol covers the jnp oracle's diagonal cancellation noise
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-2,
                                   rtol=1e-5)
    diag = got[:, np.arange(n), np.arange(n)]
    np.testing.assert_array_equal(diag, np.zeros_like(diag))


def test_cwtm_handles_outliers():
    x = _x(1, 10, 512, 0, scale=1.0)
    x[:, :3] = 1e9
    got = cwtm(torch.tensor(x), 3)
    want = cwtm_pallas_batched(jnp.asarray(x), 3, block_d=256, interpret=True)
    assert float(got.abs().max()) < 10.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,f", [(13, 3), (4, 1), (19, 9), (7, 0), (64, 20)])
def test_rank_weights_match_reference(n, f):
    assert cwtm_weights(n, f) == jax_cwtm_weights(n, f)
    assert median_weights(n) == jax_median_weights(n)


@pytest.mark.parametrize("n_pad", [2, 4, 8, 16, 32, 64])
def test_sort_network_size(n_pad):
    assert sort_network_compares(n_pad) == jax_compares(n_pad)


@pytest.mark.parametrize("op,args", [(pairdist, ()), (cwtm, (2,)),
                                     (median, ())])
def test_ops_dispatch_cpu_2d_and_3d(op, args):
    x = torch.tensor(_x(3, 9, 70, 4))
    K.reset_launches()
    batched = op(x, *args)
    rows = torch.stack([op(r, *args) for r in x])
    torch.testing.assert_close(batched, rows, rtol=1e-6, atol=1e-6)
    launches = K.launches()
    assert {"pairdist", "cwtm", "median"} <= set(launches)
    assert launches == {k: 0 for k in launches}


@pytest.mark.parametrize("wrapper,args", [(pairdist_cuda, ()),
                                          (cwtm_cuda, (1,)),
                                          (median_cuda, ())])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(torch.zeros(1, 5, 8), *args)
    assert wrapper.launches == 0


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError):
        pairdist(torch.zeros(5, 8, device="meta"))
