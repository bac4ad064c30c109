"""Flat-vector layer of the port against ``repro.utils.tree``: the same
leaves, in the same order, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sweep import quadratic_testbed as jax_quadratic
from repro.models import cnn_init as jax_cnn_init
from repro.utils import tree as JT
from repro_torch.models import cnn_init
from repro_torch.testing import from_jax_params
from repro_torch.utils import tree as T


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_cnn_flat_vector_bitwise():
    params = jax_cnn_init(jax.random.PRNGKey(0))
    want = np.asarray(JT.tree_ravel(params))
    ported = from_jax_params(_np_tree(params))
    got = T.tree_ravel(ported).numpy()
    assert got.shape == want.shape == (11958,)
    np.testing.assert_array_equal(got, want)


def test_cnn_leaf_order_and_offsets():
    """JAX visits dict keys sorted, so each layer's ``b`` precedes ``w``."""
    jspec = JT.make_flat_spec(jax_cnn_init(jax.random.PRNGKey(0)))
    spec = T.make_flat_spec(cnn_init(0))
    assert spec.size == jspec.size == 11958
    assert spec.offsets == jspec.offsets == (0, 8, 80, 88, 664, 692, 11668,
                                             11678)
    assert spec.shapes == jspec.shapes
    leaves = T.tree_leaves(cnn_init(0))
    assert [tuple(l.shape) for l in leaves] == [
        (8,), (3, 3, 1, 8), (8,), (3, 3, 8, 8), (28,), (392, 28), (10,),
        (28, 10)]


def test_quadratic_flat_vector_bitwise():
    _, params, _, _ = jax_quadratic(13, d=64, seed=0)
    params = {"w": params["w"] + jnp.arange(64, dtype=jnp.float32)}
    want = np.asarray(JT.tree_ravel(params))
    np.testing.assert_array_equal(
        T.tree_ravel(from_jax_params(_np_tree(params))).numpy(), want)


@pytest.mark.parametrize("pad_to", [1, 8, 128])
def test_unravel_roundtrip_and_padding(pad_to):
    params = from_jax_params(_np_tree(jax_cnn_init(jax.random.PRNGKey(1))))
    spec = T.make_flat_spec(params, pad_to=pad_to)
    jspec = JT.make_flat_spec(jax_cnn_init(jax.random.PRNGKey(1)),
                              pad_to=pad_to)
    assert (spec.padded_size, spec.pad) == (jspec.padded_size, jspec.pad)
    flat = T.tree_ravel(params, spec)
    assert flat.shape == (spec.padded_size,)
    back = T.tree_unravel(flat, spec)
    for a, b in zip(T.tree_leaves(back), T.tree_leaves(params)):
        assert torch.equal(a, b)


def test_stacked_ravel_bitwise():
    trees = [jax_cnn_init(jax.random.PRNGKey(s)) for s in range(3)]
    stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *trees)
    spec = JT.make_flat_spec(trees[0])
    want = np.asarray(JT.stacked_ravel(stacked, spec))
    ported = from_jax_params(_np_tree(stacked))
    got = T.stacked_ravel(ported, T.make_flat_spec(cnn_init(0)))
    np.testing.assert_array_equal(got.numpy(), want)
    back = T.stacked_unravel(got, T.make_flat_spec(cnn_init(0)))
    np.testing.assert_array_equal(T.stacked_ravel(back).numpy(), want)


def _cnn_pair():
    params = jax_cnn_init(jax.random.PRNGKey(1))
    return params, from_jax_params(_np_tree(params))


def test_tree_size_cast_add_scale_match():
    params, ported = _cnn_pair()
    assert T.tree_size(ported) == JT.tree_size(params) == 11958
    half = T.tree_cast(ported, torch.bfloat16)
    jhalf = JT.tree_cast(params, jnp.bfloat16)
    for got, want in zip(T.tree_leaves(half), jax.tree_util.tree_leaves(jhalf)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    summed = T.tree_add(ported, ported)
    scaled = T.tree_scale(ported, 0.3)
    jsum = JT.tree_add(params, params)
    jscaled = JT.tree_scale(params, 0.3)
    for got, want in zip(T.tree_leaves(summed) + T.tree_leaves(scaled),
                         jax.tree_util.tree_leaves(jsum)
                         + jax.tree_util.tree_leaves(jscaled)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_global_norm_matches():
    """Leaf by leaf float32 sums of squares, summed in leaf order: rtol
    1e-6 (the leaves' reductions run in other orders)."""
    params, ported = _cnn_pair()
    np.testing.assert_allclose(float(T.global_norm(ported)),
                               float(JT.global_norm(params)), rtol=1e-6)
    assert T.global_norm(T.tree_cast(ported, torch.bfloat16)).dtype == \
        torch.float32


def test_lanes_ravel_is_stacked_ravel_per_lane():
    _, ported = _cnn_pair()
    spec = T.make_flat_spec(ported, pad_to=16)
    lanes = T.tree_map(lambda l: torch.stack([l * i for i in range(6)])
                       .reshape((2, 3) + l.shape), ported)
    flat = T.lanes_ravel(lanes, spec)
    assert flat.shape == (2, 3, spec.padded_size)
    for i in range(6):
        assert torch.equal(flat.reshape(6, -1)[i], T.tree_ravel(
            T.tree_map(lambda l: l * i, ported), spec))
