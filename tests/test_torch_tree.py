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
