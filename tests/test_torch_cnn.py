"""The paper's CNN in the port against ``repro.models.cnn``: logits, loss and
per-worker gradients, from the reference's own parameters.

Tolerance: rtol 1e-5 on logits and loss, and 1e-4 of the largest gradient
entry on gradients — float32 convolutions summed in another order (XLA's
CPU convolution against PyTorch's), no change of precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary.heterogeneity import dirichlet_mnist as jax_dirichlet
from repro.models import cnn_accuracy as jax_acc
from repro.models import cnn_apply as jax_apply
from repro.models import cnn_init as jax_init
from repro.models import cnn_loss as jax_loss
from repro.utils import tree as JT
from repro_torch.adversary.heterogeneity import dirichlet_mnist
from repro_torch.models import cnn_accuracy, cnn_apply, cnn_init, cnn_loss
from repro_torch.testing import from_jax_params
from repro_torch.utils import tree as T


@pytest.fixture(scope="module")
def setup():
    params = jax_init(jax.random.PRNGKey(0))
    ported = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    batches = dirichlet_mnist(n_workers=3, per_worker=20, seed=3
                              ).worker_batches(8)(0)
    return params, ported, batches


def test_same_data_from_the_same_seed():
    a = dirichlet_mnist(n_workers=3, per_worker=20, seed=5)
    b = jax_dirichlet(n_workers=3, per_worker=20, seed=5)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.eval_images, b.eval_images)
    fa, fb = a.worker_batches(7), b.worker_batches(7)
    for t in range(3):
        ba, bb = fa(t), fb(t)
        np.testing.assert_array_equal(ba["images"], bb["images"])
        np.testing.assert_array_equal(ba["labels"], bb["labels"])


def test_logits_loss_accuracy(setup):
    params, ported, batches = setup
    imgs, labs = batches["images"][0], batches["labels"][0]
    want = np.asarray(jax_apply(params, jnp.asarray(imgs)))
    got = cnn_apply(ported, torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    b = {"images": imgs, "labels": labs}
    tb = {"images": torch.tensor(imgs), "labels": torch.tensor(labs)}
    np.testing.assert_allclose(float(cnn_loss(ported, tb)),
                               float(jax_loss(params, b)), rtol=1e-5)
    assert float(cnn_accuracy(ported, tb)) == float(jax_acc(params, b))


def test_fc1_flatten_order_is_hwc(setup):
    """Permuting fc1's rows from (H, W, C) to (C, H, W) order changes the
    logits: the flatten order is part of the parameter layout."""
    _, ported, batches = setup
    x = torch.tensor(batches["images"][0])
    w = ported["fc1"]["w"]
    chw = w.reshape(7, 7, 8, 28).permute(2, 0, 1, 3).reshape(392, 28)
    other = {**ported, "fc1": {"w": chw, "b": ported["fc1"]["b"]}}
    assert not torch.allclose(cnn_apply(other, x), cnn_apply(ported, x))


def test_per_worker_gradients(setup):
    params, ported, batches = setup
    spec = JT.make_flat_spec(params)
    want = np.asarray(jax.vmap(
        lambda b: JT.tree_ravel(jax.grad(jax_loss)(params, b), spec))(
            jax.tree_util.tree_map(jnp.asarray, batches)))
    grad_fn = torch.func.vmap(torch.func.grad_and_value(cnn_loss),
                              in_dims=(None, 0))
    g, losses = grad_fn(ported, {k: torch.tensor(v)
                                 for k, v in batches.items()})
    got = T.stacked_ravel(g, T.make_flat_spec(ported)).numpy()
    assert got.shape == want.shape == (3, 11958)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_init_shapes_match_reference():
    spec = T.make_flat_spec(cnn_init(1))
    jspec = JT.make_flat_spec(jax_init(jax.random.PRNGKey(1)))
    assert spec.shapes == jspec.shapes and spec.offsets == jspec.offsets
    assert all(dt == torch.float32 for dt in spec.dtypes)
