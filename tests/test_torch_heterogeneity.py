"""Heterogeneity control and measurement of the port
(``repro_torch.adversary.heterogeneity``) against the reference's: the
numpy partitioners and label summaries bitwise from the same generator, and
the (G, B)-dissimilarity probe on the reference's own probe offsets within
rtol 1e-5 (the aggregation bar: per-worker gradients of a least-squares
loss, then float32 sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary import heterogeneity as JH
from repro_torch.adversary import heterogeneity as H


@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_partitions_and_summaries_are_the_references(alpha):
    props = H.dirichlet_proportions(np.random.default_rng(4), 7, 10, alpha)
    np.testing.assert_array_equal(props, JH.dirichlet_proportions(
        np.random.default_rng(4), 7, 10, alpha))
    labels = np.random.default_rng(1).integers(0, 10, 500)
    got = H.partition_pool(np.random.default_rng(2), labels, 6, alpha)
    want = JH.partition_pool(np.random.default_rng(2), labels, 6, alpha)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(500))
    stacked = np.stack([np.random.default_rng(w).integers(0, 10, 60)
                        for w in range(6)])
    hists = H.label_histograms(stacked, 10)
    np.testing.assert_array_equal(hists, JH.label_histograms(stacked, 10))
    assert H.label_skew(hists) == JH.label_skew(hists)


def test_dirichlet_mnist_split_is_the_references():
    ds = H.dirichlet_mnist(n_workers=5, alpha=0.5, per_worker=40, seed=3)
    jds = JH.dirichlet_mnist(n_workers=5, alpha=0.5, per_worker=40, seed=3)
    np.testing.assert_array_equal(ds.label_props, jds.label_props)
    np.testing.assert_array_equal(ds.labels, jds.labels)


def _least_squares(n=7, m=16, d=12, seed=0):
    """Worker i holds its own regression ``(X_i, y_i)``: the gradients'
    spread grows with the distance from the optimum, so both G and B are
    positive."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, d)).astype(np.float32)
    x *= (1.0 + 0.3 * np.arange(n, dtype=np.float32))[:, None, None]
    y = rng.normal(size=(n, m)).astype(np.float32)
    w0 = (0.5 * rng.normal(size=(d,))).astype(np.float32)
    return {"x": x, "y": y}, {"w": w0}


def _jloss(p, b):
    return 0.5 * jnp.mean(jnp.square(b["x"] @ p["w"] - b["y"]))


def _tloss(p, b):
    return 0.5 * torch.mean(torch.square(b["x"] @ p["w"] - b["y"]))


@pytest.mark.parametrize("f,n_probes", [(0, 8), (2, 5)])
def test_gb_probe_matches_the_reference(f, n_probes):
    batches, p0 = _least_squares()
    want = JH.gb_probe(_jloss, {"w": jnp.asarray(p0["w"])}, batches, f=f,
                       n_probes=n_probes, radius=0.5, seed=3)
    offsets = 0.5 * jax.random.normal(jax.random.PRNGKey(3),
                                      (n_probes - 1, 12), jnp.float32)
    got = H.gb_probe(_tloss, {"w": torch.tensor(p0["w"])}, batches, f=f,
                     n_probes=n_probes, offsets=np.asarray(offsets))
    assert got.G > 0 and got.B > 0
    for field in ("G", "B", "dissimilarity", "grad_sq"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-5, err_msg=field)
    assert [f.name for f in dataclasses.fields(H.GBEstimate)] == \
        [f.name for f in dataclasses.fields(JH.GBEstimate)]


def test_gb_probe_draws_its_own_offsets():
    batches, p0 = _least_squares(seed=1)
    a = H.gb_probe(_tloss, {"w": torch.tensor(p0["w"])}, batches, seed=5)
    b = H.gb_probe(_tloss, {"w": torch.tensor(p0["w"])}, batches, seed=5)
    assert a.dissimilarity.shape == a.grad_sq.shape == (8,)
    np.testing.assert_array_equal(a.dissimilarity, b.dissimilarity)
    with pytest.raises(ValueError, match="2 probe points"):
        H.gb_probe(_tloss, {"w": torch.tensor(p0["w"])}, batches, n_probes=1)
    with pytest.raises(ValueError, match="offsets"):
        H.gb_probe(_tloss, {"w": torch.tensor(p0["w"])}, batches,
                   offsets=np.zeros((3, 12), np.float32))
