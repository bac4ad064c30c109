"""Aggregation rules of the port against ``repro.core.aggregators``, on the
CPU: the kernel path (plain versions of the kernels) and the plain rules
against the reference's jnp rules and its Pallas path (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import attacks as JA
from repro_torch.core import aggregators as G
from repro_torch.kernels.pairdist import pairdist

N, F, D = 13, 3, 300


def _x(b=None, n=N, d=D, seed=0):
    shape = (n, d) if b is None else (b, n, d)
    return (np.random.default_rng(seed).normal(size=shape) * 3
            ).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale)


def _port(name, pre, use_kernels, f=F):
    return G.make_aggregator(G.AggregatorConfig(
        name=name, f=f, pre_nnm=pre, use_kernels=use_kernels), device="cpu")


def _ref(name, pre, use_pallas, f=F):
    return JG.make_aggregator(JG.AggregatorConfig(
        name=name, f=f, pre_nnm=pre, use_pallas=use_pallas))


# NNM composition skips the mean (the reference's make_aggregator rule)
RULES = [(n, p) for n in G.PORTED_RULES for p in (False, True)
         if not (n == "mean" and p)]


@pytest.mark.parametrize("name,pre", RULES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_rule_matches_jnp_rule(name, pre, use_kernels):
    x = _x(seed=len(name) * 7 + pre)
    want = _ref(name, pre, False)(jnp.asarray(x))
    _close(_port(name, pre, use_kernels)(torch.tensor(x)), want)


@pytest.mark.parametrize("name", ["cwtm", "median", "krum"])
def test_batched_matches_vmapped_reference(name):
    x = _x(b=4, seed=3)
    want = jax.vmap(_ref(name, True, False))(jnp.asarray(x))
    for use_kernels in (True, False):
        _close(_port(name, True, use_kernels)(torch.tensor(x)), want)


@pytest.mark.parametrize("batched", [False, True])
def test_nnm_cwtm_matches_jnp_and_pallas_nnm(batched):
    """fig1-alie's rule: NNM then CWTM, against the reference's jnp ``nnm``
    and its kernel NNM (``_kernel_nnm``, Pallas interpret)."""
    x = _x(b=3 if batched else None, seed=11)
    got = _port("cwtm", True, True)(torch.tensor(x))
    for use_pallas in (False, True):
        agg = _ref("cwtm", True, use_pallas)
        want = jax.vmap(agg)(jnp.asarray(x)) if batched else agg(x)
        _close(got, want)
    pre_j = JG._kernel_nnm(F, interpret=True)(jnp.asarray(x[0] if batched
                                                          else x))
    pre_t = G._kernel_nnm(F)(torch.tensor(x[0] if batched else x))
    _close(pre_t, pre_j)
    _close(G.nnm(torch.tensor(x), F),
           jax.vmap(lambda r: JG.nnm(r, F))(x) if batched else JG.nnm(x, F))


def _alie_bank(seed):
    """13 momenta: rows [0, 3) are ALIE's f IDENTICAL Byzantine rows."""
    honest = _x(n=N - F, seed=seed)
    byz = np.asarray(JA.alie(jnp.asarray(honest), F, z=1.5))
    return np.concatenate([byz, honest], axis=0)


def _labels(idx, f):
    """Neighbour lists with the identical Byzantine rows collapsed."""
    return [sorted("B" if j < f else str(j) for j in row) for row in idx]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnm_ties_on_identical_alie_rows(seed):
    """ALIE's rows tie exactly. The port's distances have an exact-zero
    diagonal, the jnp rule's carry float dust, so the neighbour sets may
    pick different copies of the identical rows — and nothing else. The mix
    is the same up to summation order."""
    x = _alie_bank(seed)
    assert (x[0] == x[1]).all() and (x[1] == x[2]).all()
    q = N - F
    idx_port = torch.argsort(pairdist(torch.tensor(x)), dim=-1,
                             stable=True)[:, :q].numpy()
    idx_ref = np.asarray(jnp.argsort(JG._pairwise_sq_dists(jnp.asarray(x)),
                                     axis=1)[:, :q])
    assert _labels(idx_port, F) == _labels(idx_ref, F)
    _close(G._kernel_nnm(F)(torch.tensor(x)), JG.nnm(jnp.asarray(x), F))
    got = _port("cwtm", True, True)(torch.tensor(x))
    for use_pallas in (False, True):
        _close(got, _ref("cwtm", True, use_pallas)(x))


@pytest.mark.parametrize("name", JG.BANK_NAMES)
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("n,f", [(13, 3), (10, 0), (7, 3), (20, 4)])
def test_kappa_bound_matches(name, pre, n, f):
    got = G.AggregatorConfig(name=name, f=f, pre_nnm=pre).kappa_bound(n)
    want = JG.AggregatorConfig(name=name, f=f, pre_nnm=pre).kappa_bound(n)
    assert got == want


def test_unported_rule_and_wrong_device_raise():
    """Every reference rule is ported (geomed since the grid slice): an
    unknown name raises."""
    with pytest.raises(ValueError, match="unknown aggregator"):
        G.make_aggregator(G.AggregatorConfig(name="trimmed", f=1), "cpu")
    agg = _port("cwtm", True, True)
    with pytest.raises(ValueError, match="built for cpu"):
        agg(torch.zeros(5, 4, device="meta"))
