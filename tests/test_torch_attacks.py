"""Attacks of the port against ``repro.core.attacks``: bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as JA
from repro_torch.core import attacks as A

SHAPES = [(10, 64), (10, 4096), (10, 11958), (7, 301), (12, 1000)]
NAMES = [("alie", {}), ("alie", {"z": 1.5}), ("signflip", {}),
         ("signflip", {"scale": 2.5}), ("ipm", {}), ("foe", {}),
         ("zero", {}), ("mimic", {}), ("none", {})]


def _honest(h, d, seed=0):
    return (np.random.default_rng(seed + h * d).normal(size=(h, d)) * 3
            ).astype(np.float32)


@pytest.mark.parametrize("h,d", SHAPES)
@pytest.mark.parametrize("name,kw", NAMES)
def test_apply_attack_bitwise(h, d, name, kw):
    x = _honest(h, d)
    want = np.asarray(JA.apply_attack(JA.AttackConfig(name=name, **kw),
                                      jnp.asarray(x), 3))
    got = A.apply_attack(A.AttackConfig(name=name, **kw), torch.tensor(x), 3)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,d", SHAPES)
@pytest.mark.parametrize("coeffs", [(1.0, -1.5), (-10.0, 0.0), (0.5, 2.0)])
def test_linear_attack_bitwise(h, d, coeffs):
    x = _honest(h, d, 1)
    want = np.asarray(JA.linear_attack(jnp.asarray(x), 3, jnp.asarray(coeffs)))
    got = A.apply_attack(A.AttackConfig(name="linear"), torch.tensor(x), 3,
                         params=torch.tensor(coeffs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_alie_population_std_not_bessel():
    """``jnp.std`` has no Bessel correction; ``torch.std`` does by default."""
    x = torch.tensor(_honest(10, 50))
    mu = A._row_mean(x)
    np.testing.assert_allclose(A._row_std(x, mu).numpy(),
                               torch.std(x, dim=0, correction=0).numpy(),
                               rtol=1e-6)
    assert not torch.allclose(A._row_std(x, mu), torch.std(x, dim=0))


@pytest.mark.parametrize("n,f", [(13, 3), (10, 0), (20, 9), (7, 2), (64, 1)])
def test_alie_z_and_linear_coeffs(n, f):
    assert A._alie_z(n, f) == JA._alie_z(n, f)
    for name, kw in NAMES[:-2]:
        assert (A.linear_coeffs(A.AttackConfig(name=name, **kw), n, f)
                == JA.linear_coeffs(JA.AttackConfig(name=name, **kw), n, f))


def test_unported_attack_raises():
    """The stateless dispatch refuses the stateful adversaries (they run in
    ``repro_torch.adversary`` with their memory)."""
    with pytest.raises(ValueError, match="stateless"):
        A.apply_attack(A.AttackConfig(name="spectral"), torch.zeros(4, 3), 2)
