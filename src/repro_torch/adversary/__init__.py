"""Adversary subsystem (counterpart of ``repro.adversary``).

* ``core``          — the :class:`Adversary` API, the uniformly-shaped
                      :class:`AttackState` and :func:`make_attack_bank`,
                      which gives each lane of a grid its own attack.
* ``heterogeneity`` — the Dirichlet(alpha) label split of the testbed
                      (ported: :func:`dirichlet_mnist`).
* ``registry``      — named composed scenarios (attack x heterogeneity x
                      byzantine fraction) for the sweep CLI (``--scenario``).
"""

from repro_torch.adversary.core import (
    ADVERSARIES, AttackDraws, AttackState, Adversary, DEFAULT_ATTACK_BANK,
    KNOWN_ATTACKS, attack_index, bank_entry, init_attack_state, is_stateful,
    make_attack_bank, needs_attack_state, static_coeffs,
)
from repro_torch.adversary.heterogeneity import dirichlet_mnist
from repro_torch.adversary.registry import (
    REGISTRY, ScenarioSpec, describe, expand_scenario, get_spec, register,
)

__all__ = [
    "ADVERSARIES", "AttackDraws", "AttackState", "Adversary",
    "DEFAULT_ATTACK_BANK", "KNOWN_ATTACKS", "attack_index", "bank_entry",
    "init_attack_state", "is_stateful", "make_attack_bank",
    "needs_attack_state", "static_coeffs",
    "dirichlet_mnist",
    "REGISTRY", "ScenarioSpec", "describe", "expand_scenario", "get_spec",
    "register",
]
