"""Adversary subsystem (counterpart of ``repro.adversary``).

* ``core``          — the :class:`Adversary` API, the uniformly-shaped
                      :class:`AttackState` and :func:`make_attack_bank`,
                      which gives each lane of a grid its own attack.
* ``heterogeneity`` — Dirichlet(alpha) label partitioners and the empirical
                      (G, B)-gradient-dissimilarity probe.
* ``registry``      — named composed scenarios (attack x heterogeneity x
                      byzantine fraction) for the sweep CLI (``--scenario``).
"""

from repro_torch.adversary.core import (
    ADVERSARIES, AttackDraws, AttackState, Adversary, DEFAULT_ATTACK_BANK,
    KNOWN_ATTACKS, attack_index, bank_entry, init_attack_state, is_stateful,
    make_attack_bank, needs_attack_state, static_coeffs,
)
from repro_torch.adversary.heterogeneity import (
    GBEstimate, dirichlet_mnist, dirichlet_proportions, gb_probe,
    label_histograms, label_skew, partition_pool,
)
from repro_torch.adversary.registry import (
    REGISTRY, ScenarioSpec, describe, expand_scenario, get_spec, register,
)

__all__ = [
    "ADVERSARIES", "AttackDraws", "AttackState", "Adversary",
    "DEFAULT_ATTACK_BANK", "KNOWN_ATTACKS", "attack_index", "bank_entry",
    "init_attack_state", "is_stateful", "make_attack_bank",
    "needs_attack_state", "static_coeffs",
    "GBEstimate", "dirichlet_mnist", "dirichlet_proportions", "gb_probe",
    "label_histograms", "label_skew", "partition_pool",
    "REGISTRY", "ScenarioSpec", "describe", "expand_scenario", "get_spec",
    "register",
]
