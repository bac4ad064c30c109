"""Named adversarial-scenario registry: attack x heterogeneity x
byzantine fraction (counterpart of ``repro.adversary.registry``; the 13
specs are the reference's, letter for letter).

A :class:`ScenarioSpec` composes the three adversarial axes (the attack, the
Dirichlet(alpha) label split of the testbed, the Byzantine count at a fixed
worker count) with the aggregator/algorithm grid, and expands into labelled
``repro_torch.core.sweep.Scenario`` cells that ``plan_grid`` fuses into
banks. The sweep CLI exposes it as ``--scenario NAME`` /
``--list-scenarios``::

    PYTHONPATH=src python -m repro_torch.core.sweep --scenario mixed-attacks

Every spec runs; ``transformer-table1`` streams its batches
(``--testbed transformer`` implies ``--stream``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.sweep import Scenario, grid_scenarios

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named composed scenario (attack x heterogeneity x byz-fraction).

    Attributes:
      name: registry key (also the label prefix of every expanded cell).
      description: one line for ``--list-scenarios``.
      algos/attacks/aggregators: the grid axes (see
        ``sweep.grid_scenarios``).
      byz_f: Byzantine counts to sweep at fixed ``n_workers``; multi-valued
        specs tag each cell's label with ``f<k>``.
      n_workers: total worker count n (honest = n - f per cell).
      ratio: sparsifier keep-ratio.
      gamma: learning rate.
      alpha_het: Dirichlet concentration of the data split; ``None`` =
        i.i.d.  Applied by the CLI when building the testbed (quadratic
        testbeds ignore it — their heterogeneity is the target spread).
      testbed: ``quadratic`` | ``mnist`` | ``transformer`` — the testbed
        the CLI should use (``transformer`` = reduced ``stablelm_3b``
        causal LM on synthetic token streams; pairs with ``--stream``).
    """

    name: str
    description: str
    algos: Tuple[str, ...] = ("rosdhb",)
    attacks: Tuple[str, ...] = ("alie",)
    aggregators: Tuple[str, ...] = ("cwtm",)
    byz_f: Tuple[int, ...] = (3,)
    n_workers: int = 13
    ratio: float = 0.1
    gamma: float = 0.05
    alpha_het: Optional[float] = None
    testbed: str = "quadratic"

    def expand(self) -> List[Scenario]:
        """Expand into labelled grid cells (``<name>[/f<k>]/<algo>/<attack>/
        <agg>``), one ``grid_scenarios`` product per Byzantine count."""
        out: List[Scenario] = []
        for f in self.byz_f:
            if not 0 <= f < self.n_workers:
                raise ValueError(
                    f"scenario {self.name!r}: byz_f={f} outside "
                    f"[0, n_workers={self.n_workers})")
            cells = grid_scenarios(
                self.algos, self.attacks, self.aggregators,
                n_honest=self.n_workers - f, f=f, ratio=self.ratio,
                gamma=self.gamma)
            tag = f"f{f}/" if len(self.byz_f) > 1 else ""
            out += [dataclasses.replace(sc,
                                        label=f"{self.name}/{tag}{sc.label}")
                    for sc in cells]
        return out


REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    """Add ``spec`` to the registry (last registration wins on name)."""
    REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> ScenarioSpec:
    """Look up a named scenario; unknown names list everything known."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario: {name!r} (known scenarios: "
            f"{', '.join(sorted(REGISTRY))})") from None


def expand_scenario(name: str) -> List[Scenario]:
    return get_spec(name).expand()


def describe() -> str:
    width = max((len(n) for n in REGISTRY), default=0)
    return "\n".join(f"{s.name:<{width}}  {s.description}"
                     for s in REGISTRY.values())


for _spec in (
    ScenarioSpec(
        "fig1-alie",
        "paper Fig. 1: RoSDHB vs ALIE under CWTM+NNM, f=3 of 13",
        attacks=("alie",)),
    ScenarioSpec(
        "stateless-linear",
        "the full mean/std attack family x 3 robust rules (one fused bank)",
        attacks=("alie", "signflip", "ipm", "foe", "zero"),
        aggregators=("cwtm", "median", "geomed")),
    ScenarioSpec(
        "stateful-core",
        "the stateful adversaries (tracked mimic, spectral, eps-greedy IPM)"
        " + gauss baseline under CWTM+NNM",
        attacks=("mimic", "gauss", "spectral", "ipm_greedy")),
    ScenarioSpec(
        "mixed-attacks",
        "acceptance grid: 6 stateless+stateful attacks x 3 aggregators,"
        " ONE compiled program",
        attacks=("alie", "signflip", "foe", "mimic", "gauss", "spectral"),
        aggregators=("cwtm", "median", "geomed")),
    ScenarioSpec(
        "byz-fraction",
        "ALIE at f = 1..4 of n = 13 (byzantine-fraction axis, fixed n)",
        attacks=("alie",), byz_f=(1, 2, 3, 4)),
    ScenarioSpec(
        "table1-cross-algo",
        "all four algorithms x {alie, foe}: the Table-1-style comparison"
        " (ONE compiled program via the algorithm bank)",
        algos=("rosdhb", "dasha", "robust_dgd", "dgd"),
        attacks=("alie", "foe")),
    ScenarioSpec(
        "table1",
        "the full Table-1 grid: 4 algorithms x 3 attacks x 2 robust rules,"
        " fused into ONE compiled cross-algorithm program",
        algos=("rosdhb", "dasha", "robust_dgd", "dgd"),
        attacks=("alie", "foe", "signflip"),
        aggregators=("cwtm", "median")),
    ScenarioSpec(
        "table1-mini",
        "quickstart-sized Table-1 cut: 4 algorithms x {alie, foe} x"
        " CWTM+NNM, 2 of 10 workers Byzantine, as one program"
        " (examples/quickstart.py)",
        algos=("rosdhb", "dasha", "robust_dgd", "dgd"),
        attacks=("alie", "foe"), byz_f=(2,), n_workers=10),
    ScenarioSpec(
        "mimic-dirichlet01",
        "tracked mimic + alie on a strongly heterogeneous Dirichlet(0.1)"
        " MNIST split (mimic's favourite regime)",
        attacks=("mimic", "alie"), alpha_het=0.1, testbed="mnist"),
    ScenarioSpec(
        "mimic-dirichlet1",
        "tracked mimic + alie on a mildly heterogeneous Dirichlet(1.0)"
        " MNIST split",
        attacks=("mimic", "alie"), alpha_het=1.0, testbed="mnist"),
    ScenarioSpec(
        "mimic-iid",
        "tracked mimic + alie on the i.i.d. MNIST split (control for the"
        " dirichlet variants)",
        attacks=("mimic", "alie"), testbed="mnist"),
    ScenarioSpec(
        "chaos-serve",
        "the chaos-harness serving cell: RoSDHB vs ALIE under CWTM+NNM,"
        " f=3 of 13 — pair with a repro.serve.chaos scenario"
        " (python -m repro.serve --chaos combined)",
        attacks=("alie",)),
    ScenarioSpec(
        "transformer-table1",
        "Table-1 cut on a reduced stablelm_3b LM: rosdhb + robust_dgd x"
        " {alie, signflip} x CWTM+NNM, streamed from the prefetched ring"
        " buffer (run with --testbed transformer --stream)",
        algos=("rosdhb", "robust_dgd"),
        attacks=("alie", "signflip"),
        byz_f=(2,), n_workers=9, ratio=0.1, gamma=0.1,
        testbed="transformer"),
):
    register(_spec)
