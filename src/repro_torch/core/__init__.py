"""The port's core: RoSDHB and its competitors (counterpart of
``repro.core``).

  compression  - steps 1-4 (masks + unbiased sparsified reconstruction)
  algorithms   - steps 5-7 (momentum bank, robust aggregation, update)
  aggregators  - the (f, kappa)-robust rules
  attacks      - the Byzantine adversary
  simulator    - the single-device training loop, streamed rollouts with
                 early exit at tau
  costmodel    - the measured fuse-or-partition model of the grid plan
  testbeds     - the quadratic and CNN testbeds
"""

from repro_torch.core.compression import (
    SparsifierConfig, compress, compressed_estimate, index_bytes, make_mask,
    make_masks, payload_bytes, payload_floats,
)
from repro_torch.core.aggregators import AggregatorConfig, make_aggregator
from repro_torch.core.attacks import AttackConfig, apply_attack
from repro_torch.core.algorithms import (
    ALGO_BANK, AlgorithmConfig, ServerState, StateLayout, algo_payload_bytes,
    apply_direction, init_state, server_round, server_state_bytes,
)
from repro_torch.core.wire import per_worker_payload_bytes, round_payload_bytes
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.simulator import Simulator, SimState, stack_batches
from repro_torch.core.testbeds import mnist_testbed, quadratic_testbed

__all__ = [
    "SparsifierConfig", "compress", "compressed_estimate", "index_bytes",
    "make_mask", "make_masks", "payload_bytes", "payload_floats",
    "AggregatorConfig", "make_aggregator",
    "AttackConfig", "apply_attack",
    "ALGO_BANK", "AlgorithmConfig", "ServerState", "StateLayout",
    "algo_payload_bytes", "apply_direction", "init_state", "server_round",
    "server_state_bytes",
    "per_worker_payload_bytes", "round_payload_bytes",
    "CostModel", "DEFAULT_COST_MODEL",
    "Simulator", "SimState", "stack_batches",
    "mnist_testbed", "quadratic_testbed",
]
