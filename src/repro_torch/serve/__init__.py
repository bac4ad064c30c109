"""Streaming Byzantine-robust parameter server (``python -m
repro_torch.serve``; counterpart of ``repro.serve``).

The simulator turned inside out: clients push compressed updates onto a
queue, a round buffer collects them under a participation quorum, a
wall-clock timeout and a bounded staleness window, and ONE aggregate-and-
apply step (the ``make_aggregator`` rule and the rosdhb/robust_dgd/dgd apply
halves the simulator runs, the port's pairdist, CWTM and median kernels on
the card) fires per round, padding absent clients so every participation
level runs the same step.

Module map:
  protocol  - wire format (RoundAnnouncement down, ClientUpdate up; byte
              accounting shared with the simulator via core.wire) and the
              length-prefixed checksummed frame layer, the reference's bytes
  buffer    - the round buffer (quorum, timeout, staleness policies)
  server    - ingest thread + queue + batcher loop around the step, and the
              fault domain (typed ServeTimeout, protocol-fault budget,
              graceful quorum degradation, liveness watchdog, mid-round
              crash recovery)
  client    - simulated client pool (honest + Byzantine via
              repro_torch.adversary, straggler/drop/late injection) and
              RetryingClient (backoff + jitter, idempotent resubmission)
  transport - pluggable frame movers: in-process loopback and real TCP
  faults    - seeded deterministic fault injection (FaultPlan)
  chaos     - named chaos scenarios composing fault plans with the stack
  metrics   - updates/sec, rounds/sec, p50/p99 round latency, histograms,
              quorum transitions, watchdog and fault-budget events

With full participation and zero timeout the server's parameter trajectory
is ``Simulator.rollout``'s bitwise on the same draws, over the loopback and
TCP transports' framed path too (tests/test_torch_serve.py,
tests/test_torch_transport.py, the serve phase of chip_smoke.py).
"""

from repro_torch.serve.buffer import RoundBuffer
from repro_torch.serve.chaos import (
    CHAOS_REGISTRY, ChaosResult, ChaosScenario, get_chaos, register_chaos,
    run_chaos,
)
from repro_torch.serve.client import (
    ClientBehavior, ClientGaveUp, ClientPool, RetryingClient, RetryPolicy,
)
from repro_torch.serve.faults import (
    FaultDecision, FaultPlan, FaultSpec, FaultyEndpoint, faulty_endpoints,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.protocol import ClientUpdate, RoundAnnouncement, mask_id
from repro_torch.serve.server import (
    ByzantineRobustServer, FaultBudgetExceeded, RoundResult, ServeConfig,
    ServeTimeout, run_lockstep, run_service,
)
from repro_torch.serve.transport import (
    LoopbackTransport, TcpTransport, TransportError, TransportReset,
    TransportTimeout, make_transport,
)

__all__ = [
    "ByzantineRobustServer", "CHAOS_REGISTRY", "ChaosResult",
    "ChaosScenario", "ClientBehavior", "ClientGaveUp", "ClientPool",
    "ClientUpdate", "FaultBudgetExceeded", "FaultDecision", "FaultPlan",
    "FaultSpec", "FaultyEndpoint", "LoopbackTransport", "RetryingClient",
    "RetryPolicy", "RoundAnnouncement", "RoundBuffer", "RoundResult",
    "ServeConfig", "ServeMetrics", "ServeTimeout", "TcpTransport",
    "TransportError", "TransportReset", "TransportTimeout",
    "faulty_endpoints", "get_chaos", "make_transport", "mask_id",
    "register_chaos", "run_chaos", "run_lockstep", "run_service",
]
