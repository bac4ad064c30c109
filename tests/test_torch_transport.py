"""The port's transport boundary (``repro_torch.serve`` protocol, transport,
faults, retrying clients) against the reference's: frames byte for byte in
both directions, fault plans decision for decision and byte for byte, and
the framed loopback and TCP paths bitwise the in-process server."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.serve import protocol as jp
from repro.serve.client import RetryPolicy as JRetryPolicy
from repro.serve.faults import FaultPlan as JFaultPlan
from repro.serve.faults import FaultSpec as JFaultSpec
from repro.serve.protocol import (ClientUpdate as JUpdate,
                                  RoundAnnouncement as JAnnouncement)
from repro_torch.core.sweep import grid_scenarios, quadratic_testbed
from repro_torch.serve import (
    ByzantineRobustServer, ClientGaveUp, ClientPool, FaultPlan, FaultSpec,
    FaultyEndpoint, LoopbackTransport, RetryingClient, RetryPolicy,
    ServeConfig, ServeTimeout, TcpTransport, TransportReset,
    TransportTimeout, get_chaos, make_transport, run_chaos, run_service,
)
from repro_torch.serve import protocol as p
from repro_torch.serve.server import FaultBudgetExceeded
from repro_torch.serve.transport import ServerBinding

D = 32
ROUNDS = 6


def _cfg():
    return grid_scenarios(("rosdhb",), ("alie",), ("cwtm",), n_honest=10,
                          f=3)[0].cfg


def _testbed():
    return quadratic_testbed(13, d=D, device="cpu")


# ----------------------------------------------------------------------- #
# frames: the reference's bytes, both ways
# ----------------------------------------------------------------------- #


def _messages(mod, Ann, Upd):
    params = np.linspace(-2, 2, 11).astype(np.float32)
    ann = Ann(round_id=7, params=params,
              mask_key=np.asarray([1, 0xFFFFFFFE], np.uint32),
              atk_key=np.asarray([3, 4], np.uint32))
    upd = Upd(client_id=5, round_id=7, mask_id=(1 << 32) | 0xFFFFFFFE,
              values=-params, payload_bytes=123, sent_at=4.5)
    return {"announce_req": mod.encode_announce_req(3, client_id=9),
            "announce": mod.encode_announcement(ann),
            "update": mod.encode_update(upd),
            "ack": mod.encode_ack(11, "rejected: bad shape")}


def test_frames_are_the_references_bytes_both_ways():
    ours = _messages(p, p.RoundAnnouncement, p.ClientUpdate)
    theirs = _messages(jp, JAnnouncement, JUpdate)
    assert ours == theirs
    assert (p.HEADER.format, p.MAGIC, p.VERSION, p.SERVER_SENDER) == \
        (jp.HEADER.format, jp.MAGIC, jp.VERSION, jp.SERVER_SENDER)
    for raw_by, dec in ((ours, jp), (theirs, p)):
        mt, sender, payload = dec.decode_frame(raw_by["announce"])
        assert (mt, sender) == (dec.MSG_ANNOUNCE, dec.SERVER_SENDER)
        ann = dec.decode_announcement(payload)
        assert ann.round_id == 7 and ann.mask_id == (1 << 32) | 0xFFFFFFFE
        np.testing.assert_array_equal(ann.params,
                                      np.linspace(-2, 2, 11, dtype=np.float32))
        mt, sender, payload = dec.decode_frame(raw_by["update"])
        u = dec.decode_update(payload, sender)
        assert (mt, u.client_id, u.round_id, u.payload_bytes, u.sent_at) == \
            (dec.MSG_UPDATE, 5, 7, 123, 4.5)
        assert u.mask_id == ann.mask_id
        mt, sender, payload = dec.decode_frame(raw_by["announce_req"])
        assert (mt, sender, dec.decode_announce_req(payload)) == \
            (dec.MSG_ANNOUNCE_REQ, 9, 3)
        mt, _, payload = dec.decode_frame(raw_by["ack"])
        assert dec.decode_ack(payload) == (11, "rejected: bad shape")


@pytest.mark.parametrize("mod", [p, jp], ids=["port", "reference"])
def test_corrupt_payload_is_bad_checksum_with_sender(mod):
    u = mod.ClientUpdate(client_id=4, round_id=2, mask_id=1,
                         values=np.ones(8, np.float32), payload_bytes=32)
    raw = bytearray(p.encode_update(p.ClientUpdate(**dataclasses.asdict(u))))
    raw[p.HEADER_SIZE + 9] ^= 0xFF
    with pytest.raises(mod.BadChecksum) as ei:
        mod.decode_frame(bytes(raw))
    assert ei.value.sender == 4
    assert mod.frame_length(bytes(raw[:mod.HEADER_SIZE])) == len(raw)
    raw[0] ^= 0xFF
    with pytest.raises(mod.FrameError) as ei2:
        mod.decode_frame(bytes(raw))
    assert not isinstance(ei2.value, mod.BadChecksum)


# ----------------------------------------------------------------------- #
# fault plans: the reference's decisions and bytes
# ----------------------------------------------------------------------- #


def test_fault_plans_decide_and_corrupt_as_the_reference():
    rates = dict(drop=0.3, duplicate=0.3, corrupt=0.3, reorder=0.2,
                 delay=0.2, reset=0.2, partitions=((2, 4, (1, 3)),))
    plan, jplan = FaultPlan(FaultSpec(**rates), seed=9), \
        JFaultPlan(JFaultSpec(**rates), seed=9)
    coords = [(c, r, op, a) for c in range(5) for r in range(6)
              for op in ("announce", "update") for a in range(3)]
    got = [dataclasses.asdict(plan.decide(*c)) for c in coords]
    assert got == [dataclasses.asdict(jplan.decide(*c)) for c in coords]
    assert got == [dataclasses.asdict(plan.decide(*c))
                   for c in reversed(coords)][::-1]
    raw = p.encode_update(p.ClientUpdate(
        client_id=2, round_id=4, mask_id=0, values=np.ones(16, np.float32),
        payload_bytes=64))
    for c in coords[:20]:
        assert plan.corrupt_bytes(raw, *c) == jplan.corrupt_bytes(raw, *c)
    c1 = plan.corrupt_bytes(raw, 2, 4, "update")
    assert c1 != raw and c1[:p.HEADER_SIZE] == raw[:p.HEADER_SIZE]


def test_fault_spec_and_retry_policy_are_the_references():
    for kw in ({}, {"corrupt": 0.1}, {"partitions": ((0, 1, (0,)),)}):
        assert FaultSpec(**kw).any_faults() == JFaultSpec(**kw).any_faults()
    with pytest.raises(ValueError, match="outside"):
        FaultSpec(drop=1.5)
    with pytest.raises(ValueError, match="delay_s"):
        FaultSpec(delay_s=-1.0)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    pol, jpol = RetryPolicy(seed=42), JRetryPolicy(seed=42)
    r1, r2 = np.random.default_rng((42, 7)), np.random.default_rng((42, 7))
    assert [pol.backoff_s(7, k, r1) for k in range(5)] == \
        [jpol.backoff_s(7, k, r2) for k in range(5)]


def test_faulty_endpoint_applies_the_plan_at_the_byte_level():
    sent = []

    class _Sink:
        def request(self, raw, **ctx):
            sent.append(raw)
            return p.encode_ack(0, "queued")

        def close(self):
            pass

    ep = FaultyEndpoint(_Sink(), 0, FaultPlan(FaultSpec(drop=1.0)))
    with pytest.raises(TransportTimeout):
        ep.request(b"x", round_id=0, op="update", attempt=0)
    assert not sent and ep.injected == {"drop": 1}
    ep = FaultyEndpoint(_Sink(), 0, FaultPlan(FaultSpec(duplicate=1.0)))
    ep.request(b"x", round_id=0, op="update", attempt=0)
    assert sent == [b"x", b"x"] and ep.injected == {"duplicate": 1}
    ep = FaultyEndpoint(_Sink(), 1, FaultPlan(FaultSpec(reorder=1.0)))
    ack = ep.request(b"a", round_id=0, op="update")
    assert p.decode_ack(p.decode_frame(ack)[2]) == (0, "queued")
    ep.request(b"b", round_id=0, op="update")
    ep.flush()
    assert sent[2:] == [b"a", b"b"]


# ----------------------------------------------------------------------- #
# transports: bitwise the in-process server
# ----------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def in_process():
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = _testbed()
    server = ByzantineRobustServer(cfg, params0, ServeConfig(), seed=0,
                                   device="cpu")
    run_service(server, ClientPool(loss_fn, params0, cfg, batch_fn,
                                   device="cpu"), ROUNDS)
    return server.params_flat.numpy()


@pytest.mark.parametrize("transport", ["loopback", "tcp"])
def test_transport_is_bitwise_the_in_process_server(in_process, transport):
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = _testbed()
    chaos = dataclasses.replace(get_chaos("fault-free"), transport=transport)
    res = run_chaos(cfg, params0, batch_fn, loss_fn, chaos, ROUNDS, seed=0,
                    device="cpu")
    np.testing.assert_array_equal(res.final_params, in_process)
    assert res.step_traces == [1] and res.all_rounds_terminated()
    assert res.client_stats["retries"] == 0 and res.injected == {}


def test_tcp_rebind_keeps_the_port():
    cfg = _cfg()
    _, params0, _, _ = _testbed()
    t = TcpTransport(ByzantineRobustServer(cfg, params0, device="cpu"))
    addr = t.address
    assert addr[0] == "127.0.0.1" and addr[1] > 0
    ep = t.connect(0)
    t.unbind()
    with pytest.raises((TransportReset, TransportTimeout)):
        ep.request(p.encode_announce_req(0, 0))
    t.bind(ByzantineRobustServer(cfg, params0, device="cpu"))
    assert t.address == addr
    t.close()


def test_unbound_and_unknown_transports():
    with pytest.raises(TransportReset):
        LoopbackTransport().connect(0).request(p.encode_announce_req(0, 0))
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("carrier-pigeon")


# ----------------------------------------------------------------------- #
# retrying clients
# ----------------------------------------------------------------------- #


class _Flaky:
    def __init__(self, inner, fail_times):
        self.inner, self.fail_times, self.calls = inner, fail_times, 0

    def request(self, raw, **ctx):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise TransportTimeout(f"flaky ({self.calls})")
        return self.inner.request(raw, **ctx)

    def close(self):
        self.inner.close()


def _running_server(**serve):
    _, params0, _, _ = _testbed()
    return ByzantineRobustServer(_cfg(), params0, ServeConfig(**serve),
                                 seed=0, device="cpu").start()


def test_retrying_client_backs_off_and_gives_up():
    server = _running_server()
    try:
        sleeps = []
        c = RetryingClient(_Flaky(LoopbackTransport(server).connect(3), 3),
                           3, RetryPolicy(max_attempts=5,
                                          backoff_base_s=0.01),
                           sleep=sleeps.append)
        assert c.fetch_announcement(0).round_id == 0
        assert c.stats["retries"] == 3 and len(sleeps) == 3
        assert sleeps[0] >= 0.01 and sleeps[1] >= 0.02 and sleeps[2] >= 0.04
    finally:
        server.stop()
    c = RetryingClient(LoopbackTransport().connect(1), 1,
                       RetryPolicy(max_attempts=3, backoff_base_s=0.0))
    with pytest.raises(ClientGaveUp) as ei:
        c.fetch_announcement(0)
    assert ei.value.attempts == 3 and ei.value.client_id == 1
    assert "TransportReset" in ei.value.last_error


def _wait_buffered(server, count, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with server._cond:
            if server._buffer.count == count:
                return True
        time.sleep(0.01)
    return False


def test_resubmission_is_idempotent():
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = _testbed()
    server = _running_server()
    try:
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, device="cpu")
        u = pool.round_payloads(server.announce(timeout=10.0))[5].update
        c = RetryingClient(LoopbackTransport(server).connect(5), 5,
                           RetryPolicy(max_attempts=2))
        assert c.submit(u) == "queued" and c.submit(u) == "queued"
        assert _wait_buffered(server, 1)
        deadline = time.perf_counter() + 5.0
        while server.metrics.decisions.get("duplicate", 0) < 1 and \
                time.perf_counter() < deadline:
            time.sleep(0.01)
        assert server.metrics.decisions.get("duplicate", 0) == 1
    finally:
        server.stop()


# ----------------------------------------------------------------------- #
# the protocol-fault budget and typed timeouts
# ----------------------------------------------------------------------- #


def _corrupt_frame(client_id):
    u = p.ClientUpdate(client_id=client_id, round_id=0, mask_id=0,
                       values=np.zeros(D, np.float32), payload_bytes=1)
    raw = bytearray(p.encode_update(u))
    raw[p.HEADER_SIZE + 3] ^= 0xFF
    return bytes(raw)


def test_persistent_corruption_breaches_the_fault_budget():
    server = _running_server(fault_tolerance=3)
    try:
        binding = ServerBinding(server)
        bad = _corrupt_frame(4)
        for _ in range(3):
            _, _, payload = p.decode_frame(binding.handle(bad))
            assert p.decode_ack(payload)[1] == "bad_checksum"
        assert server.protocol_faulty == (4,)
        with pytest.raises(FaultBudgetExceeded) as ei:
            server.wait_round(0, timeout=1.0)
        assert ei.value.faulty == (4,) and ei.value.f == 3
        assert server.metrics.fault_budget_events
    finally:
        server.stop()


def test_valid_frame_clears_protocol_fault_state():
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = _testbed()
    server = _running_server(fault_tolerance=2)
    try:
        binding = ServerBinding(server)
        bad = _corrupt_frame(5)
        binding.handle(bad)
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, device="cpu")
        good = p.encode_update(pool.round_payloads(
            server.announce(timeout=10.0))[5].update)
        _, _, payload = p.decode_frame(binding.handle(good))
        assert p.decode_ack(payload)[1] == "queued"
        binding.handle(bad)
        assert server.protocol_faulty == ()
        _, _, payload = p.decode_frame(binding.handle(b"junk"))
        assert p.decode_ack(payload)[1] == "bad_frame"
    finally:
        server.stop()


def test_binding_answers_no_round_with_a_typed_timeout_underneath():
    server = _running_server()
    try:
        binding = ServerBinding(server, announce_timeout_s=0.05)
        _, _, payload = p.decode_frame(binding.handle(
            p.encode_announce_req(5, 0)))
        assert p.decode_ack(payload) == (-1, "no_round")
        with pytest.raises(ServeTimeout) as ei:
            server.announce(timeout=0.05, min_round=5)
        assert ei.value.reason == "deadline" and ei.value.round_id == 0
    finally:
        server.stop()


def test_tcp_moves_multi_megabyte_frames_whole():
    """A 4 MiB announcement and a 4 MiB update cross real sockets in many
    chunks and arrive byte for byte."""
    d = 1 << 20
    cfg = _cfg()
    w = np.random.default_rng(1).normal(size=d).astype(np.float32)
    server = ByzantineRobustServer(
        cfg, {"w": torch.from_numpy(w.copy())}, seed=0, device="cpu").start()
    t = TcpTransport(server)
    ep = t.connect(4)
    try:
        mt, _, payload = p.decode_frame(ep.request(p.encode_announce_req(0,
                                                                         4)))
        ann = p.decode_announcement(payload)
        assert mt == p.MSG_ANNOUNCE
        np.testing.assert_array_equal(ann.params, w)
        values = np.random.default_rng(0).normal(size=d).astype(np.float32)
        u = p.make_update(cfg, d, 4, ann, values)
        _, _, payload = p.decode_frame(ep.request(p.encode_update(u)))
        assert p.decode_ack(payload) == (0, "queued")
        assert _wait_buffered(server, 1)
        with server._cond:
            got = server._buffer.rows()[4].update.values
        np.testing.assert_array_equal(got, values)
    finally:
        ep.close()
        t.close()
        server.stop()
