"""Wire format of the streaming Byzantine-robust parameter server
(counterpart of ``repro.serve.protocol``; the frames are the same bytes).

Downlink, once per round (:class:`RoundAnnouncement`): the current flat
parameter vector plus the round's two pairs of broadcast seed words: the
coordinated-sparsification mask words (RoSDHB's 0-byte mask broadcast:
clients re-derive the global mask from the shared words instead of shipping
indices) and the attack words the simulated adversary draws from. The
server derives them from its own seed chain
(``repro_torch.serve.server``); a client turns them into a draws provider
(``repro_torch.testing.SeedWordDraws``). They sit where the reference
carries its threefry keys, two uint32 words each, so the frame layout is
the reference's.

Uplink, once per client per round (:class:`ClientUpdate`): the update
values, the coordinated-mask id they were sparsified under, round and client
ids, and the *accounted* wire cost. Values are the dense unbiased
reconstruction ``[padded_D]`` (the simulation convention of
``repro_torch.core.compression``), while ``payload_bytes`` prices the real
wire format through :func:`repro_torch.core.wire.per_worker_payload_bytes`,
the accounting ``Simulator.payload_bytes_per_round`` uses.

The byte-level **frame layer** at the bottom of this module is what the
transports (``repro_torch.serve.transport``) move: every message is one
length-prefixed frame, a fixed 16-byte header (magic, version, message type,
sender id, payload length, CRC32) followed by the payload. Float32 values
round-trip through ``tobytes``/``frombuffer`` bitwise, so a served
trajectory over the loopback transport is bitwise the in-process server's.
A corrupted payload fails the CRC and decodes to :class:`BadChecksum`
carrying the sender id from the intact header, which lets the server charge
the protocol fault to a client instead of crashing the batcher.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import algorithms as alg
from repro_torch.core import wire as W
from repro_torch.testing import fold_words


def mask_id(mask_key) -> int:
    """Stable integer id of a coordinated mask: the round's broadcast mask
    words folded to 64 bits. Clients echo it back so the server can reject
    updates sparsified under a different round's mask."""
    return fold_words(mask_key)


@dataclasses.dataclass(frozen=True)
class RoundAnnouncement:
    """Downlink broadcast opening round ``round_id``."""

    round_id: int
    params: np.ndarray       # flat [padded_D] f32 parameter vector
    mask_key: np.ndarray     # uint32 words of the coordinated mask's draws
    atk_key: np.ndarray      # uint32 words of the adversary's draws

    @property
    def mask_id(self) -> int:
        return mask_id(self.mask_key)


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """One client's uplink payload for one round."""

    client_id: int
    round_id: int
    mask_id: int             # coordinated mask the values were built under
    values: np.ndarray       # dense unbiased reconstruction [padded_D]
    payload_bytes: int       # accounted real wire cost (core.wire)
    sent_at: float = 0.0     # client-side send timestamp (perf_counter)


def update_payload_bytes(cfg: alg.AlgorithmConfig, d: int,
                         bytes_per_value: int = 4) -> int:
    """Accounted uplink bytes of one :class:`ClientUpdate` under ``cfg``'s
    algorithm (``d`` is the true model dimension, unpadded) — shared with
    ``Simulator.payload_bytes_per_round`` via :mod:`repro_torch.core.wire`."""
    return W.per_worker_payload_bytes(cfg.name, d, cfg.sparsifier,
                                      bytes_per_value=bytes_per_value)


def make_update(cfg: alg.AlgorithmConfig, d: int, client_id: int,
                ann: RoundAnnouncement, values: np.ndarray,
                sent_at: float = 0.0,
                payload_bytes: Optional[int] = None) -> ClientUpdate:
    """Build a :class:`ClientUpdate` answering ``ann`` with priced wire
    cost (``d`` is the true model dimension used for byte accounting)."""
    if payload_bytes is None:
        payload_bytes = update_payload_bytes(cfg, d)
    return ClientUpdate(client_id=client_id, round_id=ann.round_id,
                        mask_id=ann.mask_id, values=values,
                        payload_bytes=payload_bytes, sent_at=sent_at)


# --------------------------------------------------------------------------
# Frame layer: what the transports actually move
# --------------------------------------------------------------------------

#: Frame header: magic u16, version u8, msg type u8, sender i32 (client id,
#: SERVER_SENDER for the server), payload length u32, payload CRC32 u32.
HEADER = struct.Struct("<HBBiII")
HEADER_SIZE = HEADER.size
MAGIC = 0x5242            # "BR"
VERSION = 1
SERVER_SENDER = -1

#: Message types.
MSG_ANNOUNCE_REQ = 1      # client -> server: send me the round >= min_round
MSG_ANNOUNCE = 2          # server -> client: RoundAnnouncement
MSG_UPDATE = 3            # client -> server: ClientUpdate
MSG_ACK = 4               # server -> client: status string for a request

_ANN_HEAD = struct.Struct("<qII")       # round_id, mask words, atk words
_UPDATE_HEAD = struct.Struct("<qQqd")   # round_id, mask_id, bytes, sent_at
_ACK_HEAD = struct.Struct("<q")         # round_id (-1 when not applicable)


class FrameError(ValueError):
    """A frame that cannot be decoded (bad magic/version/type/length)."""


class BadChecksum(FrameError):
    """Payload CRC mismatch. The header survived, so the sender id is
    attributable — the server counts this against the protocol-fault
    budget of ``sender`` instead of crashing."""

    def __init__(self, message: str, sender: int):
        super().__init__(message)
        self.sender = sender


def encode_frame(msg_type: int, payload: bytes,
                 sender: int = SERVER_SENDER) -> bytes:
    """One length-prefixed checksummed frame: header + payload."""
    return HEADER.pack(MAGIC, VERSION, msg_type, sender, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


def frame_length(header_bytes: bytes) -> int:
    """Total frame length (header + payload) from the raw 16-byte header —
    used by stream transports to split frames WITHOUT validating the CRC
    (a corrupt payload must still frame correctly so the next message on
    the connection survives)."""
    if len(header_bytes) < HEADER_SIZE:
        raise FrameError(
            f"short header: {len(header_bytes)} < {HEADER_SIZE} bytes")
    magic, version, _, _, length, _ = HEADER.unpack_from(header_bytes)
    if magic != MAGIC or version != VERSION:
        raise FrameError(
            f"bad magic/version {magic:#x}/{version} "
            f"(expected {MAGIC:#x}/{VERSION})")
    return HEADER_SIZE + length


def decode_frame(raw: bytes) -> Tuple[int, int, bytes]:
    """Validate + split one frame. Returns ``(msg_type, sender, payload)``;
    raises :class:`FrameError` on malformed framing and
    :class:`BadChecksum` (with the sender id) on a CRC mismatch."""
    if len(raw) < HEADER_SIZE:
        raise FrameError(f"short frame: {len(raw)} < {HEADER_SIZE} bytes")
    magic, version, msg_type, sender, length, crc = HEADER.unpack_from(raw)
    if magic != MAGIC or version != VERSION:
        raise FrameError(
            f"bad magic/version {magic:#x}/{version} "
            f"(expected {MAGIC:#x}/{VERSION})")
    payload = raw[HEADER_SIZE:]
    if len(payload) != length:
        raise FrameError(
            f"payload length {len(payload)} != header length {length}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise BadChecksum(
            f"payload checksum mismatch for sender {sender} "
            f"(msg_type={msg_type}, {length} bytes)", sender=sender)
    return msg_type, sender, payload


# -- per-message payload codecs --------------------------------------------


def encode_announce_req(min_round: int, client_id: int) -> bytes:
    """Client request: the announcement for a round ``>= min_round``."""
    return encode_frame(MSG_ANNOUNCE_REQ, struct.pack("<q", min_round),
                        sender=client_id)


def decode_announce_req(payload: bytes) -> int:
    if len(payload) != 8:
        raise FrameError(f"announce_req payload {len(payload)} != 8 bytes")
    return struct.unpack("<q", payload)[0]


def encode_announcement(ann: RoundAnnouncement) -> bytes:
    mask = np.ascontiguousarray(ann.mask_key, dtype=np.uint32)
    atk = np.ascontiguousarray(ann.atk_key, dtype=np.uint32)
    params = np.ascontiguousarray(ann.params, dtype=np.float32)
    payload = (_ANN_HEAD.pack(ann.round_id, mask.size, atk.size)
               + mask.tobytes() + atk.tobytes() + params.tobytes())
    return encode_frame(MSG_ANNOUNCE, payload)


def decode_announcement(payload: bytes) -> RoundAnnouncement:
    if len(payload) < _ANN_HEAD.size:
        raise FrameError("announcement payload too short")
    round_id, n_mask, n_atk = _ANN_HEAD.unpack_from(payload)
    off = _ANN_HEAD.size
    need = off + 4 * (n_mask + n_atk)
    if len(payload) < need or (len(payload) - need) % 4:
        raise FrameError("announcement payload length inconsistent")
    mask = np.frombuffer(payload, np.uint32, count=n_mask, offset=off)
    off += 4 * n_mask
    atk = np.frombuffer(payload, np.uint32, count=n_atk, offset=off)
    off += 4 * n_atk
    params = np.frombuffer(payload, np.float32, offset=off)
    return RoundAnnouncement(round_id=round_id, params=params,
                             mask_key=mask, atk_key=atk)


def encode_update(update: ClientUpdate) -> bytes:
    values = np.ascontiguousarray(update.values, dtype=np.float32)
    payload = (_UPDATE_HEAD.pack(update.round_id, update.mask_id,
                                 update.payload_bytes, update.sent_at)
               + values.tobytes())
    return encode_frame(MSG_UPDATE, payload, sender=update.client_id)


def decode_update(payload: bytes, sender: int) -> ClientUpdate:
    if len(payload) < _UPDATE_HEAD.size:
        raise FrameError("update payload too short")
    round_id, mid, pbytes, sent_at = _UPDATE_HEAD.unpack_from(payload)
    if (len(payload) - _UPDATE_HEAD.size) % 4:
        raise FrameError("update values not a float32 array")
    values = np.frombuffer(payload, np.float32, offset=_UPDATE_HEAD.size)
    return ClientUpdate(client_id=sender, round_id=round_id, mask_id=mid,
                        values=values, payload_bytes=pbytes,
                        sent_at=sent_at)


def encode_ack(round_id: int, status: str) -> bytes:
    return encode_frame(MSG_ACK,
                        _ACK_HEAD.pack(round_id) + status.encode("utf-8"))


def decode_ack(payload: bytes) -> Tuple[int, str]:
    if len(payload) < _ACK_HEAD.size:
        raise FrameError("ack payload too short")
    (round_id,) = _ACK_HEAD.unpack_from(payload)
    return round_id, payload[_ACK_HEAD.size:].decode("utf-8", "replace")
