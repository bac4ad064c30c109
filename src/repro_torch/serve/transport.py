"""Pluggable transport boundary for the streaming parameter server
(counterpart of ``repro.serve.transport``).

Every transport moves the SAME length-prefixed checksummed frames
(``repro_torch.serve.protocol``'s frame layer) between client endpoints and one
:class:`ServerBinding` — the server-side dispatcher that decodes a frame,
drives the :class:`~repro_torch.serve.server.ByzantineRobustServer`, and encodes
the response:

* ``ANNOUNCE_REQ``  -> the current :class:`RoundAnnouncement` frame
  (blocking through an in-flight apply until the next round is open);
* ``UPDATE``        -> ``server.submit`` + an ``ACK("queued")`` frame —
  submission is queue-and-classify, so resubmitting the same update is
  idempotent (the :class:`RoundBuffer` dedups duplicate deliveries);
* a frame whose payload fails its CRC -> the server is told to count a
  protocol fault against the (attributable) sender and the client gets
  ``ACK("bad_checksum")`` — corruption NEVER reaches the batcher.

Two transports ship:

:class:`LoopbackTransport`
    In-process: a client endpoint's ``request()`` runs the binding on the
    calling thread. Frames still encode/decode (float32 values round-trip
    bitwise), so loopback trajectories are bitwise the in-process
    server's.

:class:`TcpTransport`
    Real sockets on localhost (or any interface): a listener thread
    accepts connections, one reader thread per connection splits frames by
    the header's length field (a corrupt payload still frames correctly —
    the CRC is validated later, by the binding) and writes responses back.

Both support ``bind(server)`` / ``unbind()`` re-binding so a chaos
harness can kill a server mid-round and attach a restarted one to the
same endpoints: client requests between unbind and rebind raise
:class:`TransportReset`, which the retrying clients back off and retry.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.serve import protocol


class TransportError(Exception):
    """Base class of transport-level delivery failures (retryable)."""


class TransportTimeout(TransportError):
    """The request (or its response) never arrived in time."""


class TransportReset(TransportError):
    """The connection was reset mid-exchange (server kill, socket reset)."""


class ServerBinding:
    """Server-side frame dispatcher shared by every transport."""

    def __init__(self, server, announce_timeout_s: float = 30.0):
        self.server = server
        self.announce_timeout_s = announce_timeout_s

    def handle(self, raw: bytes) -> bytes:
        """Decode one request frame, drive the server, encode the
        response. Never raises on malformed input — protocol faults are
        classified and NACKed, which is what keeps the batcher alive under
        byte-level corruption."""
        try:
            msg_type, sender, payload = protocol.decode_frame(raw)
        except protocol.BadChecksum as e:
            if e.sender is not None and e.sender >= 0:
                self.server.note_protocol_fault(e.sender)
            return protocol.encode_ack(-1, "bad_checksum")
        except protocol.FrameError:
            return protocol.encode_ack(-1, "bad_frame")

        if msg_type == protocol.MSG_ANNOUNCE_REQ:
            try:
                min_round = protocol.decode_announce_req(payload)
            except protocol.FrameError:
                return protocol.encode_ack(-1, "bad_frame")
            try:
                ann = self.server.announce(timeout=self.announce_timeout_s,
                                           min_round=min_round)
            except TimeoutError:
                return protocol.encode_ack(-1, "no_round")
            return protocol.encode_announcement(ann)

        if msg_type == protocol.MSG_UPDATE:
            try:
                update = protocol.decode_update(payload, sender)
            except protocol.FrameError:
                return protocol.encode_ack(-1, "bad_frame")
            if sender >= 0:
                self.server.note_protocol_ok(sender)
            try:
                self.server.submit(update)
            except ValueError as e:
                return protocol.encode_ack(update.round_id,
                                           f"rejected: {e}")
            return protocol.encode_ack(update.round_id, "queued")

        return protocol.encode_ack(-1, "bad_type")


# --------------------------------------------------------------------------
# Loopback: in-process frames, bitwise the in-process server
# --------------------------------------------------------------------------


class LoopbackEndpoint:
    """One client's in-process endpoint (thread-safe: the binding locks on
    the server's own condition)."""

    def __init__(self, transport: "LoopbackTransport", client_id: int):
        self._transport = transport
        self.client_id = client_id

    def request(self, raw: bytes, **ctx) -> bytes:
        binding = self._transport._binding
        if binding is None:
            raise TransportReset("loopback: no server bound")
        return binding.handle(raw)

    def close(self) -> None:
        pass


class LoopbackTransport:
    """In-process transport: frames are handed straight to the binding."""

    def __init__(self, server=None, announce_timeout_s: float = 30.0):
        self.announce_timeout_s = announce_timeout_s
        self._binding: Optional[ServerBinding] = None
        if server is not None:
            self.bind(server)

    def bind(self, server) -> "LoopbackTransport":
        self._binding = ServerBinding(server, self.announce_timeout_s)
        return self

    def unbind(self) -> None:
        self._binding = None

    def connect(self, client_id: int) -> LoopbackEndpoint:
        return LoopbackEndpoint(self, client_id)

    def close(self) -> None:
        self.unbind()


# --------------------------------------------------------------------------
# TCP: real sockets, framed by the header length field
# --------------------------------------------------------------------------


def _read_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket. In place: appending each chunk to a
    growing ``bytes`` copies the frame once per chunk, quadratic in its
    size (a 4 MiB update arrives in ~64 KiB chunks)."""
    got = 0
    while got < len(view):
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionResetError("peer closed mid-frame")
        got += k


def _read_frame(sock: socket.socket) -> bytes:
    header = bytearray(protocol.HEADER_SIZE)
    _read_into(sock, memoryview(header))
    total = protocol.frame_length(bytes(header))  # FrameError on bad magic
    frame = bytearray(total)
    frame[:protocol.HEADER_SIZE] = header
    _read_into(sock, memoryview(frame)[protocol.HEADER_SIZE:])
    return bytes(frame)


class TcpEndpoint:
    """One client's socket endpoint. Connects lazily, reconnects after a
    reset (the transport's address survives a server restart)."""

    def __init__(self, transport: "TcpTransport", client_id: int,
                 timeout_s: float = 2.0):
        self._transport = transport
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        addr = self._transport.address
        if addr is None:
            raise TransportReset("tcp: no server bound")
        try:
            sock = socket.create_connection(addr, timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except socket.timeout as e:
            raise TransportTimeout(f"tcp connect to {addr}: {e}") from e
        except OSError as e:
            raise TransportReset(f"tcp connect to {addr}: {e}") from e
        return sock

    def request(self, raw: bytes, **ctx) -> bytes:
        if self._sock is None:
            self._sock = self._connect()
        try:
            self._sock.sendall(raw)
            return _read_frame(self._sock)
        except socket.timeout as e:
            self.close()
            raise TransportTimeout(f"tcp request: {e}") from e
        except (ConnectionError, BrokenPipeError, OSError,
                protocol.FrameError) as e:
            self.close()
            raise TransportReset(f"tcp request: {e}") from e

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class TcpTransport:
    """Socket transport: a listener + one reader thread per connection."""

    def __init__(self, server=None, host: str = "127.0.0.1", port: int = 0,
                 announce_timeout_s: float = 30.0,
                 client_timeout_s: float = 2.0):
        self.host = host
        self._requested_port = port
        self.announce_timeout_s = announce_timeout_s
        self.client_timeout_s = client_timeout_s
        self._binding: Optional[ServerBinding] = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.address: Optional[Tuple[str, int]] = None
        if server is not None:
            self.bind(server)

    def bind(self, server) -> "TcpTransport":
        if self._listener is not None:
            self.unbind()
        self._binding = ServerBinding(server, self.announce_timeout_s)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self._requested_port))
        listener.listen(64)
        # a finite accept timeout so the accept thread polls _stop: a
        # close() from another thread does NOT wake a blocked accept() on
        # Linux — the in-flight syscall keeps the kernel socket alive and
        # the port stays bound (EADDRINUSE on the crash-restart rebind)
        listener.settimeout(0.25)
        # keep the SAME port across a rebind so endpoints survive restarts
        self._requested_port = listener.getsockname()[1]
        self.address = listener.getsockname()[:2]
        self._listener = listener
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-tcp-accept", daemon=True)
        self._accept_thread.start()
        return self

    def unbind(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                # abortive close (RST): a graceful close leaves the
                # (host, port) tuples in FIN_WAIT/TIME_WAIT and blocks the
                # crash-restart rebind of the SAME port with EADDRINUSE;
                # retrying clients reconnect regardless
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                # close() alone leaves a reader thread blocked in recv()
                # holding the kernel socket open — shutdown() wakes it
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._binding = None

    close = unbind

    def connect(self, client_id: int) -> TcpEndpoint:
        return TcpEndpoint(self, client_id, timeout_s=self.client_timeout_s)

    # -- server-side loops -------------------------------------------------

    def _accept_loop(self) -> None:
        listener = self._listener
        while not self._stop.is_set() and listener is not None:
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue                    # poll _stop (see bind())
            except OSError:
                return                      # listener closed (unbind)
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="serve-tcp-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        binding = self._binding
        try:
            while not self._stop.is_set() and binding is not None:
                try:
                    raw = _read_frame(conn)
                except protocol.FrameError:
                    return                  # unframeable stream: drop conn
                conn.sendall(binding.handle(raw))
        except (ConnectionError, BrokenPipeError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)


TRANSPORTS = ("loopback", "tcp")


def make_transport(kind: str, **kw):
    """Build an unbound transport by name (``loopback`` | ``tcp``)."""
    if kind == "loopback":
        return LoopbackTransport(**kw)
    if kind == "tcp":
        return TcpTransport(**kw)
    raise ValueError(
        f"unknown transport {kind!r} (expected one of {TRANSPORTS})")
