"""TCP transport: secret connection + channel-tagged message framing
(reference internal/p2p/transport_mconn.go wrapping conn/connection.go).

Message framing on top of the SecretStream byte stream:
  [1-byte type][1-byte channel][4-byte BE length][payload]
types: 0x01 data, 0x02 ping, 0x03 pong. Queue disciplines (priorities,
backpressure) live in the Router's per-peer queues — the wire itself is
FIFO, mirroring the reference's new-stack split where MConnection's
legacy per-channel scheduling moved up into the Router queues.

Hardening (the RouterNet-XL load-test pass — this layer carries real
consensus traffic across processes now):

  * the handshake runs under its own deadline and its NodeInfo frame is
    bounded by MAX_HANDSHAKE_MSG_SIZE (a peer has no business claiming
    a 32 MiB identity before it is authenticated);
  * a full accept queue SHEDS the new socket instead of blocking the
    asyncio server callback (a dial flood must not pin accept slots;
    the shed dialer sees EOF and redials through its own backoff);
  * dead-peer detection: pings have a pong deadline. Any inbound frame
    counts as freshness; when the link is silent past `pong_timeout`
    the connection closes EXPLICITLY (no backoff here — the router's
    reconnect logic owns retry policy). A SIGSTOPped peer's kernel
    keeps ACKing bytes forever; only this timer notices it is gone.

`UDSTransport` is the same stack over a Unix-domain socket (protocol
"unix", the address host carries the socket path) — RouterNet-XL's
lower-overhead inter-process link for same-host worker meshes.

The port's copy of tendermint_tpu/p2p/tcp.py: the same framing, bounds
and timers. `send_meter` / `recv_meter` count the bytes each connection
moved."""

from __future__ import annotations

import asyncio
import struct

from .secret import SecretStream
from .transport import Connection, ConnectionClosedError, Transport
from .types import NodeAddress, NodeInfo, node_id_from_pubkey

_T_DATA = 0x01
_T_PING = 0x02
_T_PONG = 0x03

MAX_MSG_SIZE = 32 * 1024 * 1024
# the handshake NodeInfo frame is tiny (a few strings + a channel list);
# anything bigger is a bomb, not an identity
MAX_HANDSHAKE_MSG_SIZE = 64 * 1024
PING_INTERVAL = 30.0
# silent-link deadline: 3 ping periods of no inbound frames (data, ping
# or pong) and the connection is declared dead and closed
PONG_TIMEOUT = 3 * PING_INTERVAL
HANDSHAKE_TIMEOUT = 20.0


class TCPConnection(Connection):
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        send_rate: int = 0,
        recv_rate: int = 0,
        ping_interval: float = PING_INTERVAL,
        pong_timeout: float = PONG_TIMEOUT,
        handshake_timeout: float = HANDSHAKE_TIMEOUT,
    ):
        self._stream = SecretStream(reader, writer)
        self._writer = writer
        self._send_lock = asyncio.Lock()
        self._closed = False
        self._ping_task: asyncio.Task | None = None
        self._ping_interval = ping_interval
        self._pong_timeout = pong_timeout
        self._handshake_timeout = handshake_timeout
        self._last_alive = 0.0  # loop time of the last inbound frame
        self.close_reason = ""
        # flow-rate limiting (reference conn/connection.go:122-150 via
        # internal/libs/flowrate): senders BLOCK at the configured rate —
        # backpressure propagates to the router's per-peer queue instead
        # of silently dropping consensus messages at a full queue
        from ..libs.flowrate import Meter, RateLimiter

        self._send_limiter = RateLimiter(send_rate) if send_rate else None
        self._recv_limiter = RateLimiter(recv_rate) if recv_rate else None
        self.send_meter = Meter()
        self.recv_meter = Meter()

    async def handshake(self, node_info: NodeInfo, priv_key) -> NodeInfo:
        """STS handshake + NodeInfo exchange, under one deadline: a
        dialer that connects and stalls mid-handshake must cost a
        bounded slice of wall clock, never a leaked reader task."""
        try:
            return await asyncio.wait_for(
                self._handshake_inner(node_info, priv_key),
                self._handshake_timeout,
            )
        except asyncio.TimeoutError:
            await self.close()
            raise ConnectionError("handshake timed out") from None

    async def _handshake_inner(self, node_info: NodeInfo, priv_key) -> NodeInfo:
        peer_key = await self._stream.handshake(priv_key)
        enc = node_info.encode()
        await self._send_raw(_T_DATA, 0xFF, enc)
        # the identity frame from a not-yet-trusted peer gets the small
        # bound, not the 32 MiB data bound
        t, _ch, payload = await self._recv_raw(max_size=MAX_HANDSHAKE_MSG_SIZE)
        if t != _T_DATA:
            raise ConnectionError("expected NodeInfo during handshake")
        peer_info = NodeInfo.decode(payload)
        # the peer's claimed node id must match its authenticated key
        if peer_info.node_id != node_id_from_pubkey(peer_key):
            raise ConnectionError("peer node id does not match its pubkey")
        loop = asyncio.get_running_loop()
        self._last_alive = loop.time()
        self._ping_task = loop.create_task(self._ping_loop())
        return peer_info

    async def _ping_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self._ping_interval)
            if self._closed:
                return
            # pong deadline: any inbound frame refreshes _last_alive; a
            # link silent past the deadline is dead no matter what the
            # kernel's ACK machinery claims (SIGSTOPped peer, half-open
            # NAT path). Close explicitly and let the router redial.
            loop = asyncio.get_running_loop()
            if (
                self._pong_timeout > 0
                and loop.time() - self._last_alive > self._pong_timeout
            ):
                self.close_reason = "pong timeout"
                await self.close()
                return
            try:
                await self._send_raw(_T_PING, 0, b"")
            except Exception:
                return

    async def _send_raw(self, type_: int, channel_id: int, data: bytes) -> None:
        if len(data) > MAX_MSG_SIZE:
            raise ValueError("message too large")
        async with self._send_lock:
            hdr = struct.pack(">BBI", type_, channel_id, len(data))
            await self._stream.write_all(hdr + data)

    async def _recv_raw(self, max_size: int = MAX_MSG_SIZE) -> tuple[int, int, bytes]:
        hdr = await self._stream.read_exactly(6)
        type_, ch, n = struct.unpack(">BBI", hdr)
        if n > max_size:
            raise ConnectionError("oversized message")
        payload = await self._stream.read_exactly(n) if n else b""
        return type_, ch, payload

    async def send_message(self, channel_id: int, data: bytes) -> None:
        if self._closed:
            raise ConnectionClosedError("connection closed")
        if self._send_limiter is not None:
            await self._send_limiter.throttle(len(data) + 6)
        try:
            await self._send_raw(_T_DATA, channel_id, data)
        except (ConnectionError, asyncio.IncompleteReadError, OSError) as e:
            raise ConnectionClosedError(str(e)) from e
        self.send_meter.update(len(data) + 6)

    async def receive_message(self) -> tuple[int, bytes]:
        while True:
            if self._closed:
                raise ConnectionClosedError(
                    self.close_reason or "connection closed"
                )
            try:
                t, ch, payload = await self._recv_raw()
            except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
                raise ConnectionClosedError(
                    self.close_reason or str(e)
                ) from e
            self._last_alive = asyncio.get_running_loop().time()
            if self._recv_limiter is not None:
                # reading slower is the only honest receive throttle TCP
                # offers: the kernel buffer fills and the peer's sender
                # blocks on ITS limiter
                await self._recv_limiter.throttle(len(payload) + 6)
            self.recv_meter.update(len(payload) + 6)
            if t == _T_DATA:
                return ch, payload
            if t == _T_PING:
                try:
                    await self._send_raw(_T_PONG, 0, b"")
                # tmtlint: allow[absorbed-cancellation] -- pong is best-effort; a dead link surfaces on the next read
                except Exception:
                    pass
            # pongs carry no payload: the freshness stamp above is all

    @property
    def remote_addr(self) -> str:
        peername = self._writer.get_extra_info("peername")
        if isinstance(peername, tuple) and len(peername) >= 2:
            return f"{peername[0]}:{peername[1]}"
        return str(peername) if peername else ""

    async def close(self) -> None:
        self._closed = True
        if self._ping_task is not None:
            self._ping_task.cancel()
        self._stream.close()


class TCPTransport(Transport):
    PROTOCOL = "tcp"

    def __init__(
        self,
        *,
        send_rate: int = 0,
        recv_rate: int = 0,
        accept_backlog: int = 64,
        ping_interval: float = PING_INTERVAL,
        pong_timeout: float = PONG_TIMEOUT,
        handshake_timeout: float = HANDSHAKE_TIMEOUT,
    ):
        self._server: asyncio.AbstractServer | None = None
        self._accept_q: asyncio.Queue[TCPConnection | None] = asyncio.Queue(
            accept_backlog
        )
        self._endpoint: str | None = None
        self.send_rate = send_rate
        self.recv_rate = recv_rate
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout
        self.handshake_timeout = handshake_timeout
        self.sheds = 0  # accepted sockets dropped at a full queue

    def _make_conn(self, reader, writer) -> TCPConnection:
        return TCPConnection(
            reader,
            writer,
            send_rate=self.send_rate,
            recv_rate=self.recv_rate,
            ping_interval=self.ping_interval,
            pong_timeout=self.pong_timeout,
            handshake_timeout=self.handshake_timeout,
        )

    async def listen(self, endpoint: str) -> None:
        host, _, port = endpoint.rpartition(":")
        self._server = await asyncio.start_server(
            self._on_client, host or "0.0.0.0", int(port)
        )
        sock = self._server.sockets[0]
        addr = sock.getsockname()
        self._endpoint = f"{addr[0]}:{addr[1]}"

    async def _on_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = self._make_conn(reader, writer)
        try:
            # shed, never block: this callback runs once per inbound
            # socket and a full queue means the router is not draining —
            # parking here would pin every later dialer behind a flood
            self._accept_q.put_nowait(conn)
        except asyncio.QueueFull:
            self.sheds += 1
            await conn.close()

    def endpoint(self) -> str | None:
        return self._endpoint

    async def accept(self) -> Connection:
        conn = await self._accept_q.get()
        if conn is None:
            raise ConnectionClosedError("transport closed")
        return conn

    async def dial(self, address: NodeAddress) -> Connection:
        reader, writer = await asyncio.open_connection(address.host, address.port)
        return self._make_conn(reader, writer)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        # cleanup: sockets accepted but never claimed by the router must
        # not outlive the transport (their reader tasks would leak)
        while True:
            try:
                conn = self._accept_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if conn is not None:
                await conn.close()
        try:
            self._accept_q.put_nowait(None)
        except asyncio.QueueFull:
            pass


class UDSTransport(TCPTransport):
    """The TCP stack over a Unix-domain socket. Addresses use protocol
    "unix" with the socket path in `host` (port stays 0):
    `unix://<nodeid>@/run/xl/w0_n3.sock:0`. Same SecretConnection
    handshake, framing and dead-peer detection — only the dial/listen
    syscalls differ."""

    PROTOCOL = "unix"

    async def listen(self, endpoint: str) -> None:
        self._server = await asyncio.start_unix_server(self._on_client, endpoint)
        self._endpoint = endpoint

    async def dial(self, address: NodeAddress) -> Connection:
        reader, writer = await asyncio.open_unix_connection(address.host)
        return self._make_conn(reader, writer)
