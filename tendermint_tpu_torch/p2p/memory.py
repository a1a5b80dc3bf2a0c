"""In-memory transport (reference internal/p2p/transport_memory.go) — the
test double that lets whole gossip protocols run in one process with no
sockets. A `MemoryNetwork` is the shared registry; each node creates a
`MemoryTransport` on it keyed by NodeID. The port's copy of
tendermint_tpu/p2p/memory.py."""

from __future__ import annotations

import asyncio

from .transport import Connection, ConnectionClosedError, Transport
from .types import NodeAddress, NodeInfo


class MemoryConnection(Connection):
    def __init__(
        self,
        send_q: asyncio.Queue,
        recv_q: asyncio.Queue,
        remote: str,
    ):
        self._send_q = send_q
        self._recv_q = recv_q
        self._remote = remote
        self._closed = asyncio.Event()

    async def handshake(self, node_info: NodeInfo, priv_key) -> NodeInfo:
        await self._send_q.put(("handshake", node_info))
        kind, peer_info = await self._recv_q.get()
        if kind != "handshake":
            raise ConnectionError("memory handshake out of order")
        return peer_info

    async def send_message(self, channel_id: int, data: bytes) -> None:
        if self._closed.is_set():
            raise ConnectionClosedError("connection closed")
        await self._send_q.put(("msg", (channel_id, bytes(data))))

    async def receive_message(self) -> tuple[int, bytes]:
        """Single queue await per message. The old implementation raced a
        fresh (recv_task, closed_task) pair through asyncio.wait for
        EVERY message — two task objects plus wait/cancel machinery per
        frame, which showed up as a top cost in 150-validator gossip
        profiles. Close is now delivered in-band: both the peer's
        close() and our own push a ("close", None) sentinel into this
        queue (evicting an undelivered frame if full — the connection is
        dying anyway), so a blocked receiver always wakes."""
        if self._closed.is_set():
            raise ConnectionClosedError("connection closed")
        kind, payload = await self._recv_q.get()
        if kind == "close":
            self._closed.set()
            raise ConnectionClosedError("peer closed")
        return payload

    def _push_sentinel(self, q: asyncio.Queue) -> None:
        while True:
            try:
                q.put_nowait(("close", None))
                return
            except asyncio.QueueFull:
                try:
                    q.get_nowait()  # drop a doomed frame to make room
                except asyncio.QueueEmpty:
                    continue

    @property
    def remote_addr(self) -> str:
        return self._remote

    async def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            # wake the remote receiver AND our own blocked receive
            self._push_sentinel(self._send_q)
            self._push_sentinel(self._recv_q)


class MemoryNetwork:
    """Registry connecting MemoryTransports by node id."""

    def __init__(self):
        self.transports: dict[str, "MemoryTransport"] = {}

    def create_transport(self, node_id: str) -> "MemoryTransport":
        t = MemoryTransport(self, node_id)
        self.transports[node_id] = t
        return t


class MemoryTransport(Transport):
    PROTOCOL = "memory"

    def __init__(self, network: MemoryNetwork, node_id: str):
        self.network = network
        self.node_id = node_id
        self._accept_q: asyncio.Queue[MemoryConnection] = asyncio.Queue()
        self._closed = False

    async def listen(self, endpoint: str) -> None:
        pass  # always listening in its registry

    def endpoint(self) -> str | None:
        return self.node_id

    async def accept(self) -> Connection:
        conn = await self._accept_q.get()
        if conn is None or self._closed:
            raise ConnectionClosedError("transport closed")
        return conn

    async def dial(self, address: NodeAddress) -> Connection:
        target = self.network.transports.get(address.node_id)
        if target is None or target._closed:
            raise ConnectionError(f"no memory node {address.node_id!r}")
        a_to_b: asyncio.Queue = asyncio.Queue(maxsize=1024)
        b_to_a: asyncio.Queue = asyncio.Queue(maxsize=1024)
        ours = MemoryConnection(a_to_b, b_to_a, remote=address.node_id)
        theirs = MemoryConnection(b_to_a, a_to_b, remote=self.node_id)
        await target._accept_q.put(theirs)
        return ours

    async def close(self) -> None:
        self._closed = True
        self.network.transports.pop(self.node_id, None)
        self._accept_q.put_nowait(None)
