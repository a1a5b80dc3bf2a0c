"""Transport abstraction (reference internal/p2p/transport.go:35,78).

A Transport listens/dials and yields Connections; a Connection moves
(channel_id, bytes) messages after a handshake that exchanges NodeInfo
and proves node identity. Implementations: memory (tests, reference
transport_memory.go) and tcp (secret connection + mux, reference
transport_mconn.go). The port's copy of tendermint_tpu/p2p/transport.py."""

from __future__ import annotations

from .types import NodeAddress, NodeInfo


class Connection:
    async def handshake(self, node_info: NodeInfo, priv_key) -> NodeInfo:
        """Exchange NodeInfo, authenticate the peer, return its info."""
        raise NotImplementedError

    async def send_message(self, channel_id: int, data: bytes) -> None:
        raise NotImplementedError

    async def receive_message(self) -> tuple[int, bytes]:
        """Returns (channel_id, data); raises ConnectionClosedError on EOF."""
        raise NotImplementedError

    @property
    def remote_addr(self) -> str:
        return ""

    async def close(self) -> None:
        raise NotImplementedError


class ConnectionClosedError(ConnectionError):
    pass


class Transport:
    PROTOCOL = ""

    async def listen(self, endpoint: str) -> None:
        raise NotImplementedError

    async def accept(self) -> Connection:
        """Next inbound connection; blocks. Raises when closed."""
        raise NotImplementedError

    async def dial(self, address: NodeAddress) -> Connection:
        raise NotImplementedError

    def endpoint(self) -> str | None:
        """The listening endpoint, once listening."""
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError
