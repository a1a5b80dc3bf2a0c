"""Message router (reference internal/p2p/router.go:245).

Owns the transports and moves Envelopes between per-reactor Channels and
per-peer connections:

  reactor → channel.out → route_channel task → per-peer priority queue
         → peer send task → connection
  connection → peer recv task → channel.in → reactor

Each peer gets one send task and one recv task (reference router.go
:904,955); outbound messages are scheduled by channel priority (the
reference's pqueue discipline lives here, not on the wire).

The port's copy of tendermint_tpu/p2p/router.py, with the same dial and
handshake timeouts (10 s each), per-peer queues, and the same path from a
reactor's `err_q` to the peer manager. `Channel` is the reference's."""

from __future__ import annotations

import asyncio
import itertools
import logging
from dataclasses import dataclass, field
from typing import Callable

from ..libs import trace
from ..libs.clock import SYSTEM
from ..libs.service import Service
from .peermanager import PeerManager
from .transport import Connection, ConnectionClosedError, Transport
from .types import Envelope, NodeAddress, NodeID, NodeInfo, PeerError


@dataclass
class Channel:
    """Reactor-facing handle (reference router.go:61)."""

    id: int
    name: str
    priority: int
    encode: Callable[[object], bytes]
    decode: Callable[[bytes], object]
    in_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=1024))
    out_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=1024))
    err_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=64))

    async def send(self, envelope: Envelope) -> None:
        await self.out_q.put(envelope)

    async def receive(self) -> Envelope:
        return await self.in_q.get()

    async def error(self, err: PeerError) -> None:
        await self.err_q.put(err)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Envelope:
        return await self.in_q.get()


class _PeerState:
    def __init__(self, queue_size: int = 4096):
        self.queue: asyncio.PriorityQueue = asyncio.PriorityQueue(maxsize=queue_size)
        self.tasks: list[asyncio.Task] = []
        self.conn: Connection | None = None


class Router(Service):
    def __init__(
        self,
        node_info: NodeInfo,
        priv_key,
        peer_manager: PeerManager,
        transports: list[Transport],
        *,
        logger: logging.Logger | None = None,
        peer_queue_size: int = 4096,
    ):
        super().__init__("router", logger)
        self.node_info = node_info
        self.priv_key = priv_key
        self.peer_manager = peer_manager
        # outbound per-peer buffer: committee-scale gossip (50-150
        # validators) has commit-time storms where a 4096 bound silently
        # drops NewRoundStep/HasVote and the net pays a stall-refresh
        # cycle to recover — chaos harnesses size this up
        self.peer_queue_size = peer_queue_size
        self.transports = {t.PROTOCOL: t for t in transports}
        self.channels: dict[int, Channel] = {}
        self._peers: dict[NodeID, _PeerState] = {}
        self._seq = itertools.count()  # FIFO tie-break in priority queues

    # -- channels --------------------------------------------------------

    def open_channel(
        self,
        channel_id: int,
        *,
        name: str = "",
        priority: int = 5,
        encode: Callable[[object], bytes] = bytes,
        decode: Callable[[bytes], object] = bytes,
        queue_size: int = 1024,
    ) -> Channel:
        if channel_id in self.channels:
            raise ValueError(f"channel {channel_id:#x} already open")
        ch = Channel(
            id=channel_id,
            name=name or f"ch{channel_id:#x}",
            priority=priority,
            encode=encode,
            decode=decode,
            in_q=asyncio.Queue(maxsize=queue_size),
            out_q=asyncio.Queue(maxsize=queue_size),
        )
        self.channels[channel_id] = ch
        # update advertised channels
        self.node_info = NodeInfo(
            **{
                **self.node_info.__dict__,
                "channels": bytes(sorted(self.channels)),
            }
        )
        return ch

    # -- lifecycle -------------------------------------------------------

    async def on_start(self) -> None:
        for ch in self.channels.values():
            self.spawn(self._route_channel(ch), name=f"router.ch.{ch.name}")
            self.spawn(self._route_errors(ch), name=f"router.err.{ch.name}")
        for transport in self.transports.values():
            self.spawn(self._accept_peers(transport), name="router.accept")
        self.spawn(self._dial_peers(), name="router.dial")

    async def on_stop(self) -> None:
        for transport in self.transports.values():
            try:
                await transport.close()
            except Exception as e:
                self.logger.debug("transport close failed: %r", e)
        for peer in list(self._peers.values()):
            await self._teardown_peer_state(peer)

    async def _teardown_peer_state(self, peer: _PeerState) -> None:
        if peer.conn is not None:
            await peer.conn.close()
        for t in peer.tasks:
            t.cancel()

    # -- channel routing -------------------------------------------------

    async def _route_channel(self, ch: Channel) -> None:
        """Move envelopes from a channel's out queue to peer queues
        (reference routeChannel router.go:416)."""
        while self.is_running:
            env = await ch.out_q.get()
            if env.broadcast:
                targets = list(self._peers.keys())
            elif env.to:
                targets = [env.to] if env.to in self._peers else []
            else:
                self.logger.error("dropping envelope with no recipient on %s", ch.name)
                continue
            if not targets:
                continue
            try:
                raw = env.message if isinstance(env.message, bytes) else ch.encode(env.message)
            except Exception as e:
                self.logger.error("failed to encode on %s: %r", ch.name, e)
                continue
            for nid in targets:
                peer = self._peers.get(nid)
                if peer is None:
                    continue
                item = (-ch.priority, next(self._seq), ch.id, raw)
                try:
                    peer.queue.put_nowait(item)
                except asyncio.QueueFull:
                    self.logger.warning("dropping message to %s: queue full", nid[:12])

    async def _route_errors(self, ch: Channel) -> None:
        while self.is_running:
            err = await ch.err_q.get()
            self.peer_manager.errored(err)
            if err.fatal:
                await self._disconnect_peer(err.node_id)

    async def _disconnect_peer(self, node_id: NodeID) -> None:
        peer = self._peers.pop(node_id, None)
        if peer is None:
            return
        await self._teardown_peer_state(peer)
        self.peer_manager.disconnected(node_id)

    # -- peer connection lifecycle --------------------------------------

    async def _accept_peers(self, transport: Transport) -> None:
        """Reference acceptPeers router.go:563."""
        while self.is_running:
            try:
                conn = await transport.accept()
            except (ConnectionClosedError, ConnectionError):
                return
            self.spawn(
                self._handshake_peer(conn, inbound=True),
                name="router.handshake",
            )

    async def _dial_peers(self) -> None:
        """Reference dialPeers router.go:646. The loop re-checks
        `is_running`: pre-3.11 asyncio.wait_for (used by wait_for_dialable
        and the dial timeout) can ABSORB a cancellation that races the
        inner future, which would otherwise leave this loop running as a
        zombie after stop()."""
        while self.is_running:
            address = self.peer_manager.try_dial_next()
            if address is None:
                await self.peer_manager.wait_for_dialable()
                continue
            transport = self.transports.get(address.protocol)
            if transport is None:
                self.logger.error("no transport for %s", address.protocol)
                self.peer_manager.dial_failed(address)
                continue
            try:
                conn = await asyncio.wait_for(transport.dial(address), timeout=10)
            except Exception as e:
                self.logger.debug("dial %s failed: %r", address, e)
                self.peer_manager.dial_failed(address)
                continue
            await self._handshake_peer(conn, inbound=False, expect=address.node_id)

    async def _handshake_peer(
        self, conn: Connection, *, inbound: bool, expect: NodeID | None = None
    ) -> None:
        try:
            peer_info = await asyncio.wait_for(
                conn.handshake(self.node_info, self.priv_key), timeout=10
            )
        except Exception as e:
            self.logger.debug("handshake failed: %r", e)
            await conn.close()
            return
        nid = peer_info.node_id
        if expect is not None and nid != expect:
            self.logger.warning("dialed %s but got %s", expect[:12], nid[:12])
            await conn.close()
            return
        reason = self.node_info.compatible_with(peer_info)
        if reason is not None:
            self.logger.debug("refusing incompatible peer %s: %s", nid[:12], reason)
            await conn.close()
            return
        if not self.peer_manager.connected(nid, inbound=inbound):
            await conn.close()
            return
        peer = _PeerState(self.peer_queue_size)
        peer.conn = conn
        self._peers[nid] = peer
        peer.tasks.append(
            self.spawn(self._send_peer(nid, peer), name=f"router.send.{nid[:8]}")
        )
        peer.tasks.append(
            self.spawn(self._recv_peer(nid, conn), name=f"router.recv.{nid[:8]}")
        )
        self.logger.info("peer up %s (%s)", nid[:12], "in" if inbound else "out")

    async def _send_peer(self, nid: NodeID, peer: _PeerState) -> None:
        """Reference routePeer send side router.go:904."""
        try:
            while True:
                _prio, _seq, ch_id, raw = await peer.queue.get()
                await peer.conn.send_message(ch_id, raw)
        except (ConnectionClosedError, ConnectionError):
            pass
        finally:
            self.spawn(self._disconnect_peer(nid))

    async def _recv_peer(self, nid: NodeID, conn: Connection) -> None:
        """Reference routePeer recv side router.go:955."""
        try:
            while True:
                ch_id, raw = await conn.receive_message()
                # the flight recorder's "gossip byte" edge: stamped before
                # decode so the receive span includes decode cost. Zero
                # overhead when tracing is off.
                recv_at = SYSTEM.monotonic() if trace.is_enabled() else 0.0
                ch = self.channels.get(ch_id)
                if ch is None:
                    continue  # unknown channel: ignore (peer may be newer)
                try:
                    msg = ch.decode(raw)
                except Exception as e:
                    await ch.error(PeerError(nid, f"malformed message: {e!r}"))
                    continue
                env = Envelope(
                    channel_id=ch_id, message=msg, raw=raw, from_=nid,
                    recv_at=recv_at,
                )
                try:
                    ch.in_q.put_nowait(env)
                except asyncio.QueueFull:
                    self.logger.warning(
                        "dropping inbound on %s from %s: queue full", ch.name, nid[:12]
                    )
        except (ConnectionClosedError, ConnectionError):
            pass
        finally:
            self.spawn(self._disconnect_peer(nid))
