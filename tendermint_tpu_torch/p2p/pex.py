"""Peer exchange (reference internal/p2p/pex/reactor.go, channel 0x00):
nodes periodically ask peers for addresses and fold responses into the
peer manager's address book, bootstrapping mesh connectivity from seeds.
The port's copy of tendermint_tpu/p2p/pex.py (the same frames)."""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass

from ..libs import protoenc as pe
from ..libs.service import Service
from .peermanager import PeerManager, PeerStatus
from .router import Channel
from .types import Envelope, NodeAddress, PeerError

PEX_CHANNEL = 0x00
REQUEST_INTERVAL = 5.0
MAX_ADDRESSES = 100


@dataclass(frozen=True)
class PexRequest:
    pass


@dataclass(frozen=True)
class PexResponse:
    addresses: tuple[str, ...]  # NodeAddress strings


def encode_message(msg) -> bytes:
    if isinstance(msg, PexRequest):
        return pe.message_field(1, b"")
    if isinstance(msg, PexResponse):
        body = b"".join(pe.string_field(1, a) for a in msg.addresses)
        return pe.message_field(2, body)
    raise TypeError(f"unknown pex message {type(msg)}")


def decode_message(data: bytes):
    r = pe.Reader(data)
    f, _wt = r.read_tag()
    body = r.read_bytes()
    if f == 1:
        return PexRequest()
    if f == 2:
        br = pe.Reader(body)
        addrs = []
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                addrs.append(br.read_string())
                # honest responders cap at MAX_ADDRESSES (see
                # _handle_request); a frame past it is malformed, and
                # an unbounded list here would let one hostile peer
                # stuff the address book allocator
                if len(addrs) > MAX_ADDRESSES:
                    raise ValueError(
                        f"pex response exceeds {MAX_ADDRESSES} addresses"
                    )
            else:
                br.skip(bwt)
        return PexResponse(tuple(addrs))
    raise ValueError(f"unknown pex tag {f}")


class PexReactor(Service):
    def __init__(
        self,
        peer_manager: PeerManager,
        channel: Channel,
        peer_updates: asyncio.Queue,
        *,
        seed_mode: bool = False,
        seed_disconnect_after: float = 3.0,
        rng: random.Random | None = None,
        logger: logging.Logger | None = None,
    ):
        super().__init__("pex", logger)
        self.peer_manager = peer_manager
        self.channel = channel
        self.peer_updates = peer_updates
        # peer selection draws from an instance RNG, not the process-
        # global one: the node seeds it from its node id so same-seed
        # chaos runs replay the same gossip targets
        self._rng = rng or random.Random()
        self.peers: list[str] = []
        # seed mode (reference node/node.go:490 makeSeedNode): the node
        # exists only to crawl and serve addresses — on connect it pushes
        # its address book at the peer, then hangs up shortly after, so
        # its connection slots keep turning over
        self.seed_mode = seed_mode
        self.seed_disconnect_after = seed_disconnect_after

    async def on_start(self) -> None:
        self.spawn(self._process_peer_updates(), name="pex.peers")
        self.spawn(self._process_inbound(), name="pex.in")
        self.spawn(self._request_loop(), name="pex.req")

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP:
                if upd.node_id not in self.peers:
                    self.peers.append(upd.node_id)
                if self.seed_mode:
                    self.spawn(
                        self._seed_serve(upd.node_id),
                        name=f"pex.seed.{upd.node_id[:8]}",
                    )
            elif upd.node_id in self.peers:
                self.peers.remove(upd.node_id)

    async def _seed_serve(self, node_id: str) -> None:
        """Push addresses at a fresh peer, then disconnect it."""
        import asyncio as _a

        known = self.peer_manager.all_known()[:MAX_ADDRESSES]
        addrs = tuple(str(a) for a in known if a.node_id != node_id)
        # blocking put: the seed exists to deliver addresses — dropping the
        # push under load and then hanging up would disconnect the peer
        # having taught it nothing. The disconnect timer starts after
        # delivery.
        await self.channel.out_q.put(
            Envelope(PEX_CHANNEL, PexResponse(addrs), to=node_id)
        )
        await _a.sleep(self.seed_disconnect_after)
        if node_id in self.peers:
            await self.channel.error(
                PeerError(node_id, "seed: address exchange complete")
            )

    async def _process_inbound(self) -> None:
        async for env in self.channel:
            msg = env.message
            if isinstance(msg, PexRequest):
                known = self.peer_manager.all_known()[:MAX_ADDRESSES]
                addrs = tuple(
                    str(a) for a in known if a.node_id != env.from_
                )
                try:
                    self.channel.out_q.put_nowait(
                        Envelope(PEX_CHANNEL, PexResponse(addrs), to=env.from_)
                    )
                except asyncio.QueueFull:
                    pass
            elif isinstance(msg, PexResponse):
                if len(msg.addresses) > MAX_ADDRESSES:
                    await self.channel.error(
                        PeerError(env.from_, "oversized pex response")
                    )
                    continue
                added = 0
                for raw in msg.addresses:
                    try:
                        addr = NodeAddress.parse(raw)
                    except ValueError:
                        await self.channel.error(
                            PeerError(env.from_, f"bad pex address {raw!r}")
                        )
                        break
                    if self.peer_manager.add_address(addr):
                        added += 1
                if added:
                    self.logger.debug(
                        "learned %d addresses from %s", added, env.from_[:12]
                    )

    async def _request_loop(self) -> None:
        while True:
            await asyncio.sleep(REQUEST_INTERVAL)
            if not self.peers:
                continue
            peer = self._rng.choice(self.peers)
            try:
                self.channel.out_q.put_nowait(
                    Envelope(PEX_CHANNEL, PexRequest(), to=peer)
                )
            except asyncio.QueueFull:
                pass
