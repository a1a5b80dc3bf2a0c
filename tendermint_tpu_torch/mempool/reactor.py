"""Mempool gossip reactor (reference internal/mempool/v1/reactor.go,
channel 0x30; the port's copy of tendermint_tpu/mempool/reactor.py).

Each peer gets a broadcast task walking the mempool in priority order and
sending txs that peer hasn't been seen to have (either from us earlier or
because the peer itself sent it to us — tracked in WrappedTx.peers).
Per-tx fan-out is capped (`MempoolConfig.gossip_fanout`): once a tx has
been pushed to that many peers the rest rely on transitive gossip, so a
flood costs each node O(fanout) sends per tx, not O(peers).

Inbound txs route through TxIngress when the node runs one: dedup +
signature pre-verification happen BEFORE the ABCI CheckTx round-trip,
and a busy pipeline sheds (the peer re-offers later) instead of
buffering unboundedly."""

from __future__ import annotations

import asyncio
import logging

from ..libs import protoenc as pe
from ..libs.service import Service
from ..p2p.peermanager import PeerStatus
from ..p2p.router import Channel
from ..p2p.types import Envelope, PeerError
from . import MEMPOOL_CHANNEL
from .ingress import TxIngress
from .pool import PriorityMempool, TxInCacheError, TxRejectedError

BROADCAST_SLEEP = 0.05

# Wire-side sanity bound: a gossip frame is sent one-tx-at-a-time by
# honest peers (see _broadcast_routine), so a frame repeating thousands
# of tx fields is malformed by construction — raise at decode, never
# build an unbounded list (wire bounds; the decoded txs also
# each pass through the ingress size/occupancy checks afterwards).
MAX_WIRE_TXS = 1024


def encode_txs(txs: list[bytes]) -> bytes:
    return b"".join(pe.bytes_field(1, tx) for tx in txs)


def decode_txs(data: bytes) -> list[bytes]:
    r = pe.Reader(data)
    out = []
    while not r.eof():
        f, wt = r.read_tag()
        if f == 1:
            out.append(r.read_bytes())
            if len(out) > MAX_WIRE_TXS:
                raise ValueError(f"tx gossip frame exceeds {MAX_WIRE_TXS} txs")
        else:
            r.skip(wt)
    return out


class MempoolReactor(Service):
    def __init__(
        self,
        mempool: PriorityMempool,
        channel: Channel,
        peer_updates: asyncio.Queue,
        *,
        ingress: TxIngress | None = None,
        broadcast: bool = True,
        logger: logging.Logger | None = None,
    ):
        super().__init__("mp-reactor", logger)
        self.mempool = mempool
        self.ingress = ingress
        self.channel = channel
        self.peer_updates = peer_updates
        self.broadcast = broadcast
        self._peer_tasks: dict[str, asyncio.Task] = {}
        self._sent: dict[str, set[bytes]] = {}  # peer -> tx hashes sent

    async def on_start(self) -> None:
        self.spawn(self._process_peer_updates(), name="mpr.peers")
        self.spawn(self._process_inbound(), name="mpr.in")

    async def on_stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP and self.broadcast:
                if upd.node_id not in self._peer_tasks:
                    self._sent[upd.node_id] = set()
                    self._peer_tasks[upd.node_id] = self.spawn(
                        self._broadcast_to(upd.node_id),
                        name=f"mpr.bcast.{upd.node_id[:8]}",
                    )
            elif upd.status == PeerStatus.DOWN:
                t = self._peer_tasks.pop(upd.node_id, None)
                if t is not None:
                    t.cancel()
                self._sent.pop(upd.node_id, None)

    async def _process_inbound(self) -> None:
        async for env in self.channel:
            if self.ingress is not None:
                # staged admission, fire-and-forget: dedup + signature
                # pre-verify happen before any tx costs an ABCI
                # round-trip, a full pipeline sheds (the peer re-offers),
                # and a parked nonce-gap tx never stalls this loop. The
                # ingress pre-retrieves every rejection future's
                # exception, so dropping the handle leaks nothing.
                for tx in env.message:
                    self.ingress.submit_nowait(tx, source=env.from_)
                continue
            for tx in env.message:
                try:
                    await self.mempool.check_tx(tx, sender=env.from_)
                except TxInCacheError:
                    pass
                except TxRejectedError:
                    pass  # invalid per app: not the peer's fault per se
                except Exception as e:
                    await self.channel.error(PeerError(env.from_, f"tx: {e!r}"))

    async def _broadcast_to(self, peer_id: str) -> None:
        """Reference broadcastTxRoutine: walk resident txs, skip ones the
        peer already has (sent by us earlier, or the peer was a gossip
        source — WrappedTx.peers — so it is never echoed its own tx) and
        ones already pushed to `gossip_fanout` peers."""
        sent = self._sent[peer_id]
        fanout = self.mempool.config.gossip_fanout
        while True:
            batch, picked = [], []
            for wtx in self.mempool.all_entries():
                if wtx.hash in sent or peer_id in wtx.peers:
                    continue
                if fanout > 0 and wtx.gossiped >= fanout:
                    continue  # fan-out cap: transitive gossip covers the rest
                # claim the fan-out slot at selection (before any await):
                # concurrent per-peer tasks must not all pick the same tx
                wtx.gossiped += 1
                sent.add(wtx.hash)
                batch.append(wtx.tx)
                picked.append(wtx)
                if len(batch) >= 100:
                    break
            if batch:
                try:
                    # awaited put: backpressure instead of silent tx loss
                    await self.channel.out_q.put(
                        Envelope(MEMPOOL_CHANNEL, batch, to=peer_id)
                    )
                except asyncio.CancelledError:
                    # peer went DOWN mid-send: give the claimed fan-out
                    # slots back, or churn could exhaust a tx's budget
                    # with zero deliveries
                    for wtx in picked:
                        wtx.gossiped -= 1
                        sent.discard(wtx.hash)
                    raise
            else:
                await asyncio.sleep(BROADCAST_SLEEP)
