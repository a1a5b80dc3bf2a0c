"""Evidence gossip reactor (reference internal/evidence/reactor.go,
channel 0x38; the port's copy of tendermint_tpu/evidence/reactor.py):
continuously offer all pending evidence to every peer; receivers verify
and pool it (on the pool's device).

One wrinkle the live RouterNet wiring surfaced (tests/test_byzantine.py):
a sender gossips evidence as soon as it verifies locally, but the
receiver may not have COMMITTED the evidence height yet — the pool then
raises "evidence from the future". That is honest-vs-honest timing, not
a protocol violation, and a PeerError here would disconnect a correct
peer (the router evicts on every channel error) while the sender's
`sent` mark means the evidence is never re-offered. Future evidence is
therefore parked in a small bounded buffer and re-verified as this
node's tip advances; only genuinely invalid evidence costs the peer."""

from __future__ import annotations

import asyncio
import logging

from ..libs.service import Service
from ..p2p.peermanager import PeerStatus
from ..p2p.router import Channel
from ..p2p.types import Envelope, PeerError
from ..types.evidence import decode_evidence
from . import EVIDENCE_CHANNEL
from .pool import EvidenceError, EvidencePool

BROADCAST_SLEEP = 0.25
#: parked future-evidence bound: DuplicateVoteEvidence is ~300 bytes,
#: and anything beyond a committee's worth of simultaneous traitors is
#: a flood, not a race
MAX_PARKED = 256
#: heights ahead of our tip we will park for. Honest peers gossip only
#: VERIFIED pending evidence, which sits at most their own tip — a
#: claim far past any live peer's height is junk that would otherwise
#: squat in the bounded park forever (it never stops being "future").
#: Deep laggards lose nothing: evidence beyond this window is already
#: committed ON CHAIN by the time they catch up that far.
PARK_WINDOW = 256


class EvidenceReactor(Service):
    def __init__(
        self,
        pool: EvidencePool,
        channel: Channel,
        peer_updates: asyncio.Queue,
        *,
        logger: logging.Logger | None = None,
    ):
        super().__init__("ev-reactor", logger)
        self.pool = pool
        self.channel = channel
        self.peer_updates = peer_updates
        self._peer_tasks: dict[str, asyncio.Task] = {}
        self._sent: dict[str, set[bytes]] = {}
        # hash -> evidence parked because our tip hasn't reached its
        # height yet; retried as the pool's state advances
        self._parked: dict[bytes, object] = {}

    async def on_start(self) -> None:
        self.spawn(self._process_peer_updates(), name="evr.peers")
        self.spawn(self._process_inbound(), name="evr.in")
        self.spawn(self._retry_parked(), name="evr.retry")

    async def on_stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP:
                if upd.node_id not in self._peer_tasks:
                    self._sent[upd.node_id] = set()
                    self._peer_tasks[upd.node_id] = self.spawn(
                        self._broadcast_to(upd.node_id),
                        name=f"evr.bcast.{upd.node_id[:8]}",
                    )
            else:
                t = self._peer_tasks.pop(upd.node_id, None)
                if t is not None:
                    t.cancel()
                self._sent.pop(upd.node_id, None)

    @staticmethod
    def _verify_height(ev) -> int:
        """The height our tip must reach before the pool can verify this
        evidence. For DuplicateVoteEvidence that is the vote height; a
        LightClientAttackEvidence additionally needs the CONFLICTING
        height committed (the pool compares the forged header against
        our own block there) — its `height` property is the common
        height, which can trail the conflicting height by the whole
        skipping hop."""
        return max(ev.height, getattr(ev, "conflicting_height", ev.height))

    def _is_future(self, ev) -> bool:
        state = self.pool.state
        return (
            state is not None
            and self._verify_height(ev) > state.last_block_height
        )

    async def _process_inbound(self) -> None:
        async for env in self.channel:
            try:
                ev = decode_evidence(env.message) if isinstance(env.message, bytes) else env.message
                if self._is_future(ev):
                    tip = self.pool.state.last_block_height
                    if (
                        self._verify_height(ev) <= tip + PARK_WINDOW
                        and len(self._parked) < MAX_PARKED
                    ):
                        self._parked[ev.hash()] = ev
                    # beyond the window (or park full): drop silently —
                    # unverifiable now, and if genuine it reaches us
                    # committed in a block anyway
                    continue
                self.pool.add_evidence(ev)
            except EvidenceError as e:
                await self.channel.error(PeerError(env.from_, f"bad evidence: {e}"))
            except Exception as e:
                await self.channel.error(PeerError(env.from_, f"evidence: {e!r}"))

    async def _retry_parked(self) -> None:
        """Re-verify parked future evidence once our tip has advanced.
        Invalid evidence found here is silently dropped — the peer that
        sent it was plausible at the time; the pool's own verify keeps
        the chain safe either way."""
        while True:
            await asyncio.sleep(BROADCAST_SLEEP)
            if not self._parked:
                continue
            ready = [
                h for h, ev in self._parked.items() if not self._is_future(ev)
            ]
            for h in ready:
                ev = self._parked.pop(h)
                try:
                    self.pool.add_evidence(ev)
                except Exception as e:  # noqa: BLE001 — best-effort retry
                    self.logger.info("parked evidence rejected: %r", e)

    async def _broadcast_to(self, peer_id: str) -> None:
        sent = self._sent[peer_id]
        while True:
            fresh = False
            for ev in self.pool.pending_evidence(1 << 30)[0]:
                h = ev.hash()
                if h in sent:
                    continue
                # awaited put: backpressure instead of silently losing
                # evidence gossip to this peer
                await self.channel.out_q.put(
                    Envelope(EVIDENCE_CHANNEL, ev, to=peer_id)
                )
                sent.add(h)
                fresh = True
            if not fresh:
                await asyncio.sleep(BROADCAST_SLEEP)
