"""Block pool — schedules concurrent block requests across peers and
hands back blocks in height order (reference internal/blocksync/v0/pool.go:69:
up to 600 in-flight requesters, ≤20 per peer).

`next_requests()` yields (height, peer) assignments; the reactor sends
BlockRequests and feeds responses back via `add_block`. `peek_range`
returns the contiguous run of downloaded blocks starting at `height` —
the unit the reactor feeds to the range-batched verifier.

Resilience: request timeouts are ADAPTIVE per peer — a Jacobson/Karels
RTO (srtt + 4·rttvar, clamped) learned from observed block-response
RTTs, so a fast in-memory peer is re-tried in milliseconds while a slow
WAN peer isn't spuriously timed out. Repeated consecutive timeouts ban
the peer (the reactor drains `take_banned()` and reports a fatal
PeerError) instead of the old single-counter bookkeeping that never
acted on anything."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..libs.clock import SYSTEM, Clock
from ..types.block import Block

REQUEST_WINDOW = 128  # in-flight heights (reference: 600)
PER_PEER_LIMIT = 16  # reference maxPendingRequestsPerPeer=20
REQUEST_TIMEOUT = 15.0  # RTO ceiling (the old fixed timeout)
INITIAL_REQUEST_TIMEOUT = 2.0  # cold-start RTO before any RTT sample (à la TCP)
MIN_REQUEST_TIMEOUT = 0.25  # RTO floor: don't hammer sub-ms in-memory links
BAN_AFTER_TIMEOUTS = 5  # consecutive timeouts before a peer is banned
BAN_COOLDOWN = 30.0  # quarantine; after this the peer may re-register


@dataclass
class _Peer:
    peer_id: str
    base: int = 0
    height: int = 0
    pending: set[int] = field(default_factory=set)
    timeouts: int = 0  # consecutive request timeouts (reset by any block)
    total_timeouts: int = 0
    blocks_served: int = 0
    srtt: float = 0.0  # smoothed RTT, 0 = no sample yet
    rttvar: float = 0.0

    def observe_rtt(self, rtt: float) -> None:
        """Jacobson/Karels (RFC 6298 §2) smoothing."""
        if self.srtt == 0.0:
            self.srtt = rtt
            self.rttvar = rtt / 2
        else:
            self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - rtt)
            self.srtt = 0.875 * self.srtt + 0.125 * rtt
        self.timeouts = 0
        self.blocks_served += 1

    def request_timeout(self) -> float:
        """Adaptive RTO; doubles per consecutive timeout (classic RTO
        backoff) so a degraded peer is probed, not flooded."""
        if self.srtt == 0.0:
            rto = INITIAL_REQUEST_TIMEOUT
        else:
            rto = min(
                max(self.srtt + 4 * self.rttvar, MIN_REQUEST_TIMEOUT),
                REQUEST_TIMEOUT,
            )
        return min(rto * (2**self.timeouts), REQUEST_TIMEOUT)

    def health(self) -> float:
        """Scheduling score, lower = better: load + timeout penalty +
        latency. Drives _pick_peer away from degraded peers before the
        ban threshold is reached."""
        return len(self.pending) + 4.0 * self.timeouts + self.srtt


@dataclass
class _Request:
    height: int
    peer_id: str
    time: float


class BlockPool:
    def __init__(
        self,
        start_height: int,
        *,
        clock: Clock | None = None,
        logger: logging.Logger | None = None,
    ):
        self.height = start_height  # next height to hand to the verifier
        self.logger = logger or logging.getLogger("blockpool")
        # duration domain only (RTO samples, ban cooldowns, grace
        # windows) — never stamped into protocol output; injectable so
        # chaos clock drift skews this node's timeout bookkeeping too
        self._clock = clock or SYSTEM
        self.peers: dict[str, _Peer] = {}
        self.requests: dict[int, _Request] = {}  # height -> outstanding req
        self.blocks: dict[int, tuple[Block, str]] = {}  # height -> (block, provider)
        self.started_at = self._clock.monotonic()
        self._last_advance = self._clock.monotonic()
        # when the peer set last BECAME empty — the zero-peer caught-up
        # grace measures from here, not from pool start, so a transient
        # total peer loss mid-sync doesn't instantly report caught-up
        self._no_peers_since = self._clock.monotonic()
        self._banned: list[str] = []  # drained by the reactor (take_banned)
        # quarantine expiry per banned peer: a TIMED ban, not a permanent
        # one — transient total-loss events (a partition) must not strand
        # the node with an empty peer set after the net heals
        self._ban_until: dict[str, float] = {}

    # -- peers -----------------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        if self._clock.monotonic() < self._ban_until.get(peer_id, 0.0):
            return
        p = self.peers.setdefault(peer_id, _Peer(peer_id))
        p.base, p.height = base, height

    def remove_peer(self, peer_id: str) -> list[int]:
        """Returns heights that must be re-requested."""
        p = self.peers.pop(peer_id, None)
        if p is None:
            return []
        if not self.peers:
            self._no_peers_since = self._clock.monotonic()
        redo = []
        for h in list(p.pending):
            self.requests.pop(h, None)
            if h not in self.blocks:
                redo.append(h)
        return redo

    def take_banned(self) -> list[str]:
        """Peers banned since the last call (for the reactor to report)."""
        out, self._banned = self._banned, []
        return out

    def _ban(self, peer: _Peer) -> None:
        self.logger.info(
            "banning peer %s after %d consecutive request timeouts",
            peer.peer_id[:12],
            peer.timeouts,
        )
        self._ban_until[peer.peer_id] = self._clock.monotonic() + BAN_COOLDOWN
        self._banned.append(peer.peer_id)
        self.remove_peer(peer.peer_id)

    def max_peer_height(self) -> int:
        return max((p.height for p in self.peers.values()), default=0)

    # -- request scheduling ---------------------------------------------

    def next_requests(self) -> list[tuple[int, str]]:
        """Assign un-requested heights within the window to peers with
        capacity (reference makeNextRequests pool.go:394)."""
        out = []
        now = self._clock.monotonic()
        # retry timed-out requests first (per-peer adaptive RTO)
        for h, req in list(self.requests.items()):
            if h in self.blocks:
                continue
            p = self.peers.get(req.peer_id)
            timeout = p.request_timeout() if p is not None else REQUEST_TIMEOUT
            if now - req.time > timeout:
                if p is not None:
                    p.pending.discard(h)
                    p.timeouts += 1
                    p.total_timeouts += 1
                    if p.timeouts >= BAN_AFTER_TIMEOUTS:
                        self._ban(p)  # also clears the peer's requests
                self.requests.pop(h, None)
        for h in range(self.height, self.height + REQUEST_WINDOW):
            if h in self.blocks or h in self.requests:
                continue
            peer = self._pick_peer(h)
            if peer is None:
                continue
            peer.pending.add(h)
            self.requests[h] = _Request(h, peer.peer_id, now)
            out.append((h, peer.peer_id))
        return out

    def _pick_peer(self, height: int) -> _Peer | None:
        best = None
        for p in self.peers.values():
            if not (p.base <= height <= p.height):
                continue
            if len(p.pending) >= PER_PEER_LIMIT:
                continue
            if best is None or p.health() < best.health():
                best = p
        return best

    # -- block intake ----------------------------------------------------

    def add_block(self, peer_id: str, block: Block) -> bool:
        h = block.header.height
        req = self.requests.get(h)
        if h < self.height or h in self.blocks:
            return False
        # accept unsolicited blocks too (reference logs; we take them)
        self.blocks[h] = (block, peer_id)
        p = self.peers.get(peer_id)
        if p is not None:
            p.pending.discard(h)
        if req is not None:
            # free the slot of whichever peer currently holds the
            # assignment (may differ from the sender after a timeout
            # re-assignment)
            assigned = self.peers.get(req.peer_id)
            if assigned is not None:
                assigned.pending.discard(h)
                if req.peer_id == peer_id:
                    assigned.observe_rtt(self._clock.monotonic() - req.time)
            del self.requests[h]
        return True

    def no_block(self, peer_id: str, height: int) -> None:
        req = self.requests.get(height)
        if req is not None and req.peer_id == peer_id:
            del self.requests[height]
            p = self.peers.get(peer_id)
            if p is not None:
                p.pending.discard(height)

    # -- consumption -----------------------------------------------------

    def peek_range(self, max_len: int) -> list[tuple[Block, str]]:
        """Contiguous downloaded blocks starting at self.height. Block-
        sync verification of height h needs h+1's LastCommit, so the
        last block of the run is returned only as the verifier for its
        predecessor (the caller applies [0:-1])."""
        out = []
        h = self.height
        while len(out) < max_len and h in self.blocks:
            out.append(self.blocks[h])
            h += 1
        return out

    def pop(self, height: int) -> None:
        """Block applied; advance."""
        self.blocks.pop(height, None)
        if height >= self.height:
            self.height = height + 1
            self._last_advance = self._clock.monotonic()

    def redo(self, height: int, *bad_peers: str) -> None:
        """Verification failed: drop blocks from the offending providers
        and re-request (reference RedoRequest)."""
        for h in list(self.blocks):
            if h >= height and self.blocks[h][1] in bad_peers:
                del self.blocks[h]
        for pid in bad_peers:
            self.remove_peer(pid)

    def is_caught_up(self) -> bool:
        """Within one block of the best peer (reference pool.go IsCaughtUp):
        caught up once we've waited a startup grace for peers to report AND
        our chain is the longest we know of. No peer-count gate — a solo
        validator (or an isolated node at the tip) must still hand over to
        consensus after the grace period."""
        if self.peers:
            return self.height >= self.max_peer_height()
        # nobody reported a height: give discovery a grace window (from
        # the moment we LAST had no peers, not pool start), then hand
        # over — consensus lag triggers a switch-back if a taller peer
        # shows up later (reactor.resume)
        return self._clock.monotonic() - self._no_peers_since > 5.0
