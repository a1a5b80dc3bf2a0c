"""Peer lifecycle manager (reference internal/p2p/peermanager.go:273).

Tracks the address book and per-peer state: connection status, mutable
score, dial failures with exponential backoff. The Router asks it which
address to dial next and reports accept/dial/disconnect/error events;
reactors learn about peer up/down through `subscribe()` (the reference's
PeerUpdates). The port's copy of tendermint_tpu/p2p/peermanager.py: the
same dial order, scores, backoff and ban quarantine."""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from enum import Enum

from .types import NodeAddress, NodeID, PeerError


class PeerStatus(str, Enum):
    UP = "up"
    DOWN = "down"


@dataclass(frozen=True)
class PeerUpdate:
    node_id: NodeID
    status: PeerStatus


@dataclass
class _PeerInfo:
    node_id: NodeID
    addresses: dict[str, NodeAddress] = field(default_factory=dict)
    persistent: bool = False
    score: int = 0
    dial_failures: int = 0
    last_dial_failure: float = 0.0
    connected: bool = False
    inbound: bool = False
    ever_connected: bool = False  # "good" marker persisted in the book
    bans: int = 0  # promoted bans (PeerError.ban) — escalates the cooldown
    banned_until: float = 0.0  # dial/accept quarantine expiry (monotonic)


class PeerManager:
    def __init__(
        self,
        self_id: NodeID,
        *,
        max_connected: int = 16,
        max_connected_upper: int = 24,  # accept surplus before evicting
        min_retry_time: float = 0.25,
        max_retry_time: float = 30.0,
        addr_book=None,
        logger: logging.Logger | None = None,
    ):
        self.self_id = self_id
        self.max_connected = max_connected
        self.max_connected_upper = max_connected_upper
        self.min_retry_time = min_retry_time
        self.max_retry_time = max_retry_time
        self.logger = logger or logging.getLogger("peermanager")
        self._peers: dict[NodeID, _PeerInfo] = {}
        self._subscribers: list[asyncio.Queue] = []
        self._dial_wake = asyncio.Event()
        # optional persistence (p2p/addrbook.py): addresses learned via
        # PEX survive restarts (reference pex/addrbook.go)
        self.addr_book = addr_book
        self._book_loading = False
        if addr_book is not None:
            # suppress saves while restoring: a mid-load save would
            # truncate the on-disk book to the entries loaded so far
            self._book_loading = True
            try:
                for rec in addr_book.load():
                    self.add_address(rec["address"], persistent=rec["persistent"])
                    if rec["good"]:
                        info = self._peers.get(rec["address"].node_id)
                        if info is not None:
                            info.ever_connected = True
            finally:
                self._book_loading = False

    def _book_entries(self) -> list[dict]:
        out = []
        for info in self._peers.values():
            for addr in info.addresses.values():
                out.append(
                    {
                        "address": addr,
                        "persistent": info.persistent,
                        "good": getattr(info, "ever_connected", False),
                        "attempts": info.dial_failures,
                    }
                )
        return out

    def _book_touch(self) -> None:
        if self.addr_book is not None and not self._book_loading:
            self.addr_book.mark_dirty()
            self.addr_book.maybe_save(self._book_entries)

    def save_addr_book(self) -> None:
        """Force a synchronous write (shutdown path)."""
        if self.addr_book is not None:
            self.addr_book.save(self._book_entries())

    # -- address book ----------------------------------------------------

    def add_address(self, address: NodeAddress, *, persistent: bool = False) -> bool:
        if address.node_id == self.self_id:
            return False
        info = self._peers.setdefault(address.node_id, _PeerInfo(address.node_id))
        info.addresses[str(address)] = address
        info.persistent = info.persistent or persistent
        self._dial_wake.set()
        self._book_touch()
        return True

    def addresses(self, node_id: NodeID) -> list[NodeAddress]:
        info = self._peers.get(node_id)
        return list(info.addresses.values()) if info else []

    def all_known(self) -> list[NodeAddress]:
        out = []
        for info in self._peers.values():
            out.extend(info.addresses.values())
        return out

    def connected_peers(self) -> list[NodeID]:
        return [nid for nid, p in self._peers.items() if p.connected]

    def num_connected(self) -> int:
        return sum(1 for p in self._peers.values() if p.connected)

    # -- dialing ---------------------------------------------------------

    def _retry_delay(self, info: _PeerInfo) -> float:
        if info.dial_failures == 0:
            return 0.0
        return min(
            self.min_retry_time * (2 ** (info.dial_failures - 1)),
            self.max_retry_time,
        )

    def try_dial_next(self) -> NodeAddress | None:
        """Best eligible address to dial, or None (reference
        TryDialNext)."""
        if self.num_connected() >= self.max_connected:
            return None
        now = time.monotonic()
        candidates = [
            p
            for p in self._peers.values()
            if not p.connected
            and p.addresses
            and now >= p.banned_until
            and now - p.last_dial_failure >= self._retry_delay(p)
        ]
        if not candidates:
            return None
        # prefer persistent, then higher score, then fewer failures
        best = max(
            candidates,
            key=lambda p: (p.persistent, p.score, -p.dial_failures),
        )
        return next(iter(best.addresses.values()))

    async def wait_for_dialable(self, timeout: float = 0.5) -> None:
        """Block until an address is (likely) dialable or timeout."""
        try:
            await asyncio.wait_for(self._dial_wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._dial_wake.clear()

    def dial_failed(self, address: NodeAddress) -> None:
        info = self._peers.get(address.node_id)
        if info is not None:
            info.dial_failures += 1
            info.last_dial_failure = time.monotonic()

    # -- connection events ----------------------------------------------

    def connected(self, node_id: NodeID, *, inbound: bool) -> bool:
        """Register a connection; False to refuse (already connected /
        over the upper limit / self)."""
        if node_id == self.self_id:
            return False
        if self.num_connected() >= self.max_connected_upper:
            return False
        info = self._peers.setdefault(node_id, _PeerInfo(node_id))
        if time.monotonic() < info.banned_until:
            return False  # quarantined peers can't reconnect inbound either
        if info.connected:
            return False
        info.connected = True
        info.inbound = inbound
        info.dial_failures = 0
        info.score += 1
        info.ever_connected = True
        self._notify(PeerUpdate(node_id, PeerStatus.UP))
        self._book_touch()
        return True

    def disconnected(self, node_id: NodeID) -> None:
        info = self._peers.get(node_id)
        if info is not None and info.connected:
            info.connected = False
            self._notify(PeerUpdate(node_id, PeerStatus.DOWN))
            self._dial_wake.set()

    # promoted-ban quarantine: first ban sits out BAN_BASE_COOLDOWN,
    # every repeat doubles it (capped), so a persistently bad peer stops
    # being redialed while a once-flaky one recovers in minutes
    BAN_SCORE_PENALTY = 20
    BAN_BASE_COOLDOWN = 60.0
    BAN_MAX_COOLDOWN = 3600.0

    def errored(self, err: PeerError) -> None:
        info = self._peers.get(err.node_id)
        if info is None:
            return
        if getattr(err, "ban", False):
            info.bans += 1
            cooldown = min(
                self.BAN_BASE_COOLDOWN * (2 ** (info.bans - 1)),
                self.BAN_MAX_COOLDOWN,
            )
            info.banned_until = time.monotonic() + cooldown
            info.score -= self.BAN_SCORE_PENALTY
            self.logger.warning(
                "peer %s banned (%s): quarantine %d of %.0fs (score %d)",
                err.node_id[:12],
                err.err,
                info.bans,
                cooldown,
                info.score,
            )
        else:
            info.score -= 5
            self.logger.info(
                "peer %s errored: %s (score %d)", err.node_id[:12], err.err, info.score
            )

    def is_banned(self, node_id: NodeID) -> bool:
        info = self._peers.get(node_id)
        return info is not None and time.monotonic() < info.banned_until

    def peer_score(self, node_id: NodeID) -> int | None:
        """Current reputation score for a known peer (None if unknown).
        Read-only observation surface: the chaos/byzantine auditors
        assert that protocol violations actually COST the violator
        (errored()/ban paths above) without reaching into _peers."""
        info = self._peers.get(node_id)
        return info.score if info is not None else None

    def evict_candidate(self) -> NodeID | None:
        """Lowest-score connected peer when over capacity."""
        if self.num_connected() <= self.max_connected:
            return None
        connected = [p for p in self._peers.values() if p.connected and not p.persistent]
        if not connected:
            return None
        return min(connected, key=lambda p: p.score).node_id

    # -- subscriptions ---------------------------------------------------

    def subscribe(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self._subscribers.append(q)
        return q

    def _notify(self, update: PeerUpdate) -> None:
        for q in self._subscribers:
            try:
                q.put_nowait(update)
            except asyncio.QueueFull:
                self.logger.warning("peer-update subscriber overflowed")
