"""Statesync reactor (the port's copy of tendermint_tpu/statesync/reactor.py;
reference internal/statesync/reactor.go:142).

Serving side: answers snapshot discovery from BootD's manifest
(statesync/fleet.py — committed/pruned off the consensus hot path),
chunk requests through BootD's bounded sessions + shared chunk cache
(a shed becomes ``ChunkResponse(busy=True)`` — backpressure the joiner
retries, never a failure), light-block requests (single and batched)
from the local stores, and params requests from the state store.

Syncing side (`sync()`, reference Sync :269 + syncer.go):
  1. discover snapshots from peers (0x60); candidates are keyed by
     CONTENT (height, format, hash, chunks), so a Byzantine donor's
     poisoned offer is a distinct candidate that fails alone instead
     of shadowing the honest snapshot at the same height
  2. verify the target height's header via the light client over the
     p2p light-block channel (0x62) — the state provider
  3. offer the snapshot to the app; fetch chunks in parallel (0x61);
     ApplySnapshotChunk until accepted. A rejected restore costs every
     provider that served bytes a `PeerError` (score hit) and the
     joiner moves to the next candidate — poison never wedges a join
  4. verify the app's restored hash against the verified header
  5. bootstrap State + block store, then Backfill recent headers:
     fetched in batched windows (0x62 batch frames), hash-chain linked
     (reference reactor.go:348,481) AND signature-verified on the
     backfill lane — one funnel call per window, one aggregate pairing
     per height for BLS committees (statesync/fleet.verify_backfill_batch)

The reactor resolves its `device` when it is built (the default "cuda"
raises without a card) and verifies on it: the light client that checks
the snapshot's headers and every backfill window. The per-peer
`CircuitBreaker` and `BackoffPolicy` are network policy: they pace
fetches from peers, not the card. A device error (`crypto.batch.
DeviceError`) in a restore raises out of `sync()`; the next snapshot is
tried only after a bad snapshot.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from fractions import Fraction

from ..abci import types as abci
from ..crypto.batch import DeviceError
from ..device import DEFAULT_DEVICE, resolve
from ..libs import trace
from ..libs.retry import BackoffPolicy, CircuitBreaker
from ..libs.service import Service
from ..light.client import LightClient, TrustOptions, TrustedStore
from ..light.provider import LightBlockNotFoundError, Provider
from ..light.types import LightBlock, SignedHeader
from ..p2p.peermanager import PeerStatus
from ..p2p.router import Channel
from ..p2p.types import Envelope, PeerError
from ..state.state import State
from ..types.block import BlockID
from ..types.validation import InvalidCommitError
from . import CHUNK_CHANNEL, LIGHT_BLOCK_CHANNEL, PARAMS_CHANNEL, SNAPSHOT_CHANNEL
from . import messages as m
from .fleet import BootD, BootDBusyError, verify_backfill_batch

DISCOVERY_TIME = 2.0
CHUNK_TIMEOUT = 10.0
CHUNK_FETCHERS = 4
# discovered-snapshot candidates kept (decode-bound discipline at the
# ingest point: discovery is broadcast-fed, so the dict must be bounded
# even though each frame is individually clamped)
MAX_DISCOVERED_SNAPSHOTS = 32
# restore attempts per discovered snapshot before it is abandoned: a
# poisoned serve costs the PEER (ban + provider-set removal), so the
# retry runs against the survivors — bounded so a restore that fails
# for a non-attributable reason cannot loop forever
MAX_SNAPSHOT_ATTEMPTS = 3
# inter-attempt backoff for peer fetches (light blocks, chunks, params):
# full jitter keeps a burst of failed fetchers from re-hammering the same
# peer in lockstep
FETCH_BACKOFF = BackoffPolicy(base=0.05, cap=2.0)


@dataclass(frozen=True)
class SyncConfig:
    """Trust anchor for the state provider (reference config
    statesync section: trust-height/trust-hash/trust-period).

    backfill_blocks: explicit backfill depth override (tests); None (the
    default) derives the depth from the chain's evidence params — far
    enough back that any non-expired evidence remains verifiable
    (reference internal/statesync/reactor.go:348-369)."""

    trust_height: int
    trust_hash: bytes
    trust_period_ns: int = 7 * 24 * 3600 * 10**9
    backfill_blocks: int | None = None


class SyncAbortedError(RuntimeError):
    pass


class _Dispatcher(Provider):
    """Request/response correlation for light-block fetches over p2p
    (reference internal/statesync/dispatcher.go). Round-robins peers."""

    def __init__(self, reactor: "StateSyncReactor"):
        self.reactor = reactor
        self._pending: dict[int, asyncio.Future] = {}
        self._rr = 0

    def chain_id(self) -> str:
        return self.reactor.chain_id

    async def light_block(self, height: int) -> LightBlock:
        peers = list(self.reactor.peers)
        if not peers:
            raise LightBlockNotFoundError("no peers to fetch light blocks from")
        last_err: Exception | None = None
        missing_from: set[str] = set()
        # two round-robin passes with jittered backoff between failures: a
        # request dropped by a lossy link gets a second chance at the same
        # peer instead of failing the whole backfill step
        for attempt in range(2 * len(peers)):
            peer = peers[(self._rr + attempt) % len(peers)]
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[height] = fut
            self.reactor._send(
                self.reactor.lb_ch, m.LightBlockRequest(height), to=peer
            )
            try:
                lb = await asyncio.wait_for(fut, timeout=5.0)
                if lb is not None:
                    self._rr += 1
                    return lb
                last_err = LightBlockNotFoundError(f"peer {peer[:12]} lacks {height}")
                missing_from.add(peer)
                if len(missing_from) >= len(peers):
                    # every DISTINCT peer answered "don't have it" (a peer
                    # that merely timed out still gets its second pass)
                    break
            except asyncio.TimeoutError:
                last_err = LightBlockNotFoundError(f"timeout from {peer[:12]}")
                await asyncio.sleep(FETCH_BACKOFF.sleep_for(attempt))
            finally:
                self._pending.pop(height, None)
        raise last_err or LightBlockNotFoundError(str(height))

    def deliver(self, lb: LightBlock | None, height_hint: int | None = None) -> None:
        height = lb.height if lb is not None else height_hint
        fut = self._pending.get(height) if height is not None else None
        if fut is None and lb is None and self._pending:
            # a 'missing' reply carries no height; resolve the oldest
            height, fut = next(iter(self._pending.items()))
        if fut is not None and not fut.done():
            fut.set_result(lb)

    async def report_evidence(self, evidence) -> None:
        pass  # evidence reactor handles gossip


class StateSyncReactor(Service):
    def __init__(
        self,
        chain_id: str,
        app_conns,
        state_store,
        block_store,
        snapshot_ch: Channel,
        chunk_ch: Channel,
        lb_ch: Channel,
        params_ch: Channel,
        peer_updates: asyncio.Queue,
        *,
        initial_height: int = 1,
        bootd: BootD | None = None,
        bootd_config=None,
        logger: logging.Logger | None = None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__("ss-reactor", logger)
        self.device = resolve(device)
        self.chain_id = chain_id
        self.initial_height = initial_height
        self.app_conns = app_conns
        self.state_store = state_store
        self.block_store = block_store
        self.snapshot_ch = snapshot_ch
        self.chunk_ch = chunk_ch
        self.lb_ch = lb_ch
        self.params_ch = params_ch
        self.peer_updates = peer_updates
        self.peers: list[str] = []
        self.dispatcher = _Dispatcher(self)
        # the serving layer: bounded chunk sessions + shared chunk cache
        # + the manifest commit/prune loop (statesync/fleet.py). Owned
        # unless the caller shares one across reactors.
        self.bootd = bootd or BootD(app_conns, config=bootd_config)
        self._owns_bootd = bootd is None
        # discovery results, keyed by snapshot CONTENT so a poisoned
        # offer at an honest height stays a separate candidate:
        # (height, format, hash, chunks) -> (snapshot, set(providers))
        self._snapshots: dict[
            tuple[int, int, bytes, int], tuple[m.SnapshotsResponse, set[str]]
        ] = {}
        self._chunk_futures: dict[tuple[int, int, int], asyncio.Future] = {}
        self._batch_futures: dict[int, asyncio.Future] = {}
        self._params_futures: dict[int, asyncio.Future] = {}
        # per-provider chunk-serving health: a peer that repeatedly times
        # out is skipped (fail fast) until its breaker half-opens
        self._peer_breakers: dict[str, CircuitBreaker] = {}

    def _breaker(self, peer: str) -> CircuitBreaker:
        br = self._peer_breakers.get(peer)
        if br is None:
            br = self._peer_breakers[peer] = CircuitBreaker(
                failure_threshold=4, reset_timeout=10.0, name=f"ss-{peer[:8]}"
            )
        return br

    async def on_start(self) -> None:
        if self._owns_bootd:
            await self.bootd.start()
        self.spawn(self._process_peer_updates(), name="ssr.peers")
        self.spawn(self._process_snapshot_ch(), name="ssr.snap")
        self.spawn(self._process_chunk_ch(), name="ssr.chunk")
        self.spawn(self._process_lb_ch(), name="ssr.lb")
        self.spawn(self._process_params_ch(), name="ssr.params")

    async def on_stop(self) -> None:
        if self._owns_bootd:
            await self.bootd.stop()

    def _send(self, ch: Channel, msg, *, to: str = "", broadcast: bool = False) -> None:
        try:
            ch.out_q.put_nowait(Envelope(ch.id, msg, to=to, broadcast=broadcast))
        except asyncio.QueueFull:
            self.logger.warning("statesync outbound full on %s", ch.name)

    # -- peer + serving side --------------------------------------------

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP:
                if upd.node_id not in self.peers:
                    self.peers.append(upd.node_id)
            else:
                if upd.node_id in self.peers:
                    self.peers.remove(upd.node_id)

    async def _process_snapshot_ch(self) -> None:
        async for env in self.snapshot_ch:
            msg = env.message
            if isinstance(msg, m.SnapshotsRequest):
                snapshots = await self.bootd.serve_snapshots()
                for snap in snapshots[-4:]:
                    self._send(
                        self.snapshot_ch,
                        m.SnapshotsResponse(
                            snap.height, snap.format, snap.chunks, snap.hash, snap.metadata
                        ),
                        to=env.from_,
                    )
            elif isinstance(msg, m.SnapshotsResponse):
                key = (msg.height, msg.format, msg.hash, msg.chunks)
                if (
                    key not in self._snapshots
                    and len(self._snapshots) >= MAX_DISCOVERED_SNAPSHOTS
                ):
                    continue  # bounded discovery set; newcomers wait
                snap, providers = self._snapshots.get(key, (msg, set()))
                providers.add(env.from_)
                self._snapshots[key] = (snap, providers)

    async def _process_chunk_ch(self) -> None:
        async for env in self.chunk_ch:
            msg = env.message
            if isinstance(msg, m.ChunkRequest):
                try:
                    chunk = await self.bootd.serve_chunk(
                        msg.height, msg.format, msg.index
                    )
                except BootDBusyError:
                    # shed is backpressure, not failure: the joiner
                    # retries this donor after backoff instead of
                    # marking the chunk missing here
                    self._send(
                        self.chunk_ch,
                        m.ChunkResponse(
                            msg.height, msg.format, msg.index, busy=True
                        ),
                        to=env.from_,
                    )
                    continue
                self._send(
                    self.chunk_ch,
                    m.ChunkResponse(
                        msg.height, msg.format, msg.index, chunk, not chunk
                    ),
                    to=env.from_,
                )
            elif isinstance(msg, m.ChunkResponse):
                fut = self._chunk_futures.get((msg.height, msg.format, msg.index))
                if fut is not None and not fut.done():
                    fut.set_result(msg)

    async def _process_lb_ch(self) -> None:
        async for env in self.lb_ch:
            msg = env.message
            if isinstance(msg, m.LightBlockRequest):
                lb = self._local_light_block(msg.height)
                self._send(self.lb_ch, m.LightBlockResponse(lb), to=env.from_)
            elif isinstance(msg, m.LightBlockResponse):
                self.dispatcher.deliver(msg.light_block)
            elif isinstance(msg, m.LightBlockBatchRequest):
                # serve the window [from_height-count+1, from_height]
                # newest first, stopping at the first height we lack —
                # the joiner needs a hash-linked PREFIX, and a gap would
                # just break its chain check anyway
                lbs: list[LightBlock] = []
                count = min(msg.count, m.MAX_WIRE_BACKFILL_BATCH)
                for h in range(msg.from_height, msg.from_height - count, -1):
                    if h < 1:
                        break
                    lb = self._local_light_block(h)
                    if lb is None:
                        break
                    lbs.append(lb)
                self._send(
                    self.lb_ch,
                    m.LightBlockBatchResponse(tuple(lbs)),
                    to=env.from_,
                )
            elif isinstance(msg, m.LightBlockBatchResponse):
                top = msg.light_blocks[0].height if msg.light_blocks else None
                fut = (
                    self._batch_futures.get(top)
                    if top is not None
                    else next(iter(self._batch_futures.values()), None)
                )
                if fut is not None and not fut.done():
                    fut.set_result(msg.light_blocks)

    def _local_light_block(self, height: int) -> LightBlock | None:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            return None
        return LightBlock(SignedHeader(meta.header, commit), vals)

    async def _process_params_ch(self) -> None:
        async for env in self.params_ch:
            msg = env.message
            if isinstance(msg, m.ParamsRequest):
                params = self.state_store.load_consensus_params(msg.height)
                self._send(
                    self.params_ch, m.ParamsResponse(msg.height, params), to=env.from_
                )
            elif isinstance(msg, m.ParamsResponse):
                fut = self._params_futures.get(msg.height)
                if fut is not None and not fut.done():
                    fut.set_result(msg.params)

    async def _punish_providers(self, peers, reason: str) -> None:
        """Score-hit + quarantine every named peer (poisoned bytes are
        Byzantine, not flaky: `ban=True` escalates the dial cooldown).
        Punished peers are also dropped from every discovered snapshot's
        provider set, so the retry of a candidate (reference syncer
        bans-and-refetches the SAME snapshot) can only use peers that
        have not already served us garbage."""
        self.bootd.stats["poisoned_rejects"] += 1
        punished = set(peers)
        for _snap, provs in self._snapshots.values():
            provs -= punished
        for peer in punished:
            self.logger.warning("penalizing peer %s: %s", peer[:12], reason)
            await self.chunk_ch.error(PeerError(peer, reason, ban=True))

    # -- sync side -------------------------------------------------------

    async def sync(self, config: SyncConfig) -> State:
        """Reference Sync reactor.go:269 + SyncAny syncer.go:167.
        Wrapped in a `boot.sync` flight-recorder span; a completed join
        lands in BootD's time-to-synced histogram."""
        t0 = asyncio.get_running_loop().time()
        with trace.span("boot", "sync", trust_height=config.trust_height) as sp:
            try:
                state = await self._sync(config)
            except BaseException as e:
                sp.set(outcome=type(e).__name__)
                raise
            elapsed = asyncio.get_running_loop().time() - t0
            self.bootd.record_synced(elapsed)
            sp.set(outcome="synced", height=state.last_block_height)
            return state

    async def _sync(self, config: SyncConfig) -> State:
        light = LightClient(
            self.chain_id,
            TrustOptions(config.trust_period_ns, config.trust_height, config.trust_hash),
            self.dispatcher,
            store=TrustedStore(),
            device=self.device,
        )
        # discovery
        deadline = asyncio.get_running_loop().time() + 30
        while not self._snapshots:
            if asyncio.get_running_loop().time() > deadline:
                raise SyncAbortedError("no snapshots discovered")
            self._send(self.snapshot_ch, m.SnapshotsRequest(), broadcast=True)
            await asyncio.sleep(DISCOVERY_TIME)

        # a candidate stays retryable while it has attempts left AND
        # unpunished providers: a poisoned donor costs itself, not the
        # snapshot (reference syncer bans the sender and refetches)
        attempts: dict[tuple, int] = {}
        while True:
            candidates = sorted(
                (
                    k
                    for k, (_s, provs) in self._snapshots.items()
                    if attempts.get(k, 0) < MAX_SNAPSHOT_ATTEMPTS and provs
                ),
                key=lambda k: (-k[0], k[1]),
            )
            if not candidates:
                raise SyncAbortedError("all discovered snapshots failed")
            key = candidates[0]
            snap, providers = self._snapshots[key]
            attempts[key] = attempts.get(key, 0) + 1
            try:
                return await self._restore(snap, list(providers), light, config)
            except (SyncAbortedError, DeviceError):
                raise  # a failed card is not a bad snapshot
            except Exception as e:
                self.logger.info("snapshot %s failed: %r; trying next", key, e)

    async def _restore(
        self,
        snap: m.SnapshotsResponse,
        providers: list[str],
        light: LightClient,
        config: SyncConfig,
    ) -> State:
        h = snap.height
        # verify headers at h, h+1, h+2 (valsets + app hash pins)
        lb_h = await light.verify_light_block_at_height(h)
        lb_h1 = await light.verify_light_block_at_height(h + 1)
        lb_h2 = await light.verify_light_block_at_height(h + 2)
        app_hash = lb_h1.header.app_hash

        # offer to the app (reference offerSnapshot syncer.go:373)
        res = await self.app_conns.snapshot.offer_snapshot(
            abci.RequestOfferSnapshot(
                abci.Snapshot(snap.height, snap.format, snap.chunks, snap.hash, snap.metadata),
                app_hash,
            )
        )
        if res.result == abci.OfferSnapshotResult.ABORT:
            raise SyncAbortedError("app aborted snapshot restore")
        if res.result != abci.OfferSnapshotResult.ACCEPT:
            raise RuntimeError(f"snapshot rejected: {res.result!r}")

        # fetch + apply chunks (reference fetchChunks :470 / applyChunks :409)
        chunks: dict[int, bytes] = {}
        #: chunk index -> the peer whose bytes we kept: a rejected
        #: restore must cost the peers that actually served it
        served_by: dict[int, str] = {}
        sem = asyncio.Semaphore(CHUNK_FETCHERS)

        async def fetch(idx: int) -> None:
            async with sem:
                for attempt, peer in enumerate(providers * 3):
                    br = self._breaker(peer)
                    # `state` is a side-effect-free read; allow() claims the
                    # half-open probe slot, so only consult it for the peer
                    # actually about to be used
                    others_healthy = any(
                        self._breaker(p).state != "open"
                        for p in providers
                        if p != peer
                    )
                    if others_healthy and not br.allow():
                        continue  # skip tripped peers while healthy ones remain
                    fut: asyncio.Future = asyncio.get_running_loop().create_future()
                    self._chunk_futures[(snap.height, snap.format, idx)] = fut
                    self._send(
                        self.chunk_ch,
                        m.ChunkRequest(snap.height, snap.format, idx),
                        to=peer,
                    )
                    try:
                        res = await asyncio.wait_for(fut, CHUNK_TIMEOUT)
                        # any reply is a healthy transport — record success
                        # even for 'missing'/'busy' so a claimed half-open
                        # probe slot is always released
                        br.record_success()
                        if res.busy:
                            # the donor's BootD shed us: backpressure,
                            # not failure — back off and retry (same
                            # donor stays in rotation, breaker untouched)
                            await asyncio.sleep(FETCH_BACKOFF.sleep_for(attempt))
                            continue
                        if not res.missing:
                            chunks[idx] = res.chunk
                            served_by[idx] = peer
                            return
                    except asyncio.TimeoutError:
                        br.record_failure()
                        await asyncio.sleep(FETCH_BACKOFF.sleep_for(attempt))
                        continue
                    finally:
                        self._chunk_futures.pop((snap.height, snap.format, idx), None)
                raise RuntimeError(f"chunk {idx} unavailable")

        await asyncio.gather(*(fetch(i) for i in range(snap.chunks)))
        for idx in range(snap.chunks):
            res = await self.app_conns.snapshot.apply_snapshot_chunk(
                abci.RequestApplySnapshotChunk(idx, chunks[idx])
            )
            if res.result == abci.ApplySnapshotChunkResult.ABORT:
                raise SyncAbortedError("app aborted during chunk apply")
            if res.result not in (
                abci.ApplySnapshotChunkResult.ACCEPT,
                abci.ApplySnapshotChunkResult.RETRY,
            ):
                # poisoned snapshot/chunk: the app's hash check failed.
                # Cost every peer whose bytes we kept a score hit + the
                # dial quarantine, then let sync() move to the next
                # candidate — the joiner never wedges on poison
                await self._punish_providers(
                    served_by.values(),
                    f"poisoned snapshot chunk at height {snap.height}",
                )
                raise RuntimeError(f"chunk {idx} rejected: {res.result!r}")

        # verify the app actually restored the right state (syncer.go:556)
        info = await self.app_conns.query.info(abci.RequestInfo())
        if info.last_block_app_hash != app_hash:
            await self._punish_providers(
                served_by.values(),
                f"restored app hash mismatch at height {snap.height}",
            )
            raise RuntimeError(
                f"restored app hash {info.last_block_app_hash.hex()} != "
                f"verified {app_hash.hex()}"
            )
        if info.last_block_height != h:
            raise RuntimeError(
                f"restored app height {info.last_block_height} != snapshot {h}"
            )

        # consensus params for h+1 (0x63, reference paramsCh)
        params = await self._fetch_params(h + 1, providers)

        # build + persist State (reference stateprovider State())
        state = State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=h,
            last_block_id=lb_h1.header.last_block_id,
            last_block_time_ns=lb_h.header.time_ns,
            validators=lb_h1.validators,
            next_validators=lb_h2.validators,
            last_validators=lb_h.validators,
            last_height_validators_changed=0,
            consensus_params=params,
            last_height_consensus_params_changed=0,
            last_results_hash=lb_h1.header.last_results_hash,
            app_hash=app_hash,
        )
        self.state_store.bootstrap(state)
        self.block_store.bootstrap(h)
        self.block_store.save_signed_header(
            lb_h.header, lb_h.signed_header.commit,
            lb_h.signed_header.commit.block_id,
        )
        self.block_store.save_seen_commit(h, lb_h.signed_header.commit)

        # backfill depth: explicit override, or the evidence window — any
        # evidence younger than BOTH expiry dimensions must stay verifiable
        # (reference reactor.go:348-369 backfills to max-age, not a constant)
        if config.backfill_blocks is not None:
            stop_height = h - config.backfill_blocks
            stop_time_ns = lb_h.header.time_ns  # height-driven only
        else:
            ev = params.evidence
            stop_height = h - ev.max_age_num_blocks
            stop_time_ns = lb_h.header.time_ns - ev.max_age_duration_ns
        await self._backfill(lb_h, stop_height, stop_time_ns)
        self.logger.info("state sync complete at height %d", h)
        return state

    async def _fetch_params(self, height: int, providers: list[str]):
        from ..types.params import ConsensusParams

        for attempt, peer in enumerate(providers * 2):
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._params_futures[height] = fut
            self._send(self.params_ch, m.ParamsRequest(height), to=peer)
            try:
                params = await asyncio.wait_for(fut, 5.0)
                if params is not None:
                    return params
            except asyncio.TimeoutError:
                await asyncio.sleep(FETCH_BACKOFF.sleep_for(attempt))
                continue
            finally:
                self._params_futures.pop(height, None)
        self.logger.warning("no peer served consensus params; using defaults")
        return ConsensusParams()

    async def _fetch_backfill_window(
        self, from_height: int, count: int
    ) -> tuple[tuple[LightBlock, ...], str]:
        """One batched window fetch: (light blocks descending from
        `from_height`, serving peer), round-robining peers with the
        single-height dispatcher as the fallback (a peer that never
        answers the batch frame still serves the old protocol)."""
        peers = list(self.peers)
        for attempt, peer in enumerate(peers * 2):
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._batch_futures[from_height] = fut
            self._send(
                self.lb_ch,
                m.LightBlockBatchRequest(from_height, count),
                to=peer,
            )
            try:
                lbs = await asyncio.wait_for(fut, timeout=5.0)
                if lbs:
                    return lbs, peer
            except asyncio.TimeoutError:
                await asyncio.sleep(FETCH_BACKOFF.sleep_for(attempt))
            finally:
                self._batch_futures.pop(from_height, None)
        # batch path dry: one last chance via the single-height dispatcher
        try:
            lb = await self.dispatcher.light_block(from_height)
            return (lb,), ""
        except LightBlockNotFoundError:
            return (), ""

    async def _backfill(
        self, from_lb: LightBlock, stop_height: int, stop_time_ns: int
    ) -> None:
        """Reverse-fetch recent headers in batched windows, verified by
        hash-chain linkage (reference Backfill reactor.go:348,481-486)
        AND commit signatures: each window is one funnel call on the
        backfill lane (one aggregate pairing per height for BLS
        committees) — a forged-but-linked header can no
        longer enter the store. Fetches until the current header is
        outside BOTH evidence-expiry dimensions (height ≤ stop_height
        and time ≤ stop_time_ns), the chain's base, or history runs out
        on every peer. Nothing from a window is persisted until its
        signatures verify."""
        cur = from_lb
        batch_size = min(self.bootd.backfill_batch, m.MAX_WIRE_BACKFILL_BATCH)
        done = False
        while not done:
            if cur.height <= stop_height and cur.header.time_ns <= stop_time_ns:
                break
            prev_height = cur.height - 1
            if prev_height < max(1, self.initial_height):
                break
            window, served_peer = await self._fetch_backfill_window(
                prev_height, batch_size
            )
            if not window:
                self.logger.warning(
                    "backfill: no peer served light blocks below %d; stopping",
                    cur.height,
                )
                break
            # hash-chain check first (cheap, per link); collect the
            # linked prefix for one batched signature verification
            linked: list[LightBlock] = []
            for prev in window:
                if prev.height != cur.height - 1:
                    break  # gap — the serving peer lacked the rest
                if prev.header.hash() != cur.header.last_block_id.hash:
                    self.logger.warning(
                        "backfill hash chain broken at %d", prev.height
                    )
                    done = True
                    break
                linked.append(prev)
                cur = prev
                if (
                    cur.height <= stop_height
                    and cur.header.time_ns <= stop_time_ns
                ) or cur.height - 1 < max(1, self.initial_height):
                    done = True
                    break
            if not linked:
                break
            try:
                await verify_backfill_batch(
                    self.chain_id, linked, bootd=self.bootd, device=self.device
                )
            except InvalidCommitError as e:
                # a linked header with a forged commit: the batch
                # verification caught what hash-chain linkage alone
                # would have persisted
                self.logger.warning(
                    "backfill: commit verification failed below %d: %s",
                    linked[0].height + 1, e,
                )
                await self._punish_providers(
                    [served_peer] if served_peer else list(self.peers),
                    f"forged backfill commit: {e}",
                )
                break
            for prev in linked:
                self.block_store.save_signed_header(
                    prev.header,
                    prev.signed_header.commit,
                    prev.signed_header.commit.block_id,
                )
                self.state_store.save_validators(prev.height, prev.validators)
        self.logger.info("backfilled headers down to height %d", cur.height)
