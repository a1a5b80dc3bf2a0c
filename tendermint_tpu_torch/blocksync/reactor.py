"""Blocksync reactor (reference internal/blocksync/v0/reactor.go:78,
channel 0x40; the port's copy of tendermint_tpu/blocksync/reactor.py,
with `device=`) — restructured as a device pipeline:

  fetch (network, BlockPool) → sign-bytes construction (host) →
  RANGE-batched commit verification (one verify_commit_range call per
  window: `kernel_eq` on the card from `crypto.batch.MIN_TPU_BATCH`
  signatures, the host below) → ApplyBlock (ABCI)

The reference verifies and applies one block per poolRoutine tick
(reactor.go:439-568); here a contiguous window of up to `window` blocks
is verified in a single batched call, then applied in order. Validator-
set changes inside a window are handled safely: each block's assumed
validator hash is checked just before apply, and a mismatch triggers
individual re-verification with the true set. Every verification runs
on `device` ("cuda" by default, resolved at construction: it raises
without a card unless "cpu" is asked for); the range calls run in a
worker thread (`asyncio.to_thread`), whose kernel launches go to that
thread's current stream. A device error (`crypto.batch.DeviceError`) in
apply is not the provider's fault: it raises out of the reactor's task
instead of becoming a `PeerError` and a redo."""

from __future__ import annotations

import asyncio
import logging

from ..crypto.batch import DeviceError
from ..device import DEFAULT_DEVICE, resolve
from ..libs.clock import SYSTEM, Clock
from ..libs.service import Service
from ..p2p.peermanager import PeerStatus
from ..p2p.router import Channel
from ..p2p.types import Envelope, PeerError
from ..state.execution import BlockExecutor
from ..types.block import BlockID
from ..types.validation import InvalidCommitError, verify_commit_light, verify_commit_range
from . import BLOCKSYNC_CHANNEL
from . import messages as m
from .pool import BlockPool

STATUS_INTERVAL = 2.0
REQUEST_INTERVAL = 0.02
SWITCH_CHECK_INTERVAL = 0.2
DEFAULT_WINDOW = 64


class BlockSyncReactor(Service):
    def __init__(
        self,
        state,
        block_exec: BlockExecutor,
        block_store,
        channel: Channel,
        peer_updates: asyncio.Queue,
        *,
        window: int = DEFAULT_WINDOW,
        active: bool = True,
        clock: Clock | None = None,
        logger: logging.Logger | None = None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__("bs-reactor", logger)
        self.device = resolve(device)
        # duration domain (range-verify latency, pool RTO/ban clocks);
        # injected so chaos clock drift reaches sync bookkeeping too
        self.clock = clock or SYSTEM
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.channel = channel
        self.peer_updates = peer_updates
        self.window = window
        # active=False serves blocks/status to peers but never fetches or
        # applies (a validator started without block-sync must not race
        # live consensus for the same heights)
        self.active = active
        self.pool = BlockPool(state.last_block_height + 1, clock=self.clock)
        self.synced = asyncio.Event()  # set on caught-up (switch to consensus)
        self.metrics = {
            "blocks_applied": 0,
            "sigs_verified": 0,
            "ranges": 0,
            "peer_bans": 0,
        }
        # Commits for heights in [_commit_verified_from, _commit_verified_upto]
        # are signature-proven by a range batch (or the sequential fallback)
        # against the validator set whose hash is recorded alongside; lets
        # apply_block skip the redundant host re-verification of each block's
        # LastCommit. NOTE the lower bound: a range starting at height h
        # proves the commits FOR h..upto (block h+1's LastCommit is the
        # commit for h) — it proves nothing about the commit for h-1, so the
        # first block applied after startup/resume must be full-verified
        # (commit_verified=False). Reset on redo(): a re-fetched block can
        # carry a different commit; reset on resume(): the proof interval is
        # stale after a consensus interlude.
        self._commit_verified_from = None  # no proof interval yet
        self._commit_verified_upto = 0
        self._commit_verified_vals = b""
        #: the DeviceError that ended the sync routine, if one did
        self.device_error: DeviceError | None = None

    async def on_start(self) -> None:
        self.spawn(self._process_peer_updates(), name="bsr.peers")
        self.spawn(self._process_inbound(), name="bsr.in")
        self.spawn(self._status_routine(), name="bsr.status")
        if self.active:
            self.spawn(self._request_routine(), name="bsr.req")
            self.spawn(self._sync_routine(), name="bsr.sync")
        else:
            self.synced.set()

    def resume(self, state) -> None:
        """Re-activate the fetch/verify/apply pipeline after consensus
        fell too far behind (the reference 0.37 'switch back to
        block-sync'). Caller must have paused consensus first."""
        self.state = state
        self.pool.height = state.last_block_height + 1
        self.pool.blocks = {
            h: b for h, b in self.pool.blocks.items() if h > state.last_block_height
        }
        self._commit_verified_from = None
        self._commit_verified_upto = 0
        self._commit_verified_vals = b""
        self.synced = asyncio.Event()
        self.spawn(self._request_routine(), name="bsr.req")
        self.spawn(self._sync_routine(), name="bsr.sync")

    # -- peers -----------------------------------------------------------

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP:
                self._send(m.StatusRequest(), to=upd.node_id)
                # advertise our own range so the peer can sync from us
                self._send(
                    m.StatusResponse(self.block_store.height(), self.block_store.base()),
                    to=upd.node_id,
                )
            else:
                self.pool.remove_peer(upd.node_id)

    def _send(self, msg, *, to: str = "", broadcast: bool = False) -> None:
        try:
            self.channel.out_q.put_nowait(
                Envelope(BLOCKSYNC_CHANNEL, msg, to=to, broadcast=broadcast)
            )
        except asyncio.QueueFull:
            self.logger.warning("blocksync outbound queue full")

    # -- inbound ---------------------------------------------------------

    async def _process_inbound(self) -> None:
        async for env in self.channel:
            msg = env.message
            if isinstance(msg, m.StatusRequest):
                self._send(
                    m.StatusResponse(self.block_store.height(), self.block_store.base()),
                    to=env.from_,
                )
            elif isinstance(msg, m.StatusResponse):
                self.pool.set_peer_range(env.from_, msg.base, msg.height)
            elif isinstance(msg, m.BlockRequest):
                block = self.block_store.load_block(msg.height)
                if block is not None:
                    self._send(m.BlockResponse(block), to=env.from_)
                else:
                    self._send(m.NoBlockResponse(msg.height), to=env.from_)
            elif isinstance(msg, m.BlockResponse):
                self.pool.add_block(env.from_, msg.block)
            elif isinstance(msg, m.NoBlockResponse):
                self.pool.no_block(env.from_, msg.height)

    # -- outbound request/status loops ----------------------------------

    async def _request_routine(self) -> None:
        while not self.synced.is_set():
            for height, peer_id in self.pool.next_requests():
                self._send(m.BlockRequest(height), to=peer_id)
            # peers the pool banned for repeated consecutive timeouts are
            # evicted for real (fatal PeerError -> router disconnect) AND
            # promoted into the peer manager's dial quarantine (ban=True:
            # escalating cooldown, no redial) — the pool-local timed ban
            # alone let a bad peer bounce back every BAN_COOLDOWN
            for pid in self.pool.take_banned():
                self.metrics["peer_bans"] += 1
                await self.channel.error(
                    PeerError(pid, "blocksync: repeated request timeouts", ban=True)
                )
            await asyncio.sleep(REQUEST_INTERVAL)

    async def _status_routine(self) -> None:
        while True:
            self._send(m.StatusRequest(), broadcast=True)
            await asyncio.sleep(STATUS_INTERVAL)

    # -- the pipeline ----------------------------------------------------

    async def _sync_routine(self) -> None:
        """fetch → verify (range-batched) → apply (reference poolRoutine
        reactor.go:439, restructured)."""
        while not self.synced.is_set():
            run = self.pool.peek_range(self.window + 1)
            if len(run) < 2:
                if self.pool.is_caught_up():
                    # hand over to consensus (reference SwitchToConsensus);
                    # we keep serving BlockRequests/status to other peers
                    self.synced.set()
                    return
                await asyncio.sleep(SWITCH_CHECK_INTERVAL)
                continue
            try:
                await self._verify_and_apply(run)
            except DeviceError as e:
                self.device_error = e  # Node.wait_for_height re-raises it
                raise

    async def _verify_and_apply(self, run) -> None:
        """Verify blocks run[0..-2] using each successor's LastCommit in
        ONE batched call, then apply them in order."""
        chain_id = self.state.chain_id
        # Stage 1 (host): build verification entries. Block i is verified
        # by run[i+1].last_commit against the CURRENT validator set —
        # valid while the set doesn't change mid-range; the apply loop
        # re-checks per block and re-verifies individually on rotation.
        entries = []
        parts_list = []
        assumed_vals = self.state.validators
        for i in range(len(run) - 1):
            block, _provider = run[i]
            next_block, _ = run[i + 1]
            parts = block.make_part_set()
            parts_list.append(parts)
            block_id = BlockID(block.hash(), parts.header)
            entries.append((assumed_vals, block_id, block.header.height, next_block.last_commit))
        first_height = run[0][0].header.height

        # Stage 2 (device): one batched verification for the whole range
        try:
            n_sigs = sum(
                sum(1 for s in e[3].signatures if s.is_commit()) for e in entries
            )
            t0 = self.clock.monotonic()
            await asyncio.to_thread(
                verify_commit_range, chain_id, entries, device=self.device, lane="backfill"
            )
            dt = self.clock.monotonic() - t0
            self.metrics["ranges"] += 1
            self.metrics["sigs_verified"] += n_sigs
            # the batch proved the commits FOR first_height..first+len-1
            # (each block's successor LastCommit), all against assumed_vals
            self._record_commit_proof(
                first_height, first_height + len(entries) - 1, assumed_vals.hash()
            )
            self.logger.debug(
                "verified range h=%d..%d (%d sigs) in %.1fms",
                first_height,
                first_height + len(entries) - 1,
                n_sigs,
                dt * 1e3,
            )
        except InvalidCommitError as e:
            # NOT necessarily byzantine: the whole range was verified
            # against today's validator set, so a legitimate mid-range
            # validator rotation also lands here. Re-process the run
            # sequentially against the true (evolving) state; only a
            # block that fails against its CORRECT set evicts peers.
            self.logger.debug(
                "range verify failed at h=%d (%s); falling back to sequential",
                first_height + getattr(e, "failed_index", 0),
                e,
            )
            await self._apply_sequential(run, parts_list)
            return

        # Stage 3: apply in order (ABCI)
        for i in range(len(run) - 1):
            block, provider = run[i]
            height = block.header.height
            parts = parts_list[i]
            block_id = BlockID(block.hash(), parts.header)
            next_block, next_provider = run[i + 1]
            # validator rotation guard: if the set changed mid-range, the
            # batch's assumption is stale from here on — re-verify this
            # block against the true set before applying
            if self.state.validators.hash() != assumed_vals.hash():
                try:
                    await asyncio.to_thread(
                        verify_commit_light,
                        chain_id,
                        self.state.validators,
                        block_id,
                        height,
                        next_block.last_commit,
                        device=self.device,
                        lane="backfill",
                    )
                except InvalidCommitError as e:
                    await self._punish(height, provider, next_provider, e)
                    return
                # record the re-proof so the NEXT block's apply doesn't
                # redo this commit on the host (same bookkeeping as the
                # sequential fallback)
                self._record_commit_proof(
                    height, height, self.state.validators.hash()
                )
            if not await self._apply_one(block, block_id, parts, next_block, provider):
                return
        return

    async def _apply_sequential(self, run, parts_list) -> None:
        """Per-block verify (against the true evolving validator set) +
        apply — the fallback when a range batch fails, and the semantic
        twin of the reference's one-at-a-time poolRoutine."""
        chain_id = self.state.chain_id
        for i in range(len(run) - 1):
            block, provider = run[i]
            height = block.header.height
            if height < self.pool.height:
                continue  # already applied
            parts = parts_list[i]
            block_id = BlockID(block.hash(), parts.header)
            next_block, next_provider = run[i + 1]
            try:
                await asyncio.to_thread(
                    verify_commit_light,
                    chain_id,
                    self.state.validators,
                    block_id,
                    height,
                    next_block.last_commit,
                    device=self.device,
                    lane="backfill",
                )
            except InvalidCommitError as e:
                await self._punish(height, provider, next_provider, e)
                return
            # commit for `height` proven against the TRUE set for that
            # height (state.validators now == state.last_validators when
            # block height+1 is applied next iteration)
            self._record_commit_proof(height, height, self.state.validators.hash())
            if not await self._apply_one(block, block_id, parts, next_block, provider):
                return

    async def _punish(self, height, provider, next_provider, err) -> None:
        """Bad block/commit confirmed against the correct validator set:
        both the block provider and the commit provider are suspect
        (reference reactor.go:556-568)."""
        self.logger.info(
            "invalid commit at height %d from %s: %s", height, provider[:12], err
        )
        await self.channel.error(PeerError(provider, f"bad block: {err}"))
        if next_provider != provider:
            await self.channel.error(PeerError(next_provider, f"bad commit: {err}"))
        self.pool.redo(height, provider, next_provider)
        self._commit_verified_upto = min(self._commit_verified_upto, height - 1)

    def _record_commit_proof(self, a: int, b: int, vals_hash: bytes) -> None:
        """Merge a freshly proven commit interval [a, b] (commits FOR
        those heights, proven against vals_hash). A proof under a
        different validator-set hash, or one not contiguous with the
        recorded interval, REPLACES it — extending across a gap or a set
        change would claim proofs that were never computed."""
        lo, hi = self._commit_verified_from, self._commit_verified_upto
        if (
            lo is None
            or vals_hash != self._commit_verified_vals
            or hi < lo  # emptied by a redo/punish rollback
            or a > hi + 1  # gap above
            or b < lo - 1  # gap below
        ):
            self._commit_verified_from, self._commit_verified_upto = a, b
            self._commit_verified_vals = vals_hash
        else:
            self._commit_verified_from = min(lo, a)
            self._commit_verified_upto = max(hi, b)

    def _commit_preverified(self, height: int) -> bool:
        """True when block `height`'s LastCommit (the commit for
        height-1) was already signature-proven by a batch/sequential
        verification against exactly the set validate_block will check
        it with (state.last_validators).

        The lower bound matters: the first range proves commits from its
        OWN first height onward, never the commit for first_height-1, so
        the first block applied after startup/resume always takes the
        full apply-time verification path (commit_verified=False)."""
        return (
            self._commit_verified_from is not None
            and self._commit_verified_from <= height - 1 <= self._commit_verified_upto
            and self.state.last_validators.hash() == self._commit_verified_vals
        )

    async def _apply_one(self, block, block_id, parts, next_block, provider) -> bool:
        height = block.header.height
        try:
            if self.block_store.height() < height:
                self.block_store.save_block(block, parts, next_block.last_commit)
            self.state, _ = await self.block_exec.apply_block(
                self.state,
                block_id,
                block,
                commit_verified=self._commit_preverified(height),
            )
            self.metrics["blocks_applied"] += 1
        except DeviceError:
            raise  # the card failed, not the provider: no PeerError
        except Exception as e:
            self.logger.error("apply failed at height %d: %r", height, e)
            await self.channel.error(PeerError(provider, f"apply: {e!r}"))
            self.pool.redo(height, provider)
            self._commit_verified_upto = min(self._commit_verified_upto, height - 1)
            return False
        self.pool.pop(height)
        return True
