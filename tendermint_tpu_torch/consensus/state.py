"""The consensus state machine (reference internal/consensus/state.go:79;
the port's copy of tendermint_tpu/consensus/state.py).

Single-threaded by construction, exactly like the reference's
`receiveRoutine` (state.go:759): ALL state transitions happen on one
asyncio task consuming three inputs — peer messages, internal (self-
originated) messages, and timer ticks. Every input is WAL-written before
it is acted on, so a crash at any point replays deterministically
(`catchup_replay`, reference replay.go:94).

Step functions mirror the reference one-for-one:
  enter_new_round (state.go:1010) → enter_propose (:1092)
  → enter_prevote (:1270) → enter_prevote_wait → enter_precommit (:1366)
  → enter_precommit_wait → enter_commit (:1520) → finalize_commit (:1611)

The Tendermint locking rules live in `_add_vote` (prevote polka ⇒
valid-block update + possible unlock, state.go:2095-2160) and
`enter_precommit` (lock on polka, state.go:1412-1480).

Outbound messages (proposal, block parts, votes) are pushed through
`broadcast_hook`, which the consensus reactor (or an in-process test
network) installs; the SM never talks to the network directly.

The state machine's device is its `BlockExecutor`'s (`self.device`):
`validate_block` checks each proposal's LastCommit there, and a
`ConsensusState` built on a default executor therefore needs a card
unless the executor was given "cpu". Vote and proposal signatures go
through the running VerifyHub (its device) when one is acquired, and
through the host otherwise.

WAL replay drops an input that fails its checks, as the live loop does
(the JAX package's replay raises on it, and the node cannot start).

A device error (`crypto.batch.DeviceError`) is never a verdict here,
unlike any other input failure: the receive loop lets it through where
it drops a failed input, a proposal whose check raised it gets no nil
prevote, and the receive task ends with it (`device_error`), which
`wait_for_height` then re-raises rather than time out.
"""

from __future__ import annotations

import asyncio
import logging
import os
import weakref
from dataclasses import dataclass
from typing import Callable

from ..config import ConsensusConfig
from ..crypto.batch import DeviceError
from ..evidence import EvidencePoolI, NopEvidencePool
from ..libs import trace
from ..libs.clock import SYSTEM, Clock
from ..libs.metrics import Histogram
from ..libs.service import Service
from ..privval import PrivValidator
from ..state.execution import BlockExecutor
from ..state.state import State
from ..state.validation import BlockValidationError
from ..store.blockstore import BlockStore
from ..types.block import Block, BlockID, NIL_BLOCK_ID
from ..types.events import (
    EventBus,
    EventDataCompleteProposal,
    EventDataVote,
)
from ..types.keys import SignedMsgType
from ..types.part_set import Part, PartSet
from ..types.vote import Proposal, Vote
from ..types.vote_set import ConflictingVoteError, VoteSet, VoteSetError
from ..libs import fail
from . import messages as m
from .ingest import IngestPipeline
from .ticker import TimeoutInfo, TimeoutTicker
from .types import HeightVoteSet, RoundState, RoundStep
from .wal import WAL, KIND_END_HEIGHT, KIND_MESSAGE


@dataclass(frozen=True)
class MsgInfo:
    msg: object
    peer_id: str = ""  # "" = internally generated
    # pipelined-ingest verdict (consensus/ingest.py): True = signature
    # proven in stage 1, don't re-check at apply; False = proven bad,
    # drop at apply; None = unknown, apply verifies synchronously
    sig_ok: bool | None = None
    # flight-recorder context (libs/trace.TraceCtx) following this
    # message end-to-end; None when tracing is off or the message is
    # internally generated. NEVER serialized into the WAL.
    trace: object = None


# queue sentinel: mempool signalled txs-available (create_empty_blocks=false)
_TXS_AVAILABLE = object()


class ConsensusError(RuntimeError):
    pass


# -- step-latency metrics ---------------------------------------------------
#
# consensus_step_duration_seconds{step=} + consensus_time_to_commit_seconds:
# round progress used to be invisible outside test asserts. Each running
# ConsensusState keeps its own histograms (multi-node in-process tests run
# several); NodeMetrics folds the registry at render time, mirroring
# consensus/ingest.aggregate.

#: step-duration buckets (seconds): fast_config rounds are tens of ms,
#: production rounds seconds
STEP_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

#: metric label per RoundStep — the wait variants fold into their step
#: (PREVOTE_WAIT is still time spent deciding the prevote outcome)
STEP_LABELS = ("new_height", "new_round", "propose", "prevote", "precommit", "commit")

_STEP_LABEL = {
    RoundStep.NEW_HEIGHT: "new_height",
    RoundStep.NEW_ROUND: "new_round",
    RoundStep.PROPOSE: "propose",
    RoundStep.PREVOTE: "prevote",
    RoundStep.PREVOTE_WAIT: "prevote",
    RoundStep.PRECOMMIT: "precommit",
    RoundStep.PRECOMMIT_WAIT: "precommit",
    RoundStep.COMMIT: "commit",
}

_step_states: "weakref.WeakSet[ConsensusState]" = weakref.WeakSet()


def aggregate_step_metrics():
    """({step label: (counts, sum, count)}, time-to-commit fold) across
    every running ConsensusState, or (None, None) when none is up."""
    states = [s for s in _step_states]
    if not states:
        return None, None

    def fold(hists):
        counts = [0] * (len(STEP_BUCKETS) + 1)
        total_sum, total_count = 0.0, 0
        for h in hists:
            for i, c in enumerate(h._counts):
                counts[i] += c
            total_sum += h._sum
            total_count += h._count
        return counts, total_sum, total_count

    per_step = {
        label: fold([s.step_hist[label] for s in states]) for label in STEP_LABELS
    }
    return per_step, fold([s.ttc_hist for s in states])


class ConsensusState(Service):
    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        *,
        priv_validator: PrivValidator | None = None,
        evidence_pool: EvidencePoolI | None = None,
        wal: WAL | None = None,
        event_bus: EventBus | None = None,
        mempool=None,
        clock: Clock | None = None,
        logger: logging.Logger | None = None,
    ):
        super().__init__("consensus", logger)
        self.config = config
        # injectable time source: every wall-clock reading the SM stamps
        # into protocol output (vote/proposal times, commit_time, the
        # NewHeight schedule) goes through this, so chaos runs can freeze
        # or skew it per validator (libs/clock.py)
        self.clock = clock or SYSTEM
        self.block_exec = block_exec
        self.device = block_exec.device
        self.block_store = block_store
        self.mempool = mempool
        self.priv_validator = priv_validator
        self.evidence_pool = evidence_pool or NopEvidencePool()
        self.wal = wal
        self.event_bus = event_bus

        self.rs = RoundState()
        self.state: State | None = None
        # one-shot log guard for the aggregate-commit fallback path
        self._warned_aggregate_fallback = False

        # one merged input queue for peer msgs and timer ticks — the
        # reference's select{} across three channels is pseudo-random among
        # ready cases, so a single FIFO is an equivalent (and fully
        # cancellable) discipline; internal msgs are handled synchronously
        # in _send_internal
        self.msg_queue: asyncio.Queue[MsgInfo | TimeoutInfo] = asyncio.Queue(
            maxsize=2000
        )
        self.ticker = TimeoutTicker(self.msg_queue, clock=self.clock)

        # reactor hooks: called with consensus Messages to gossip out
        self.broadcast_hook: Callable[[object], None] | None = None
        # step-change hook (reactor broadcasts NewRoundStep from it)
        self.step_hook: Callable[[RoundState], None] | None = None
        # called (peer_id, vote) when the pipeline proved a peer-supplied
        # signature bad — the reactor turns it into a PeerError
        self.invalid_sig_hook: Callable[[str, Vote], None] | None = None

        # two-stage pipelined ingest (consensus/ingest.py): stage 1
        # verifies signatures concurrently through the async hub API,
        # stage 2 applies in strict arrival order. Env wins over config
        # (same contract as the TMTPU_VERIFYHUB_* knobs).
        pipe_on = config.ingest_pipeline
        env = os.environ.get("TMTPU_INGEST_PIPELINE")
        if env:
            pipe_on = env.lower() not in ("0", "false", "no")
        inflight = config.ingest_max_inflight
        env = os.environ.get("TMTPU_INGEST_INFLIGHT")
        if env:
            inflight = int(env)
        self.ingest: IngestPipeline | None = None
        if pipe_on:
            self.ingest = IngestPipeline(
                self,
                max_inflight=inflight,
                logger=self.logger.getChild("ingest"),
            )

        self._replay_mode = False
        self._paused = False  # switch-back-to-blocksync gate
        self._n_started_height = 0
        self._wake = asyncio.Event()  # new-height nudge for tests
        self._decided: asyncio.Event = asyncio.Event()
        #: the DeviceError that ended the receive task, if one did
        self.device_error: DeviceError | None = None
        self._sign_jobs: list[tuple] = []  # deferred privval signing

        # step-latency instrumentation (folded into /metrics via
        # aggregate_step_metrics; durations on the injected clock's
        # monotonic domain so chaos runs stay deterministic)
        self.step_hist = {
            label: Histogram(
                f"consensus_step_duration_seconds_{label}",
                "time spent in this consensus step",
                buckets=STEP_BUCKETS,
            )
            for label in STEP_LABELS
        }
        self.ttc_hist = Histogram(
            "consensus_time_to_commit_seconds",
            "height start to committed block",
            buckets=STEP_BUCKETS,
        )
        self._step_entered: tuple | None = None  # (RoundStep, entered_at)
        self._height_t0 = self.clock.monotonic()

        self.update_to_state(state)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def on_start(self) -> None:
        _step_states.add(self)
        if self.wal is not None:
            self.catchup_replay()
        if self.ingest is not None:
            self.ingest.start()
        self.spawn(self._receive_routine(), name="cs.receive")
        if not self.config.create_empty_blocks and self.mempool is not None:
            # reference receiveRoutine's txsAvailable case (state.go:770):
            # with create_empty_blocks=false the proposer blocks in
            # NEW_ROUND until the mempool signals txs — without this
            # consumer the chain stalls permanently at the first empty
            # height when the interval is 0
            self.spawn(self._txs_available_routine(), name="cs.txs_available")
        # kick off the first height
        self._schedule_timeout(
            self.config.timeout_commit_ns, self.rs.height, 0, RoundStep.NEW_HEIGHT
        )

    async def on_stop(self) -> None:
        _step_states.discard(self)  # stop folding into /metrics
        self.ticker.stop()
        if self.ingest is not None:
            self.ingest.stop()
        if self.wal is not None:
            self.wal.close()

    # ------------------------------------------------------------------
    # public input
    # ------------------------------------------------------------------

    async def add_proposal(
        self, proposal: Proposal, peer_id: str = "", trace_ctx=None
    ) -> None:
        await self._ingest_put(
            MsgInfo(m.ProposalMessage(proposal), peer_id, trace=trace_ctx)
        )

    async def add_block_part(
        self, height: int, round_: int, part: Part, peer_id: str = "",
        trace_ctx=None,
    ) -> None:
        await self._ingest_put(
            MsgInfo(m.BlockPartMessage(height, round_, part), peer_id, trace=trace_ctx)
        )

    async def add_vote(self, vote: Vote, peer_id: str = "", trace_ctx=None) -> None:
        await self._ingest_put(
            MsgInfo(m.VoteMessage(vote), peer_id, trace=trace_ctx)
        )

    async def _ingest_put(self, mi: MsgInfo) -> None:
        """Peer inputs enter through the pipelined ingest when it is
        running (stage-1 concurrent verify, in-order release); otherwise
        — pipeline disabled, or the SM not yet started — straight onto
        the input queue, the sequential facade."""
        if self.ingest is not None and self.ingest.started and not self._stopping:
            await self.ingest.submit(mi)
        else:
            await self.msg_queue.put(mi)

    def get_round_state(self) -> RoundState:
        return self.rs

    # ------------------------------------------------------------------
    # state setup
    # ------------------------------------------------------------------

    def update_to_state(self, state: State) -> None:
        """Prepare the round state for height state.last_block_height+1
        (reference updateToState state.go:xxx after finalize)."""
        if (
            self.rs.commit_round > -1
            and 0 < self.rs.height <= state.last_block_height
        ):
            # finished a height; sanity check
            if self.rs.height != state.last_block_height:
                raise ConsensusError(
                    f"updateToState expected height {self.rs.height}, "
                    f"state at {state.last_block_height}"
                )
        height = state.last_block_height + 1
        if height == 1:
            last_precommits = None
        else:
            if self.rs.commit_round > -1 and self.rs.votes is not None:
                last_precommits = self.rs.votes.precommits(self.rs.commit_round)
                if last_precommits is None or not last_precommits.has_two_thirds_majority():
                    raise ConsensusError("commit round has no +2/3 precommits")
            else:
                last_precommits = self.rs.last_commit  # restart path
        validators = state.validators.copy()

        rs = self.rs
        rs.height = height
        rs.round = 0
        rs.step = RoundStep.NEW_HEIGHT
        if rs.commit_time_ns == 0:
            rs.start_time_ns = self.config.commit_time_ns(self.clock.now_ns())
        else:
            rs.start_time_ns = self.config.commit_time_ns(rs.commit_time_ns)
        rs.validators = validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, validators)
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators.copy() if state.last_validators else None
        rs.triggered_timeout_precommit = False
        self.state = state
        self._height_t0 = self.clock.monotonic()  # time-to-commit anchor
        self._new_step()

    def _new_step(self) -> None:
        # step-duration accounting: observe the step being LEFT (wait
        # variants fold into their parent step's label)
        now = self.clock.monotonic()
        prev = self._step_entered
        self._step_entered = (self.rs.step, now)
        if prev is not None and prev[0] != self.rs.step and not self._replay_mode:
            label = _STEP_LABEL.get(prev[0])
            if label is not None:
                self.step_hist[label].observe(max(0.0, now - prev[1]))
        if self.step_hook is not None:
            self.step_hook(self.rs)
        if self.event_bus is not None:
            self.event_bus.publish_new_round_step(self.rs.round_state_event())

    # ------------------------------------------------------------------
    # WAL replay
    # ------------------------------------------------------------------

    def catchup_replay(self) -> None:
        """Replay WAL messages for the in-progress height (reference
        replay.go:94 catchupReplay)."""
        cs_height = self.rs.height
        recs = self.wal.search_for_end_height(cs_height - 1)
        if recs is None:
            # Distinguish "WAL simply ends before that height" (fine: the
            # node advanced via block-sync/state-sync, nothing to replay —
            # the reference's io.EOF case) from "WAL reaches beyond it but
            # the marker is missing" (corruption / double-sign hazard).
            max_marker = -1
            for rec in self.wal.iter_records():
                if rec.kind == KIND_END_HEIGHT:
                    max_marker = max(max_marker, rec.height)
            if max_marker > cs_height - 1:
                raise ConsensusError(
                    f"WAL contains end-height {max_marker} beyond expected "
                    f"{cs_height - 1}; refusing to start (double-sign hazard)"
                )
            if cs_height == self.state.initial_height or max_marker < cs_height - 1:
                self.logger.info(
                    "WAL ends before height %d; skipping replay", cs_height - 1
                )
                recs = []
        self._replay_mode = True
        try:
            for rec in recs:
                if rec.kind != KIND_MESSAGE:
                    continue
                msg, peer = m.decode_wal_message(rec.data)
                if isinstance(msg, TimeoutInfo):
                    self._handle_timeout(msg)
                    continue
                try:
                    self._handle_msg(MsgInfo(msg, peer or ""))
                except (ConflictingVoteError, ValueError) as e:
                    # the WAL logs a peer's input before it is checked, so an
                    # input the live loop dropped (a vote whose signature a
                    # corrupted frame broke) is dropped again, as the
                    # reference's Go replay does; the JAX package raises here
                    self.logger.info("replay: dropped invalid WAL input: %r", e)
        finally:
            self._replay_mode = False
        self.logger.info("WAL replay done at height %d", cs_height)

    # ------------------------------------------------------------------
    # the single-threaded event loop
    # ------------------------------------------------------------------

    def pause(self) -> None:
        """Freeze the state machine while block-sync re-takes over (the
        node fell too far behind for vote gossip to catch up). Inputs are
        dropped; timers are ignored."""
        self._paused = True
        self._finalize_pending = False
        self._sign_jobs.clear()
        self.ticker.stop()

    def resume_with_state(self, state: State) -> None:
        """Resume after a re-sync at the new tip. Must be called from the
        same event loop (the SM is single-task; this mutation is atomic
        under cooperative scheduling)."""
        self.rs.commit_round = -1
        self.rs.last_commit = None
        self.rs.commit_time_ns = 0
        self.update_to_state(state)
        self._paused = False
        self._schedule_timeout(
            self.config.timeout_commit_ns, self.rs.height, 0, RoundStep.NEW_HEIGHT
        )

    # messages drained per receive wakeup: under a saturated event loop
    # (150-validator in-process nets) a task gets roughly one wakeup per
    # loop cycle, so one-message-per-wakeup caps the SM at the loop's
    # cycle rate regardless of how cheap an apply is — a catching-up
    # node with a 10k-vote backlog would take minutes to drain it.
    # Draining a bounded burst per wakeup amortizes the wakeup; order is
    # untouched (same single consumer, same queue order).
    RECV_BURST = 64

    async def _receive_routine(self) -> None:
        try:
            while True:
                item = await self.msg_queue.get()
                await self._process_input(item)
                for _ in range(self.RECV_BURST - 1):
                    try:
                        item = self.msg_queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    await self._process_input(item)
        except DeviceError as e:
            # the card failed: the machine stops here, loudly, and
            # wait_for_height re-raises it (module docstring)
            self.device_error = e
            self._decided.set()
            raise

    async def _process_input(self, item) -> None:
        if self._paused:
            return
        # WAL-first, OUTSIDE the survive-the-message guard below: a node
        # that cannot persist its inputs must fail-stop (the WAL crash
        # model depends on every acted-on input being on disk), so a
        # write/fsync error here still kills the receive loop. Peer
        # msgs are buffered writes (group flush); internal msgs are
        # WAL-synced in _send_internal (reference state.go:782-806).
        if isinstance(item, TimeoutInfo):
            self._wal_write(m.encode_wal_message(item), sync=True)
        elif item is not _TXS_AVAILABLE:
            self._wal_write(
                m.encode_wal_message(item.msg, item.peer_id), sync=False
            )
        try:
            if item is _TXS_AVAILABLE:
                self._handle_txs_available()
            elif isinstance(item, TimeoutInfo):
                self._handle_timeout(item)
            else:
                ctx = item.trace
                if ctx is None:
                    self._handle_msg(item)
                else:
                    # apply span starts at the reorder release so the
                    # four ingest stages tile the end-to-end span:
                    # wait + verify + reorder + apply == msg, exactly
                    t_apply = ctx.marks.get("release", self.clock.monotonic())
                    try:
                        self._handle_msg(item)
                    finally:
                        t_done = self.clock.monotonic()
                        kind = type(item.msg).__name__
                        trace.record(
                            ctx, "consensus", "apply", t_apply, t_done, msg=kind
                        )
                        trace.record(
                            ctx, "consensus", "msg",
                            ctx.marks.get("submit", ctx.t0), t_done,
                            msg=kind, peer=item.peer_id, sig_ok=item.sig_ok,
                        )
        except ConflictingVoteError as e:
            self.evidence_pool.report_conflicting_votes(e.existing, e.new)
            self.logger.info(
                "found conflicting vote, sent to evidence pool: %s", e.new
            )
        except DeviceError:
            raise  # never a dropped input: it ends the receive task
        except (VoteSetError, BlockValidationError, ValueError) as e:
            self.logger.info("dropped invalid consensus input: %r", e)
        except Exception:  # noqa: BLE001 — the ONE receive task
            # Any other exception here kills the single receive task
            # and silently freezes the node: ingest permits drain,
            # msg_queue fills, and the only symptom is a validator
            # that stops voting (the router-chaos matrix caught
            # exactly this as 150-validator stragglers frozen behind
            # a dead SM). An unexpected input failure is loud but
            # survivable — fail the MESSAGE, never the machine.
            self.logger.error(
                "consensus input failed at h=%d r=%d (dropped): %s",
                self.rs.height,
                self.rs.round,
                type(item).__name__,
                exc_info=True,
            )
        # run async follow-ups scheduled by handlers (off-loop privval
        # signing, then finalize) until quiescent — a signed own-vote
        # can trigger transitions that queue more signing; a failure
        # here must not kill the receive loop
        try:
            while (self._sign_jobs or self._finalize_pending) and (
                not self._paused
            ):
                await self._drain_signing()
                await self._drain_finalize()
        except DeviceError:
            raise
        except Exception as e:
            self.logger.error(
                "finalize failed at height %d: %r", self.rs.height, e
            )

    def _wal_write(self, payload: bytes, *, sync: bool) -> None:
        if self.wal is None or self._replay_mode:
            return
        if sync:
            self.wal.write_sync(payload)
        else:
            self.wal.write(payload)

    _finalize_pending: bool = False

    async def _drain_finalize(self) -> None:
        while self._finalize_pending:
            self._finalize_pending = False
            await self._finalize_commit()

    def _queue_signing(self, sign_fn, on_signed, what: str) -> None:
        """Defer a privval signing call: the blocking I/O (remote signer
        socket + retry backoff, FilePV fsync) runs in a worker thread and
        only the consensus task waits on it — like the reference, where
        SignVote blocks receiveRoutine but no other goroutine."""
        self._sign_jobs.append((sign_fn, on_signed, what))

    async def _drain_signing(self) -> None:
        while self._sign_jobs and not self._paused:
            sign_fn, on_signed, what = self._sign_jobs.pop(0)
            try:
                signed = await asyncio.to_thread(sign_fn)
            except Exception as e:
                self.logger.error("failed signing %s: %r", what, e)
                continue
            if self._paused:
                # pause() landed while the sign was in flight: block-sync
                # owns block application now — drop the result
                return
            on_signed(signed)

    # ------------------------------------------------------------------
    # message dispatch (sync — mutations happen inline; the only async
    # part, ApplyBlock, is deferred via _finalize_pending)
    # ------------------------------------------------------------------

    def _handle_msg(self, mi: MsgInfo) -> None:
        msg = mi.msg
        if isinstance(msg, m.ProposalMessage):
            self._set_proposal(msg.proposal, sig_ok=mi.sig_ok)
        elif isinstance(msg, m.BlockPartMessage):
            self._add_proposal_block_part(msg, mi.peer_id)
        elif isinstance(msg, m.VoteMessage):
            self._try_add_vote(msg.vote, mi.peer_id, sig_ok=mi.sig_ok)
        else:
            self.logger.debug("ignoring message %s", type(msg).__name__)

    async def _txs_available_routine(self) -> None:
        """Bridge the mempool's txs-available signal into the state
        machine's input queue (reference state.go:770 txsAvailable case).
        Fires at most once per height: `notified_txs_available` is the
        latch, reset by mempool.update() after each commit."""
        while True:
            await self.mempool.wait_for_txs()
            if self.mempool.notified_txs_available:
                # already fired for this height; txs still resident —
                # sleep until the post-commit reset pulse
                await self.mempool.wait_notified_reset()
                continue
            if self.mempool.size() == 0:
                # raced a commit: between the txs-available wakeup and
                # this resumption, mempool.update() drained the pool and
                # reset the latch — firing now would propose an empty
                # block despite create_empty_blocks=false
                continue
            self.mempool.notified_txs_available = True
            await self.msg_queue.put(_TXS_AVAILABLE)

    def _need_proof_block(self, height: int) -> bool:
        """Reference needProofBlock state.go:1048: the app hash produced by
        executing height-1 only becomes part of a header at `height` — if
        it changed, that block must be proposed even with an empty mempool,
        or the new app state is never committed to any header."""
        if self.state is None or height == self.state.initial_height:
            return True
        meta_header = self.block_store.load_block(height - 1)
        if meta_header is None:
            return False
        return self.state.app_hash != meta_header.header.app_hash

    def _handle_txs_available(self) -> None:
        """Reference handleTxsAvailable state.go:919: with
        create_empty_blocks=false the proposer idles in NEW_HEIGHT /
        NEW_ROUND until the mempool has work; this kicks it forward."""
        rs = self.rs
        if self.config.create_empty_blocks:
            return
        if rs.step == RoundStep.NEW_HEIGHT:
            # commit timeout still pending — arm a NEW_ROUND step timeout
            # for its REMAINING time (state.go:927), so the block lands at
            # the configured inter-block cadence, not tx-arrival + full
            # commit timeout
            self._schedule_timeout(
                max(0, rs.start_time_ns - self.clock.now_ns()),
                rs.height,
                0,
                RoundStep.NEW_ROUND,
            )
        elif rs.step == RoundStep.NEW_ROUND:
            self._enter_propose(rs.height, 0)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """Reference handleTimeout state.go:907."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < rs.step
        ):
            return
        if ti.step == RoundStep.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == RoundStep.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == RoundStep.PROPOSE:
            if self.event_bus is not None:
                self.event_bus.publish_timeout_propose(rs.round_state_event())
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == RoundStep.PREVOTE_WAIT:
            if self.event_bus is not None:
                self.event_bus.publish_timeout_wait(rs.round_state_event())
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == RoundStep.PRECOMMIT_WAIT:
            if self.event_bus is not None:
                self.event_bus.publish_timeout_wait(rs.round_state_event())
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise ConsensusError(f"invalid timeout step {ti.step}")

    def _schedule_timeout(
        self, duration_ns: int, height: int, round_: int, step: RoundStep
    ) -> None:
        # note: scheduling stays live during WAL replay (like the
        # reference's catchupReplay driving the real timeoutTicker) so a
        # node restarted mid-round has its step timeout armed
        self.ticker.schedule(TimeoutInfo(duration_ns, height, round_, step))

    def _broadcast(self, msg) -> None:
        if self.broadcast_hook is not None and not self._replay_mode:
            self.broadcast_hook(msg)

    def _send_internal(self, mi: MsgInfo) -> None:
        """Internal messages loop straight back into the queue (reference
        sendInternalMessage state.go) — but since we are single-threaded
        we can handle them synchronously for determinism."""
        self._wal_write(m.encode_wal_message(mi.msg, mi.peer_id), sync=True)
        try:
            self._handle_msg(mi)
        except ConflictingVoteError as e:
            self.evidence_pool.report_conflicting_votes(e.existing, e.new)

    # ------------------------------------------------------------------
    # step: NewRound
    # ------------------------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        """Reference enterNewRound state.go:1010."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            return
        self.logger.debug("enterNewRound %d/%d", height, round_)

        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy_increment_proposer_priority(
                round_ - rs.round
            )
            rs.validators = validators
        rs.round = round_
        rs.step = RoundStep.NEW_ROUND
        if round_ != 0:
            # round 0 keeps the proposal from NewHeight setup; later rounds
            # start fresh (but keep the proposal *block* if it repropagates)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.triggered_timeout_precommit = False
        rs.votes.set_round(round_ + 1)
        if self.event_bus is not None:
            self.event_bus.publish_new_round(rs.round_state_event())
        self._new_step()

        wait_for_txs = (
            not self.config.create_empty_blocks
            and round_ == 0
            and not self._need_proof_block(height)
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval_ns > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval_ns,
                    height,
                    round_,
                    RoundStep.NEW_ROUND,
                )
        else:
            self._enter_propose(height, round_)

    # ------------------------------------------------------------------
    # step: Propose
    # ------------------------------------------------------------------

    def _enter_propose(self, height: int, round_: int) -> None:
        """Reference enterPropose state.go:1092."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        self.logger.debug("enterPropose %d/%d", height, round_)
        rs.round = round_
        rs.step = RoundStep.PROPOSE
        self._new_step()

        self._schedule_timeout(
            self.config.propose_timeout_ns(round_), height, round_, RoundStep.PROPOSE
        )
        if self._is_proposal_complete():
            self._enter_prevote(height, round_)
        if self._is_proposer():
            self._decide_proposal(height, round_)

    def _is_proposer(self) -> bool:
        if self.priv_validator is None:
            return False
        addr = self.priv_validator.get_pub_key().address()
        return self.rs.validators.get_proposer().address == addr

    def _is_proposal_complete(self) -> bool:
        """Reference isProposalComplete state.go:1216: need the proposal +
        full block; if POL round set, also need that round's polka."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    def _decide_proposal(self, height: int, round_: int) -> None:
        """Reference defaultDecideProposal state.go:1163."""
        if self._replay_mode:
            return  # our own proposal is in the WAL; don't re-sign
        rs = self.rs
        if rs.locked_block is not None:
            block, parts = rs.locked_block, rs.locked_block_parts
        elif rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            proposer_addr = self.priv_validator.get_pub_key().address()
            last_commit = None
            if height > self.state.initial_height:
                last_commit = self.block_store.load_seen_commit(height - 1)
                if last_commit is None and rs.last_commit is not None:
                    last_commit = self._materialize_commit(rs.last_commit)
            try:
                block, parts = self.block_exec.create_proposal_block(
                    height, self.state, last_commit, proposer_addr
                )
            except Exception as e:
                self.logger.error("failed to create proposal block: %r", e)
                return

        block_id = BlockID(block.hash(), parts.header)
        proposal = Proposal(height, round_, rs.valid_round, block_id, self.clock.now_ns())

        def on_signed(signed: Proposal) -> None:
            self._send_internal(MsgInfo(m.ProposalMessage(signed)))
            self._broadcast(m.ProposalMessage(signed))
            for i in range(parts.header.total):
                part = parts.get_part(i)
                self._send_internal(MsgInfo(m.BlockPartMessage(height, round_, part)))
                self._broadcast(m.BlockPartMessage(height, round_, part))
            self.logger.info(
                "proposed block %d/%d %s", height, round_, block_id.hash.hex()[:12]
            )

        # signing may hit a remote signer (socket I/O + retry backoff) —
        # run it off-loop; the receive routine awaits the job before
        # taking the next input, so SM ordering is unchanged (the
        # reference's receiveRoutine blocks on SignProposal the same way)
        self._queue_signing(
            lambda: self.priv_validator.sign_proposal(self.state.chain_id, proposal),
            on_signed,
            "proposal",
        )

    # ------------------------------------------------------------------
    # proposal intake
    # ------------------------------------------------------------------

    def _set_proposal(self, proposal: Proposal, sig_ok: bool | None = None) -> None:
        """Reference defaultSetProposal state.go:1821."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        proposal.validate_basic()
        if not (-1 <= proposal.pol_round < proposal.round):
            raise ValueError("invalid proposal POL round")
        # verify proposer signature (state.go:1847). The pipelined
        # ingest usually proved (or disproved) it in stage 1 — sig_ok
        # is only trusted because the (height, round) equality above
        # pins the same proposer the pipeline verified against. The
        # sync fallback routes through the VerifyHub: the same proposal
        # gossiped by several peers is answered from the verdict cache
        # instead of re-verified per peer.
        if sig_ok is False:
            raise ValueError("invalid proposal signature")
        if sig_ok is not True:
            from ..crypto.verify_hub import verify_one

            proposer = rs.validators.get_proposer()
            sb = proposal.sign_bytes(self.state.chain_id)
            if not verify_one(proposer.pub_key, sb, proposal.signature):
                raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header
            )
        self.logger.debug("received proposal %d/%d", proposal.height, proposal.round)

    def _add_proposal_block_part(self, msg: m.BlockPartMessage, peer_id: str) -> bool:
        """Reference addProposalBlockPart state.go:1863."""
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if not added:
            return False
        if rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            block = Block.decode(data)
            # integrity: the completed block must hash to the proposal's
            # block id — but only when this part set IS the proposal's.
            # After enterCommit re-arms the part set for a DECIDED block
            # (catch-up: +2/3 precommits for a round whose proposal we
            # missed), rs.proposal may still hold a later round's
            # proposal for a different block; comparing against it wedged
            # the height forever (the part set completes exactly once).
            if (
                rs.proposal is not None
                and rs.proposal.block_id.part_set_header
                == rs.proposal_block_parts.header
                and block.hash() != rs.proposal.block_id.hash
            ):
                raise ValueError("completed proposal block hash mismatch")
            rs.proposal_block = block
            self.logger.info(
                "received complete proposal block %d %s",
                block.header.height,
                block.hash().hex()[:12],
            )
            if self.event_bus is not None:
                self.event_bus.publish_complete_proposal(
                    EventDataCompleteProposal(
                        rs.height,
                        rs.round,
                        rs.step.name,
                        BlockID(block.hash(), rs.proposal_block_parts.header),
                    )
                )
            # update valid block if a polka already exists for it
            prevotes = rs.votes.prevotes(rs.round)
            maj = prevotes.two_thirds_majority() if prevotes else None
            if (
                maj is not None
                and not maj.is_nil()
                and rs.valid_round < rs.round
                and maj.hash == block.hash()
            ):
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
            if rs.step <= RoundStep.PROPOSE and self._is_proposal_complete():
                self._enter_prevote(rs.height, rs.round)
            elif rs.step == RoundStep.COMMIT:
                self._finalize_later()
        return True

    # ------------------------------------------------------------------
    # step: Prevote
    # ------------------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        """Reference enterPrevote state.go:1270."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        self.logger.debug("enterPrevote %d/%d", height, round_)
        rs.round = round_
        rs.step = RoundStep.PREVOTE
        self._new_step()
        self._do_prevote(height, round_)

    def _do_prevote(self, height: int, round_: int) -> None:
        """Reference defaultDoPrevote state.go:1299."""
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(
                SignedMsgType.PREVOTE,
                BlockID(rs.locked_block.hash(), rs.locked_block_parts.header),
            )
            return
        if rs.proposal_block is None:
            self._sign_add_vote(SignedMsgType.PREVOTE, NIL_BLOCK_ID)
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except DeviceError:
            raise  # the card failed, not the proposal: no nil prevote
        except (BlockValidationError, ValueError) as e:
            self.logger.info("prevote nil: invalid proposal block: %r", e)
            self._sign_add_vote(SignedMsgType.PREVOTE, NIL_BLOCK_ID)
            return
        self._sign_add_vote(
            SignedMsgType.PREVOTE,
            BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header),
        )

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise ConsensusError("enterPrevoteWait without +2/3 prevotes")
        rs.round = round_
        rs.step = RoundStep.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(
            self.config.prevote_timeout_ns(round_),
            height,
            round_,
            RoundStep.PREVOTE_WAIT,
        )

    # ------------------------------------------------------------------
    # step: Precommit
    # ------------------------------------------------------------------

    def _enter_precommit(self, height: int, round_: int) -> None:
        """Reference enterPrecommit state.go:1366 — the locking step."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        self.logger.debug("enterPrecommit %d/%d", height, round_)
        rs.round = round_
        rs.step = RoundStep.PRECOMMIT
        self._new_step()

        prevotes = rs.votes.prevotes(round_)
        block_id = prevotes.two_thirds_majority() if prevotes else None

        if block_id is None:
            # no polka: precommit nil (but do NOT unlock)
            self._sign_add_vote(SignedMsgType.PRECOMMIT, NIL_BLOCK_ID)
            return

        if self.event_bus is not None:
            self.event_bus.publish_polka(rs.round_state_event())

        if block_id.is_nil():
            # +2/3 prevoted nil: unlock and precommit nil (state.go:1431)
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            self._sign_add_vote(SignedMsgType.PRECOMMIT, NIL_BLOCK_ID)
            return

        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            # relock (state.go:1445)
            rs.locked_round = round_
            if self.event_bus is not None:
                self.event_bus.publish_lock(rs.round_state_event())
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id)
            return

        if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
            # lock the proposal block (state.go:1458)
            self.block_exec.validate_block(self.state, rs.proposal_block)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            if self.event_bus is not None:
                self.event_bus.publish_lock(rs.round_state_event())
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id)
            return

        # polka for a block we don't have: unlock, fetch it, precommit nil
        # (state.go:1477)
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not (
            rs.proposal_block_parts.header == block_id.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(block_id.part_set_header)
        self._sign_add_vote(SignedMsgType.PRECOMMIT, NIL_BLOCK_ID)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise ConsensusError("enterPrecommitWait without +2/3 precommits")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit_timeout_ns(round_),
            height,
            round_,
            RoundStep.PRECOMMIT_WAIT,
        )

    # ------------------------------------------------------------------
    # step: Commit
    # ------------------------------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """Reference enterCommit state.go:1520."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        self.logger.debug("enterCommit %d/%d", height, commit_round)
        rs.step = RoundStep.COMMIT
        rs.commit_round = commit_round
        rs.commit_time_ns = self.clock.now_ns()
        self._new_step()

        precommits = rs.votes.precommits(commit_round)
        block_id = precommits.two_thirds_majority()
        if block_id is None or block_id.is_nil():
            raise ConsensusError("enterCommit without +2/3 block precommits")

        # move the locked block to proposal position if it's the one
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            if rs.proposal_block_parts is None or not (
                rs.proposal_block_parts.header == block_id.part_set_header
            ):
                # don't have the block: wait for parts
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
                return
        self._finalize_later()

    def _finalize_later(self) -> None:
        self._finalize_pending = True

    def _materialize_commit(self, precommits):
        """VoteSet -> Commit under the configured wire scheme
        ([consensus] commit_scheme / TMTPU_COMMIT_SCHEME): with
        "bls-aggregate", a BLS validator set's precommit signatures
        fold into one 96-byte aggregate (pure data transformation of
        the gossiped votes — deterministic, so same-seed chaos runs
        produce byte-identical aggregate commits). Any participating
        non-BLS signer falls back to the per-sig form, logged once."""
        import os

        from ..types.block import aggregate_commit

        commit = precommits.make_commit()
        scheme = os.environ.get("TMTPU_COMMIT_SCHEME") or self.config.commit_scheme
        if scheme != "bls-aggregate":
            return commit
        try:
            return aggregate_commit(commit, precommits.val_set)
        except ValueError as e:
            if not self._warned_aggregate_fallback:
                self._warned_aggregate_fallback = True
                self.logger.warning(
                    "commit_scheme=bls-aggregate but commit kept per-sig "
                    "form (%s)", e,
                )
            return commit

    async def _finalize_commit(self) -> None:
        """Reference finalizeCommit state.go:1611 — the only async step
        (ApplyBlock awaits the ABCI app)."""
        rs = self.rs
        if rs.step != RoundStep.COMMIT:
            return
        height = rs.height
        precommits = rs.votes.precommits(rs.commit_round)
        block_id = precommits.two_thirds_majority()
        if block_id is None or block_id.is_nil():
            return
        block, parts = rs.proposal_block, rs.proposal_block_parts
        if block is None or block.hash() != block_id.hash:
            return  # still waiting for the block
        self.block_exec.validate_block(self.state, block)

        # crash matrix points 1-3 mirror the reference's fail.Fail sites
        # around finalizeCommit (state.go:1647-1712)
        fail.fail_point(1)  # before saving the block
        if self.block_store.height() < height:
            seen_commit = self._materialize_commit(precommits)
            self.block_store.save_block(block, parts, seen_commit)
        fail.fail_point(2)  # block saved, before the WAL end-height marker
        # height is durably decided: WAL end-height marker (the blockstore
        # has the block; replay resumes from the next height)
        if self.wal is not None and not self._replay_mode:
            self.wal.write_end_height(height)
        fail.fail_point(3)  # marker written, before ApplyBlock

        state, _ = await self.block_exec.apply_block(self.state, block_id, block)

        if not self._replay_mode:
            ttc = max(0.0, self.clock.monotonic() - self._height_t0)
            self.ttc_hist.observe(ttc)
            trace.emit(
                "consensus", "height", duration_s=ttc, clock=self.clock,
                height=height, round=rs.commit_round,
            )

        # next height
        rs.commit_time_ns = self.clock.now_ns()
        self.update_to_state(state)
        self._decided.set()
        self._decided = asyncio.Event()
        self._schedule_timeout(
            max(0, rs.start_time_ns - self.clock.now_ns()),
            rs.height,
            0,
            RoundStep.NEW_HEIGHT,
        )
        self.logger.info(
            "committed block height=%d hash=%s txs=%d",
            height,
            block_id.hash.hex()[:12],
            len(block.txs),
        )

    async def wait_for_height(self, height: int, timeout: float = 30.0) -> None:
        """Test helper: block until consensus commits `height`."""
        deadline = self.clock.monotonic() + timeout
        while self.rs.height <= height:
            if self.device_error is not None:
                raise self.device_error
            remaining = deadline - self.clock.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"consensus stuck at height {self.rs.height} (wanted > {height})"
                )
            ev = self._decided
            try:
                await asyncio.wait_for(ev.wait(), timeout=min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass

    # ------------------------------------------------------------------
    # votes
    # ------------------------------------------------------------------

    def _try_add_vote(
        self, vote: Vote, peer_id: str, sig_ok: bool | None = None
    ) -> bool:
        """Reference tryAddVote state.go:1961."""
        try:
            return self._add_vote(vote, peer_id, sig_ok=sig_ok)
        except ConflictingVoteError as e:
            if (
                self.priv_validator is not None
                and vote.validator_address
                == self.priv_validator.get_pub_key().address()
            ):
                self.logger.error(
                    "found conflicting vote from ourselves: %s", vote
                )
                return False
            raise

    def _add_vote(
        self, vote: Vote, peer_id: str, sig_ok: bool | None = None
    ) -> bool:
        """Reference addVote state.go:2009 — tallies the vote and drives
        the polka/lock/commit transitions."""
        rs = self.rs

        if sig_ok is False:
            # the ingest pipeline disproved the signature; surface the
            # peer to the reactor (ban/score) and drop like any other
            # invalid input
            if self.invalid_sig_hook is not None and peer_id:
                self.invalid_sig_hook(peer_id, vote)
            raise VoteSetError(
                f"invalid signature from validator {vote.validator_index} "
                f"(disproven by pipelined ingest)"
            )
        verified = sig_ok is True

        # A precommit for the previous height (LastCommit straggler)
        if (
            vote.height + 1 == rs.height
            and vote.type == SignedMsgType.PRECOMMIT
        ):
            if rs.step != RoundStep.NEW_HEIGHT or rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote, verified=verified)
            if added:
                self._publish_vote(vote)
                if self.config.skip_timeout_commit and rs.last_commit.has_all():
                    self._enter_new_round(rs.height, 0)
            return added

        if vote.height != rs.height:
            return False

        added = rs.votes.add_vote(vote, peer_id, verified=verified)
        if not added:
            return False
        self._publish_vote(vote)
        self._broadcast(
            m.HasVoteMessage(vote.height, vote.round, vote.type, vote.validator_index)
        )

        if vote.type == SignedMsgType.PREVOTE:
            self._handle_prevote_added(vote)
        elif vote.type == SignedMsgType.PRECOMMIT:
            self._handle_precommit_added(vote)
        return True

    def _publish_vote(self, vote: Vote) -> None:
        if self.event_bus is not None:
            self.event_bus.publish_vote(EventDataVote(vote))

    def _handle_prevote_added(self, vote: Vote) -> None:
        """state.go:2095-2186 (prevote section of addVote)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        block_id = prevotes.two_thirds_majority()
        if block_id is not None:
            # unlock on a later polka for a different block (state.go:2112)
            if (
                rs.locked_block is not None
                and rs.locked_round < vote.round <= rs.round
                and rs.locked_block.hash() != block_id.hash
            ):
                self.logger.info("unlocking: polka for different block at round %d", vote.round)
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
                if self.event_bus is not None:
                    self.event_bus.publish_unlock(rs.round_state_event())
            # valid-block update (state.go:2133)
            if (
                not block_id.is_nil()
                and rs.valid_round < vote.round
                and vote.round == rs.round
            ):
                if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    # polka for a block we don't have yet: start collecting it
                    rs.proposal_block = None
                    if rs.proposal_block_parts is None or not (
                        rs.proposal_block_parts.header == block_id.part_set_header
                    ):
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
                self._broadcast(
                    m.NewValidBlockMessage(
                        rs.height,
                        rs.round,
                        (block_id.part_set_header.total, block_id.part_set_header.hash),
                        rs.proposal_block_parts.parts_bit_array.copy(),
                        False,
                    )
                )

        # step transitions (the switch at state.go:2161)
        if rs.round < vote.round and prevotes.has_two_thirds_any():
            # round skip: +2/3 of any prevotes in a future round
            self._enter_new_round(rs.height, vote.round)
        elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
            if block_id is not None and (
                self._is_proposal_complete() or block_id.is_nil()
            ):
                self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any():
                self._enter_prevote_wait(rs.height, vote.round)
        elif (
            rs.proposal is not None
            and 0 <= rs.proposal.pol_round == vote.round
        ):
            # the proposal's POL just completed: we can now prevote
            if self._is_proposal_complete():
                self._enter_prevote(rs.height, rs.round)

    def _handle_precommit_added(self, vote: Vote) -> None:
        """state.go:2188-2230 (precommit section of addVote)."""
        rs = self.rs
        precommits = rs.votes.precommits(vote.round)
        block_id = precommits.two_thirds_majority()
        if block_id is not None:
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit(rs.height, vote.round)
            if not block_id.is_nil():
                self._enter_commit(rs.height, vote.round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    self._enter_new_round(rs.height, 0)
            else:
                self._enter_precommit_wait(rs.height, vote.round)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit_wait(rs.height, vote.round)

    # ------------------------------------------------------------------
    # vote signing
    # ------------------------------------------------------------------

    def _vote_time_ns(self) -> int:
        """Monotonic vote time ≥ last block time + 1ms (reference
        voteTime state.go:2237)."""
        now = self.clock.now_ns()
        minimum = 0
        if self.rs.locked_block is not None:
            minimum = self.rs.locked_block.header.time_ns + 1_000_000
        elif self.rs.proposal_block is not None:
            minimum = self.rs.proposal_block.header.time_ns + 1_000_000
        return max(now, minimum)

    def _sign_add_vote(self, type_: SignedMsgType, block_id: BlockID) -> None:
        """Reference signAddVote state.go:2262. The unsigned vote is built
        synchronously (height/round/time are snapshotted here); the privval
        signature itself is produced off-loop via the signing queue."""
        if self._replay_mode:
            return
        if self.priv_validator is None:
            return
        pub = self.priv_validator.get_pub_key()
        addr = pub.address()
        idx, val = self.rs.validators.get_by_address(addr)
        if val is None:
            return  # not a validator
        vote = Vote(
            type=type_,
            height=self.rs.height,
            round=self.rs.round,
            block_id=block_id,
            timestamp_ns=self._vote_time_ns(),
            validator_address=addr,
            validator_index=idx,
        )

        def on_signed(signed: Vote) -> None:
            self._send_internal(MsgInfo(m.VoteMessage(signed)))
            self._broadcast(m.VoteMessage(signed))

        self._queue_signing(
            lambda: self.priv_validator.sign_vote(self.state.chain_id, vote),
            on_signed,
            "vote",
        )
