"""Consensus reactor (reference internal/consensus/reactor.go; the port's
copy of tendermint_tpu/consensus/reactor.py, over the p2p `Channel`).

Four wire channels (reactor.go:84-87):
  0x20 state — NewRoundStep / NewValidBlock / HasVote / VoteSetMaj23
  0x21 data  — Proposal / ProposalPOL / BlockPart
  0x22 vote  — Vote
  0x23 vote-set-bits — VoteSetBits

Per-peer gossip tasks mirror the reference's three goroutines
(gossipDataRoutine :519, gossipVotesRoutine :731, queryMaj23Routine
:813): each loops over the local RoundState vs the tracked PeerState and
sends exactly what the peer is missing."""

from __future__ import annotations

import asyncio
import logging

from ..libs import trace
from ..libs.clock import SYSTEM
from ..libs.service import Service
from ..p2p.peermanager import PeerStatus
from ..p2p.router import Channel
from ..p2p.types import Envelope, PeerError
from ..types.block import Commit
from ..types.keys import SignedMsgType
from ..types.vote import Vote

from . import messages as m
from .peer_state import PeerState
from .state import ConsensusState
from .types import RoundStep

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

GOSSIP_SLEEP = 0.05  # reference peerGossipSleepDuration=100ms; we poll faster
QUERY_MAJ23_SLEEP = 2.0
# votes per VoteBatch frame: per-envelope overhead (framing + queue
# hops + task wakeups) dominates committee-scale gossip, so missing
# votes ship in batches instead of one frame each
VOTE_GOSSIP_BATCH = 32
# have-vote hints are coalesced for this long before one batched
# broadcast (advisory traffic: a slightly stale hint only risks a
# duplicate send, which the receiver's VoteSet dedups)
HAS_VOTE_FLUSH_S = 0.05
# default catch-up token-bucket burst (items = votes or block parts):
# one full commit's worth of votes at committee scale, so a single
# freshly-healed laggard still catches a whole height per tick while a
# SUSTAINED lag storm (many laggards, or byzantine peers lying about
# their height to bait catch-up service) degrades to the refill rate
CATCHUP_BURST = 4 * 32


class _CatchupBucket:
    """Per-peer token bucket for catch-up service (ROADMAP: straggler
    catch-up at 150 validators costs the donor 1-3 min of loop share —
    and consensus/byzantine.py's lying_frames strategy manufactures
    laggards on purpose). One token = one sent item (a commit vote or a
    stored block part). Pure function of (rate, burst, now): callers
    pass the injected clock's monotonic reading, so the bucket is
    deterministic under test clocks and never reads wall time."""

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = rate
        self.burst = max(1, burst)
        self.tokens = float(self.burst)
        self.last = now

    def grant(self, want: int, now: float) -> int:
        self.tokens = min(
            float(self.burst), self.tokens + max(0.0, now - self.last) * self.rate
        )
        self.last = now
        got = min(want, int(self.tokens))
        self.tokens -= got
        return got


class ConsensusReactor(Service):
    def __init__(
        self,
        cs: ConsensusState,
        state_ch: Channel,
        data_ch: Channel,
        vote_ch: Channel,
        bits_ch: Channel,
        peer_updates: asyncio.Queue,
        *,
        logger: logging.Logger | None = None,
        gossip_sleep: float = GOSSIP_SLEEP,
        stall_refresh_s: float | None = None,
        catchup_rate: float | None = None,
        catchup_burst: int | None = None,
    ):
        super().__init__("cs-reactor", logger)
        self.cs = cs
        # per-peer catch-up pacing: rate = items/s a single lagging peer
        # may draw from this node's stores (None = unlimited, the
        # pre-pacing behavior small nets keep). Bounds the donor's loop
        # share during lag storms; the laggard's recovery speed then
        # comes from MANY donors, each serving its bounded slice.
        self.catchup_rate = catchup_rate
        self.catchup_burst = (
            catchup_burst if catchup_burst is not None else CATCHUP_BURST
        )
        self._catchup_buckets: dict[str, _CatchupBucket] = {}
        # per-peer gossip poll interval: large router-chaos nets (50-150
        # validators x degree-k topologies) raise it so thousands of
        # gossip tasks don't saturate the loop with 20 Hz wakeups
        self.gossip_sleep = gossip_sleep
        if stall_refresh_s is not None:
            self.STALL_REFRESH_S = stall_refresh_s
        self.state_ch = state_ch
        self.data_ch = data_ch
        self.vote_ch = vote_ch
        self.bits_ch = bits_ch
        self.peer_updates = peer_updates
        self.peers: dict[str, PeerState] = {}
        self._peer_tasks: dict[str, list[asyncio.Task]] = {}
        self._hasvote_buf: list[m.HasVoteMessage] = []

    # -- lifecycle -------------------------------------------------------

    async def on_start(self) -> None:
        self.cs.step_hook = self._on_new_step
        self.cs.broadcast_hook = self._on_broadcast
        self.cs.invalid_sig_hook = self._on_invalid_sig
        self.spawn(self._process_peer_updates(), name="csr.peers")
        self.spawn(self._process_state_ch(), name="csr.state")
        self.spawn(self._process_data_ch(), name="csr.data")
        self.spawn(self._process_vote_ch(), name="csr.vote")
        self.spawn(self._process_bits_ch(), name="csr.bits")
        self.spawn(self._flush_has_votes(), name="csr.hasvote")

    async def on_stop(self) -> None:
        self.cs.step_hook = None
        self.cs.broadcast_hook = None
        self.cs.invalid_sig_hook = None
        for tasks in self._peer_tasks.values():
            for t in tasks:
                t.cancel()

    # -- hooks from the state machine -----------------------------------

    def _new_round_step_msg(self) -> m.NewRoundStepMessage:
        rs = self.cs.rs
        return m.NewRoundStepMessage(
            height=rs.height,
            round=rs.round,
            step=int(rs.step),
            seconds_since_start_time=max(
                0, int((self.cs.clock.now_ns() - rs.start_time_ns) / 1e9)
            ),
            last_commit_round=rs.last_commit.round if rs.last_commit else -1,
        )

    def _on_new_step(self, rs) -> None:
        self._send_nowait(
            self.state_ch, Envelope(STATE_CHANNEL, self._new_round_step_msg(), broadcast=True)
        )

    def _on_broadcast(self, msg) -> None:
        """Out-of-band broadcasts from the SM: HasVote/NewValidBlock go to
        the state channel; proposal/parts/votes are handled by gossip
        (but broadcasting them too cuts a round-trip on small nets).
        HasVote is pure advisory traffic and the SM emits one per added
        vote — O(validators) per height — so it is coalesced and flushed
        as a single HasVoteBatch frame (`_flush_has_votes`)."""
        if isinstance(msg, m.HasVoteMessage):
            if len(self._hasvote_buf) < 8192:  # bounded: hints are lossy
                self._hasvote_buf.append(msg)
            return
        if isinstance(msg, m.NewValidBlockMessage):
            self._send_nowait(self.state_ch, Envelope(STATE_CHANNEL, msg, broadcast=True))

    async def _flush_has_votes(self) -> None:
        while True:
            await asyncio.sleep(HAS_VOTE_FLUSH_S)
            if not self._hasvote_buf:
                continue
            buf, self._hasvote_buf = self._hasvote_buf, []
            for i in range(0, len(buf), m.MAX_BATCH_VOTES):
                chunk = buf[i : i + m.MAX_BATCH_VOTES]
                msg = (
                    chunk[0]
                    if len(chunk) == 1
                    else m.HasVoteBatchMessage(tuple(chunk))
                )
                self._send_nowait(
                    self.state_ch, Envelope(STATE_CHANNEL, msg, broadcast=True)
                )

    def _send_nowait(self, ch: Channel, env: Envelope) -> None:
        try:
            ch.out_q.put_nowait(env)
        except asyncio.QueueFull:
            self.logger.warning("dropping outbound on %s: full", ch.name)

    def _on_invalid_sig(self, peer_id: str, vote) -> None:
        """The ingest pipeline disproved a peer-supplied vote signature.
        Before pipelining this was swallowed inside the apply-time
        VoteSetError; now the peer gets reported to the peer manager
        (score/ban) like any other protocol violation."""
        self.spawn(
            self.vote_ch.error(
                PeerError(
                    peer_id,
                    f"invalid vote signature (h={vote.height} r={vote.round} "
                    f"val={vote.validator_index})",
                )
            ),
            name="csr.badsig",
        )

    # -- peer lifecycle --------------------------------------------------

    async def _process_peer_updates(self) -> None:
        while True:
            upd = await self.peer_updates.get()
            if upd.status == PeerStatus.UP:
                if upd.node_id in self.peers:
                    continue
                ps = PeerState(upd.node_id)
                self.peers[upd.node_id] = ps
                self._peer_tasks[upd.node_id] = [
                    self.spawn(self._gossip_data(ps), name=f"csr.gd.{upd.node_id[:8]}"),
                    self.spawn(self._gossip_votes(ps), name=f"csr.gv.{upd.node_id[:8]}"),
                    self.spawn(self._query_maj23(ps), name=f"csr.qm.{upd.node_id[:8]}"),
                ]
                # tell the new peer where we are
                self._send_nowait(
                    self.state_ch,
                    Envelope(STATE_CHANNEL, self._new_round_step_msg(), to=upd.node_id),
                )
            else:
                self.peers.pop(upd.node_id, None)
                self._catchup_buckets.pop(upd.node_id, None)
                for t in self._peer_tasks.pop(upd.node_id, []):
                    t.cancel()

    def _catchup_grant(self, peer_id: str, want: int) -> int:
        """How many catch-up items (commit votes / stored parts) this
        peer may be served right now. Unlimited when pacing is off."""
        if self.catchup_rate is None or want <= 0:
            return want
        now = self.cs.clock.monotonic()
        bucket = self._catchup_buckets.get(peer_id)
        if bucket is None:
            bucket = _CatchupBucket(self.catchup_rate, self.catchup_burst, now)
            self._catchup_buckets[peer_id] = bucket
        return bucket.grant(want, now)

    # -- inbound processing ---------------------------------------------

    async def _process_state_ch(self) -> None:
        async for env in self.state_ch:
            ps = self.peers.get(env.from_)
            if ps is None:
                continue
            msg = env.message
            try:
                if isinstance(msg, m.NewRoundStepMessage):
                    ps.apply_new_round_step(msg)
                elif isinstance(msg, m.NewValidBlockMessage):
                    ps.apply_new_valid_block(msg)
                elif isinstance(msg, m.HasVoteMessage):
                    ps.apply_has_vote(msg)
                elif isinstance(msg, m.HasVoteBatchMessage):
                    for entry in msg.entries:
                        ps.apply_has_vote(entry)
                elif isinstance(msg, m.VoteSetMaj23Message):
                    await self._handle_vote_set_maj23(env.from_, msg)
            except Exception as e:
                await self.state_ch.error(PeerError(env.from_, f"state msg: {e!r}"))

    async def _handle_vote_set_maj23(self, peer_id: str, msg) -> None:
        """Record the claim, reply with our bits for that (round, type,
        block) (reference handleStateMessage VoteSetMaj23)."""
        rs = self.cs.rs
        if rs.height != msg.height or rs.votes is None:
            return
        rs.votes.set_peer_maj23(msg.round, msg.type, peer_id, msg.block_id)
        vs = (
            rs.votes.prevotes(msg.round)
            if msg.type == SignedMsgType.PREVOTE
            else rs.votes.precommits(msg.round)
        )
        if vs is None:
            return
        bits = vs.bit_array_by_block_id(msg.block_id)
        if bits is None:
            from ..libs.bits import BitArray

            bits = BitArray(vs.size())
        self._send_nowait(
            self.bits_ch,
            Envelope(
                VOTE_SET_BITS_CHANNEL,
                m.VoteSetBitsMessage(msg.height, msg.round, msg.type, msg.block_id, bits),
                to=peer_id,
            ),
        )

    def _start_trace(self, env):
        """Open the end-to-end trace at the gossip edge. The router
        stamped `env.recv_at` as the bytes came off the wire; the
        p2p.receive span (recorded by the caller after the hand-off)
        therefore covers decode + channel-queue wait + ingest
        backpressure."""
        return trace.start(self.cs.clock)

    def _finish_receive(self, ctx, env, channel: str) -> None:
        if ctx is None:
            return
        # recv_at was stamped by the router on the SYSTEM monotonic
        # domain; this node's clock may be rate-scaled (chaos drift), so
        # measure the duration purely in the SYSTEM domain and anchor it
        # ending at the trace clock's "now" — mixing the two domains in
        # one subtraction would corrupt the duration by (rate-1)*uptime
        now = self.cs.clock.monotonic()
        dur = max(0.0, SYSTEM.monotonic() - env.recv_at) if env.recv_at else 0.0
        trace.record(
            ctx, "p2p", "receive", now - dur, now,
            channel=channel, peer=env.from_[:8],
        )

    async def _process_data_ch(self) -> None:
        async for env in self.data_ch:
            ps = self.peers.get(env.from_)
            msg = env.message
            try:
                if isinstance(msg, m.ProposalMessage):
                    if ps is not None:
                        ps.set_has_proposal(msg.proposal)
                    ctx = self._start_trace(env)
                    await self.cs.add_proposal(msg.proposal, env.from_, trace_ctx=ctx)
                    self._finish_receive(ctx, env, "data")
                elif isinstance(msg, m.ProposalPOLMessage):
                    if ps is not None:
                        ps.apply_proposal_pol(msg)
                elif isinstance(msg, m.BlockPartMessage):
                    if ps is not None:
                        ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
                    ctx = self._start_trace(env)
                    await self.cs.add_block_part(
                        msg.height, msg.round, msg.part, env.from_, trace_ctx=ctx
                    )
                    self._finish_receive(ctx, env, "data")
            except Exception as e:
                await self.data_ch.error(PeerError(env.from_, f"data msg: {e!r}"))

    async def _process_vote_ch(self) -> None:
        async for env in self.vote_ch:
            msg = env.message
            if isinstance(msg, m.VoteMessage):
                votes = (msg.vote,)
            elif isinstance(msg, m.VoteBatchMessage):
                votes = msg.votes
            else:
                continue
            # a decoded-but-garbage vote (corrupt frame that survived the
            # codec) must cost the PEER, never the channel task: an
            # uncaught error here would kill csr.vote and wedge the node
            # for every honest peer too
            try:
                ps = self.peers.get(env.from_)
                first = True
                for v in votes:
                    if v.validator_index > m.MAX_WIRE_INDEX:
                        # same wire bound the HasVote decoder enforces:
                        # peer bookkeeping must not grow bit arrays from
                        # an unvalidated index before add_vote rejects it
                        raise ValueError(
                            f"vote validator_index {v.validator_index} "
                            f"exceeds {m.MAX_WIRE_INDEX}"
                        )
                    if ps is not None:
                        ps.set_has_vote(v.height, v.round, v.type, v.validator_index)
                    ctx = self._start_trace(env)
                    await self.cs.add_vote(v, env.from_, trace_ctx=ctx)
                    if first:
                        # the decode+queue-wait window is per ENVELOPE:
                        # recording it on every vote of a batch would
                        # attribute the same wall time up to 32x
                        self._finish_receive(ctx, env, "vote")
                        first = False
            except Exception as e:
                await self.vote_ch.error(PeerError(env.from_, f"vote msg: {e!r}"))

    async def _process_bits_ch(self) -> None:
        async for env in self.bits_ch:
            msg = env.message
            if not isinstance(msg, m.VoteSetBitsMessage):
                continue
            ps = self.peers.get(env.from_)
            if ps is None:
                continue
            try:
                # authoritative reconciliation (reference
                # handleVoteSetBitsMessage): the reply REPLACES our view
                # of the peer's votes for the queried round — clearing
                # has-vote false positives (corrupt-frame HasVotes, sends
                # the wire ate) that one-way OR bookkeeping keeps forever
                our_votes = None
                rs = self.cs.rs
                if rs.height == msg.height and rs.votes is not None:
                    vs = (
                        rs.votes.prevotes(msg.round)
                        if msg.type == SignedMsgType.PREVOTE
                        else rs.votes.precommits(msg.round)
                    )
                    if vs is not None:
                        our_votes = vs.bit_array_by_block_id(msg.block_id)
                ps.apply_vote_set_bits(msg, our_votes)
            except Exception as e:
                await self.bits_ch.error(PeerError(env.from_, f"bits msg: {e!r}"))

    # -- gossip routines -------------------------------------------------

    async def _gossip_data(self, ps: PeerState) -> None:
        """Reference gossipDataRoutine reactor.go:519."""
        while True:
            rs = self.cs.rs
            prs = ps.prs
            sent = False
            if rs.height == prs.height and rs.proposal_block_parts is not None:
                sent = self._send_missing_part(ps)
            if not sent and rs.height == prs.height and rs.proposal is not None and not prs.proposal:
                ps.set_has_proposal(rs.proposal)
                self._send_nowait(
                    self.data_ch,
                    Envelope(DATA_CHANNEL, m.ProposalMessage(rs.proposal), to=ps.peer_id),
                )
                if rs.proposal.pol_round >= 0:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        self._send_nowait(
                            self.data_ch,
                            Envelope(
                                DATA_CHANNEL,
                                m.ProposalPOLMessage(
                                    rs.height,
                                    rs.proposal.pol_round,
                                    pol.votes_bit_array.copy(),
                                ),
                                to=ps.peer_id,
                            ),
                        )
                sent = True
            if not sent and 0 < prs.height < rs.height:
                sent = self._send_catchup_part(ps)
            if not sent:
                await asyncio.sleep(self.gossip_sleep)
            else:
                await asyncio.sleep(0)

    def _send_missing_part(self, ps: PeerState) -> bool:
        rs = self.cs.rs
        prs = ps.prs
        if prs.proposal_block_parts is None:
            return False
        ours = rs.proposal_block_parts.parts_bit_array
        theirs = prs.proposal_block_parts
        missing = ours.sub(theirs)
        idx = missing.pick_random()
        if idx is None:
            return False
        part = rs.proposal_block_parts.get_part(idx)
        if part is None:
            return False
        ps.set_has_proposal_block_part(prs.height, prs.round, idx)
        self._send_nowait(
            self.data_ch,
            Envelope(DATA_CHANNEL, m.BlockPartMessage(prs.height, prs.round, part), to=ps.peer_id),
        )
        return True

    def _send_catchup_part(self, ps: PeerState) -> bool:
        """Peer is on an earlier height: serve stored block parts
        (reference gossipDataForCatchup reactor.go:577)."""
        prs = ps.prs
        meta = self.cs.block_store.load_block_meta(prs.height)
        if meta is None:
            return False
        psh = meta.block_id.part_set_header
        if prs.proposal_block_parts is None or prs.proposal_block_parts_header != (
            psh.total,
            psh.hash,
        ):
            from ..libs.bits import BitArray

            prs.proposal_block_parts_header = (psh.total, psh.hash)
            prs.proposal_block_parts = BitArray(psh.total)
        # batched: send every part the peer is missing in one sweep (a
        # catching-up peer must outpace live block production) — capped
        # by the per-peer catch-up bucket so a lag storm cannot turn
        # this sweep into the donor's whole loop share
        missing = prs.proposal_block_parts.not_().true_indices()
        grant = self._catchup_grant(ps.peer_id, len(missing))
        sent = False
        for idx in missing:
            if grant <= 0:
                break
            part = self.cs.block_store.load_block_part(prs.height, idx)
            if part is None:
                continue
            grant -= 1
            prs.proposal_block_parts.set(idx, True)
            self._send_nowait(
                self.data_ch,
                Envelope(
                    DATA_CHANNEL,
                    m.BlockPartMessage(prs.height, prs.round, part),
                    to=ps.peer_id,
                ),
            )
            sent = True
        return sent

    # a peer link with BOTH round states static and nothing to send for
    # this long is presumed poisoned (a send-marked frame the wire ate:
    # chaos drop/corruption, or a queue-full drop) — reset the gossip
    # marks and re-offer. Only a stalled link pays the duplicate cost,
    # and consecutive refreshes without progress back off exponentially:
    # at 50-150 validators a refresh re-offers ~2 votes/validator per
    # link, and a 1s refresh cadence across hundreds of links turns the
    # cure into a resend storm that starves the very delivery it is
    # trying to restart (measured: >2k duplicate vote sends/s, loop
    # saturated, zero progress).
    STALL_REFRESH_S = 1.0
    STALL_REFRESH_MAX_BACKOFF = 4  # cap: threshold * 2**4

    async def _gossip_votes(self, ps: PeerState) -> None:
        """Reference gossipVotesRoutine reactor.go:731, plus the
        stall-refresh: the routines mark items delivered at SEND time,
        so a lossy byte path can leave has-marks for frames that never
        arrived; when the link is wedged-idle we forget the marks and
        let receiver-side dedup absorb the re-sends."""
        last_sig = None
        idle = 0
        last_lag_sig = None
        lag_idle = 0
        refreshes = 0  # consecutive refreshes with no progress since
        while True:
            rs = self.cs.rs
            prs = ps.prs
            sent = False
            if rs.height == prs.height:
                sent = self._gossip_votes_same_height(ps)
            elif prs.height != 0 and rs.height == prs.height + 1 and rs.last_commit is not None:
                sent = self._pick_send_vote(ps, rs.last_commit)
            elif (
                prs.height != 0
                and rs.height >= prs.height + 2
                and self.cs.block_store.base() <= prs.height <= self.cs.block_store.height()
            ):
                commit = self.cs.block_store.load_block_commit(prs.height)
                if commit is not None:
                    sent = self._send_catchup_commit_vote(ps, commit)
            # stall detection, two distinct wedge shapes:
            #  * committee wedge — EVERYTHING static (our round state and
            #    the peer's) and nothing to send: some send-marked frame
            #    never arrived (chaos drop/corruption/queue-full);
            #  * starved laggard — the peer sits BEHIND us and doesn't
            #    move while we have "already sent" catch-up marks: those
            #    marks were set while the link was partitioned/lossy
            #    (gossip marks at SEND time, delivery was never
            #    confirmed), and since WE keep committing, only a
            #    peer-scoped trigger can notice.
            sig = (rs.height, rs.round, int(rs.step), prs.height, prs.round, prs.step)
            # the starved-laggard signature is the peer's HEIGHT alone:
            # a laggard whose catch-up frames were eaten keeps churning
            # ROUNDS on its own timeouts (it can never quorum a stale
            # height by itself), and a (height, round, step) signature
            # reads that churn as progress — the refresh then never
            # fires and the mark-poisoned link starves the peer for as
            # long as the rounds keep turning (surfaced by the byz
            # full-taxonomy matrix: a healed one-way-partition victim
            # wedged at its old height while round-cycling)
            lag_sig = prs.height
            if sent:
                # sending resets the idle clocks but NOT the backoff: a
                # refresh's own re-offers count as sends, so resetting
                # `refreshes` here would re-arm the base cadence after
                # every refresh and a permanently deaf link would eat
                # full-commit resends at base rate forever. Only
                # OBSERVED round-state progress (sig change below)
                # re-arms fast refresh.
                idle = lag_idle = 0
                last_sig, last_lag_sig = sig, lag_sig
                await asyncio.sleep(0)
                continue
            if sig != last_sig:
                refreshes = 0  # progress somewhere: re-arm fast refresh
            idle = idle + 1 if sig == last_sig else 0
            lag_behind = 0 < prs.height < rs.height
            lag_idle = lag_idle + 1 if (lag_sig == last_lag_sig and lag_behind) else 0
            last_sig, last_lag_sig = sig, lag_sig
            threshold = self.STALL_REFRESH_S * (
                2 ** min(refreshes, self.STALL_REFRESH_MAX_BACKOFF)
            )
            stalled = idle * self.gossip_sleep >= threshold
            starved = lag_idle * self.gossip_sleep >= threshold
            if stalled or starved:
                refreshes += 1
                ps.reset_gossip_marks()
                # and re-exchange round state: NewRoundStep is only
                # broadcast on step CHANGES, so one queue-full/chaos
                # drop leaves the peer's view of us stale forever — and
                # an idle-wedged committee produces no step changes to
                # fix it. The peer's own stall-refresh answers with its
                # HRS, un-staling our prs in the same cycle.
                self._send_nowait(
                    self.state_ch,
                    Envelope(
                        STATE_CHANNEL, self._new_round_step_msg(), to=ps.peer_id
                    ),
                )
                idle = lag_idle = 0
            await asyncio.sleep(self.gossip_sleep)

    def _gossip_votes_same_height(self, ps: PeerState) -> bool:
        rs = self.cs.rs
        prs = ps.prs
        # last commit first (peer may still be finishing the previous height)
        if prs.step == int(RoundStep.NEW_HEIGHT) and rs.last_commit is not None:
            if self._pick_send_vote(ps, rs.last_commit):
                return True
        # POL prevotes
        if prs.proposal_pol_round != -1 and prs.proposal_pol_round <= rs.round:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._pick_send_vote(ps, pol):
                return True
        if prs.round != -1 and prs.round <= rs.round:
            if self._pick_send_vote(ps, rs.votes.prevotes(prs.round)):
                return True
            if self._pick_send_vote(ps, rs.votes.precommits(prs.round)):
                return True
        return False

    def _pick_send_vote(self, ps: PeerState, votes) -> bool:
        """Ship up to VOTE_GOSSIP_BATCH missing votes in one frame
        (reference PickSendVote sends one; batching is the in-process
        scale adaptation — per-envelope overhead is the gossip cost)."""
        picked = ps.pick_votes_to_send(votes, VOTE_GOSSIP_BATCH)
        if not picked:
            return False
        for vote in picked:
            ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
        msg = (
            m.VoteMessage(picked[0])
            if len(picked) == 1
            else m.VoteBatchMessage(tuple(picked))
        )
        self._send_nowait(
            self.vote_ch, Envelope(VOTE_CHANNEL, msg, to=ps.peer_id)
        )
        return True

    def _send_catchup_commit_vote(self, ps: PeerState, commit: Commit) -> bool:
        """Send ALL missing precommits of a stored commit at once — a peer
        catching up must close the gap faster than blocks are produced,
        so catch-up gossip is batched rather than one-vote-per-tick."""
        prs = ps.prs
        ps.ensure_catchup_commit(prs.height, commit.round, len(commit.signatures))
        have = prs.catchup_commit
        # per-peer pacing: only votes actually granted get their "sent"
        # mark — an over-budget remainder stays unmarked and ships on a
        # later tick once the bucket refills
        budget = self._catchup_grant(
            ps.peer_id,
            sum(
                1
                for idx, cs_ in enumerate(commit.signatures)
                if not cs_.is_absent() and not have.get(idx)
            ),
        )
        pending: list[Vote] = []
        for idx, cs_ in enumerate(commit.signatures):
            if len(pending) >= budget:
                break
            if cs_.is_absent() or have.get(idx):
                continue
            pending.append(
                Vote(
                    type=SignedMsgType.PRECOMMIT,
                    height=commit.height,
                    round=commit.round,
                    block_id=cs_.block_id(commit.block_id),
                    timestamp_ns=cs_.timestamp_ns,
                    validator_address=cs_.validator_address,
                    validator_index=idx,
                    signature=cs_.signature,
                )
            )
            have.set(idx, True)
        for i in range(0, len(pending), VOTE_GOSSIP_BATCH):
            chunk = pending[i : i + VOTE_GOSSIP_BATCH]
            msg = (
                m.VoteMessage(chunk[0])
                if len(chunk) == 1
                else m.VoteBatchMessage(tuple(chunk))
            )
            self._send_nowait(
                self.vote_ch, Envelope(VOTE_CHANNEL, msg, to=ps.peer_id)
            )
        return bool(pending)

    async def _query_maj23(self, ps: PeerState) -> None:
        """Reference queryMaj23Routine reactor.go:813: periodically tell
        peers which majorities we see so they can send us missing votes."""
        while True:
            await asyncio.sleep(QUERY_MAJ23_SLEEP)
            rs = self.cs.rs
            prs = ps.prs
            if rs.height != prs.height:
                # catch-up half (reference reactor.go:846): a laggard can
                # only ADMIT the catch-up precommits `_gossip_votes` sends
                # it if the stored commit's round is open in its
                # HeightVoteSet — rounds beyond its round+1 need a peer
                # maj23 claim (set_peer_maj23). Without this, a peer that
                # fell behind while the committee decided in a late round
                # drops every rescue vote and wedges forever.
                if (
                    prs.height != 0
                    and self.cs.block_store.base()
                    <= prs.height
                    <= self.cs.block_store.height()
                ):
                    commit = self.cs.block_store.load_block_commit(
                        prs.height
                    ) or self.cs.block_store.load_seen_commit(prs.height)
                    if commit is not None:
                        self._send_nowait(
                            self.state_ch,
                            Envelope(
                                STATE_CHANNEL,
                                m.VoteSetMaj23Message(
                                    prs.height,
                                    commit.round,
                                    SignedMsgType.PRECOMMIT,
                                    commit.block_id,
                                ),
                                to=ps.peer_id,
                            ),
                        )
                continue
            if rs.votes is None:
                continue
            # reference reactor.go:820-846 — claim the majorities we see
            # in OUR round, the peer's round, and the peer's POL round;
            # the VoteSetBits replies these trigger reconcile our view of
            # the peer (apply_vote_set_bits), so a poisoned has-vote mark
            # heals within one query cycle
            queries = {(rs.round, SignedMsgType.PREVOTE),
                       (rs.round, SignedMsgType.PRECOMMIT)}
            if prs.round >= 0:
                queries.add((prs.round, SignedMsgType.PREVOTE))
                queries.add((prs.round, SignedMsgType.PRECOMMIT))
            if prs.proposal_pol_round >= 0:
                queries.add((prs.proposal_pol_round, SignedMsgType.PREVOTE))
            for round_, type_ in sorted(queries):
                vs = (
                    rs.votes.prevotes(round_)
                    if type_ == SignedMsgType.PREVOTE
                    else rs.votes.precommits(round_)
                )
                if vs is None:
                    continue
                maj = vs.two_thirds_majority()
                if maj is not None:
                    self._send_nowait(
                        self.state_ch,
                        Envelope(
                            STATE_CHANNEL,
                            m.VoteSetMaj23Message(rs.height, round_, type_, maj),
                            to=ps.peer_id,
                        ),
                    )
