"""Pipelined consensus ingest — stage 1 of the two-stage receive path.

The receive routine historically verified each vote's signature through
the hub's SYNC facade, so a lone node pinned per-vote batch occupancy
at 1: the whole gossip firehose serialized behind one signature at a
time (ROADMAP's "biggest lever"). This module splits ingest into:

  stage 1 (this file, concurrent): incoming votes/proposals get a cheap
      structural check, are deduplicated against the live vote-set, and
      then submitted via the ASYNC ``hub.verify`` API — up to
      ``max_inflight`` verifications overlap per node, which is exactly
      what the micro-batching scheduler needs to fill device-sized
      batches from a single process (the request-pipelining shape the
      FPGA verification engines in arXiv:2112.02229 get their
      throughput from);

  stage 2 (the state machine, strictly ordered): verdicts flow through
      a sequence-numbered REORDER BUFFER and are released to
      ``ConsensusState.msg_queue`` in arrival order, so the SM's
      in-order single-task processing contract — and with it same-seed
      bit-reproducibility under chaos — is untouched. A message whose
      signature stage 1 proved carries ``sig_ok=True`` and is not
      re-checked at apply time (the pre-verified-vote path through
      ``VoteSet.add_vote``); a proven-bad signature carries
      ``sig_ok=False`` and is dropped at apply (after the WAL write,
      like any other rejected input); anything stage 1 could not
      attribute (wrong height, no hub) stays ``None`` and falls back to
      the apply-time synchronous check, i.e. exactly the pre-pipeline
      behavior.

A device error differs from the reference's handling (the port's copy of
tendermint_tpu/consensus/ingest.py). The reference turns any hub
exception into ``None`` and lets the apply-time check verify again. The
port's hub has no host re-verify behind a failed device batch, and
stage 1 does not add one: the error is logged, counted in its own stat
``hub_errors`` (never in ``unverified``), and the message is released
with ``sig_ok=None``. Its apply-time check goes back through the running
hub, so a card that keeps failing fails that check too, loudly; the
host verifies only when no hub is running (the shutdown race the
reference's comment names, or library use).

Backpressure: a semaphore bounds the TOTAL number of messages between
``submit`` and in-order release (intake + verifying + parked in the
reorder buffer) at ``max_inflight``; ``submit`` awaits a permit BEFORE
a sequence number is assigned, so a gossip storm backs up into the
reactor's channel instead of ballooning the reorder buffer, a caller
cancelled mid-backpressure leaves no hole in the sequence space, and
the intake queue is always strictly sequence-ordered (permit → seq →
put_nowait with no await in between). Workers are plain
``Service.spawn`` tasks owned by the ConsensusState — stop() cancels
them mid-verify without leaking tasks or absorbing cancellation, and
anything already verified but not yet released is simply dropped with
the queue (the WAL only records APPLIED inputs, so a crash/stop here
is indistinguishable from the message never arriving).

Config: ``ConsensusConfig.ingest_pipeline`` / ``ingest_max_inflight``,
env mirrors ``TMTPU_INGEST_PIPELINE`` / ``TMTPU_INGEST_INFLIGHT``.
"""

from __future__ import annotations

import asyncio
import logging
import weakref
from dataclasses import replace

from ..libs import trace
from ..libs.metrics import Histogram
from ..types.keys import SignedMsgType
from . import messages as m

#: same sub-millisecond buckets as the hub's queue-latency histogram —
#: NodeMetrics folds pipeline histograms index-for-index
from ..crypto.verify_hub import LATENCY_BUCKETS

#: process-wide registry of running pipelines (multi-node in-process
#: tests run several); NodeMetrics sums them at render time, mirroring
#: crypto.verify_hub.running_hub
_pipelines: "weakref.WeakSet[IngestPipeline]" = weakref.WeakSet()


def aggregate():
    """(summed stats, verify-latency hist, reorder-wait hist) across
    every live pipeline, or (None, None, None) when none is running."""
    pipes = [p for p in _pipelines if p.started]
    if not pipes:
        return None, None, None
    keys = pipes[0].stats.keys()
    s = {k: sum(p.stats[k] for p in pipes) for k in keys}
    s["inflight"] = float(sum(p.inflight for p in pipes))

    def fold(hists):
        counts = [0] * (len(LATENCY_BUCKETS) + 1)
        total_sum, total_count = 0.0, 0
        for h in hists:
            for i, c in enumerate(h._counts):
                counts[i] += c
            total_sum += h._sum
            total_count += h._count
        return counts, total_sum, total_count

    return (
        s,
        fold([p.verify_latency for p in pipes]),
        fold([p.reorder_wait for p in pipes]),
    )


class IngestPipeline:
    """Stage-1 verifier pool + reorder buffer in front of one
    ConsensusState (see module docstring)."""

    def __init__(
        self,
        cs,
        *,
        max_inflight: int = 64,
        logger: logging.Logger | None = None,
    ):
        self.cs = cs
        self.max_inflight = max(1, int(max_inflight))
        self.logger = logger or logging.getLogger("consensus.ingest")
        self.started = False
        # one permit per message from submit() until in-order release:
        # bounds intake + verifying + reorder buffer at max_inflight
        # combined, and awaiting it BEFORE the seq is assigned is the
        # backpressure edge (see module docstring)
        self._sem = asyncio.Semaphore(self.max_inflight)
        # unbounded Queue object, but occupancy is capped by _sem; it
        # holds strictly ascending seqs because submit() never awaits
        # between seq assignment and put_nowait
        self._intake: asyncio.Queue = asyncio.Queue()
        # seq -> (verdict_done_at, MsgInfo | None, TraceCtx | None);
        # MsgInfo None = dropped in stage 1
        self._buf: dict[int, tuple[float, object | None, object | None]] = {}
        self._next_submit = 0
        self._next_release = 0
        self._completed = asyncio.Event()
        self.verify_latency = Histogram(
            "consensus_ingest_verify_latency_seconds",
            "stage-1 intake-to-verdict wait per message",
            buckets=LATENCY_BUCKETS,
        )
        self.reorder_wait = Histogram(
            "consensus_ingest_reorder_wait_seconds",
            "verdict-to-in-order-release wait per message",
            buckets=LATENCY_BUCKETS,
        )
        self.stats = {
            "submitted": 0.0,      # messages entering stage 1
            "released": 0.0,       # messages released in-order to the SM
            "dedup_drops": 0.0,    # gossip duplicates dropped pre-verify
            "structural_drops": 0.0,  # failed validate_basic in stage 1
            "pre_verified": 0.0,   # signature proven in stage 1
            "sig_invalid": 0.0,    # signature disproven in stage 1
            "unverified": 0.0,     # deferred to the apply-time check
            "hub_errors": 0.0,     # hub.verify raised (a device error)
        }

    @property
    def inflight(self) -> int:
        """Messages submitted and not yet released (intake + verifying +
        parked in the reorder buffer)."""
        return self._next_submit - self._next_release

    def start(self) -> None:
        """Spawn the worker pool + release task on the owning service —
        Service.stop() cancels and reaps them (no task leaks)."""
        for i in range(self.max_inflight):
            self.cs.spawn(self._worker(), name=f"cs.ingest.w{i}")
        self.cs.spawn(self._release_loop(), name="cs.ingest.release")
        self.started = True
        _pipelines.add(self)

    def stop(self) -> None:
        """Deregister from the metrics registry (the owning service's
        stop() cancels the worker/release tasks); a stopped node's
        counters must not keep folding into /metrics."""
        self.started = False
        _pipelines.discard(self)

    async def submit(self, mi) -> None:
        """Stage-1 intake: wait for an in-flight permit (backpressure —
        `max_inflight` messages between here and in-order release), then
        assign the arrival sequence number and hand the message to the
        verifier pool. The permit is acquired BEFORE the seq, with no
        await in between seq assignment and the put, so a cancelled
        submitter leaves no hole in the sequence space and the intake
        queue is strictly seq-ordered."""
        await self._sem.acquire()
        seq = self._next_submit
        self._next_submit += 1
        self.stats["submitted"] += 1
        t0 = self.cs.clock.monotonic()
        # flight-recorder trace: adopt the reactor-opened context (which
        # already carries the p2p.receive span) or open one here for
        # harness-injected messages; the "submit" mark anchors the
        # end-to-end ingest span the SM closes at apply time
        ctx = mi.trace if mi.trace is not None else trace.start(self.cs.clock)
        if ctx is not None:
            ctx.marks["submit"] = t0
        self._intake.put_nowait((seq, t0, mi, ctx))

    # -- stage 1: concurrent verify --------------------------------------

    async def _worker(self) -> None:
        while True:
            # the reorder buffer needs no explicit bound here: every
            # message from submit() to release holds one _sem permit,
            # so intake + verifying + _buf together can never exceed
            # max_inflight — and a worker that always drains intake
            # can never deadlock against a release loop stalled on a
            # seq still sitting in the queue
            seq, t0, mi, ctx = await self._intake.get()
            t_start = self.cs.clock.monotonic()
            trace.record(ctx, "consensus", "ingest.wait", t0, t_start)
            out = mi
            try:
                out = await self._classify(mi, ctx)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — never wedge the sequence
                # verdict stays "unknown": the apply-time check decides,
                # through the hub when one runs (module docstring)
                self.logger.error(
                    "stage-1 verify failed (%r); deferring to apply", e
                )
                out = mi
            now = self.cs.clock.monotonic()
            self.verify_latency.observe(max(0.0, now - t0))
            trace.record(
                ctx, "consensus", "ingest.verify", t_start, now,
                sig_ok=getattr(out, "sig_ok", None) if out is not None else None,
                dropped=out is None,
            )
            self._buf[seq] = (now, out, ctx)
            self._completed.set()

    async def _classify(self, mi, ctx=None):
        """Returns the (possibly sig_ok-annotated) MsgInfo to release,
        or None to drop the message in stage 1."""
        msg = mi.msg
        if isinstance(msg, m.VoteMessage):
            return await self._classify_vote(mi, msg.vote, ctx)
        if isinstance(msg, m.ProposalMessage):
            return await self._classify_proposal(mi, msg.proposal, ctx)
        # block parts & friends carry no signature of their own; they
        # still ride the reorder buffer so arrival order is preserved
        return mi

    async def _classify_vote(self, mi, vote, ctx=None):
        try:
            vote.validate_basic()
        except ValueError as e:
            # the sequential path rejects these at apply; dropping a
            # structurally-invalid vote earlier changes no state
            self.stats["structural_drops"] += 1
            self.logger.debug("dropping malformed vote: %r", e)
            return None
        if self._duplicate_vote(vote):
            self.stats["dedup_drops"] += 1
            return None
        pub = self._resolve_vote_pubkey(vote, mi.peer_id)
        if pub is None:
            # wrong height / unwanted round (the SM will drop it) or
            # unknown validator (apply raises) — nothing worth
            # verifying here
            self.stats["unverified"] += 1
            return mi
        chain_id = self.cs.state.chain_id
        ok = await self._hub_verify(
            pub, vote.sign_bytes(chain_id), vote.signature, ctx
        )
        if ok is None:
            self.stats["unverified"] += 1
            return mi
        self.stats["pre_verified" if ok else "sig_invalid"] += 1
        return replace(mi, sig_ok=ok)

    async def _classify_proposal(self, mi, proposal, ctx=None):
        rs = self.cs.rs
        # only pre-verify when the proposal targets the CURRENT (height,
        # round): the proposer is then pinned, and if the round moves on
        # before apply the SM drops the proposal before trusting sig_ok
        if (
            rs.proposal is not None
            or rs.validators is None
            or self.cs.state is None
            or proposal.height != rs.height
            or proposal.round != rs.round
        ):
            return mi
        try:
            proposal.validate_basic()
        except ValueError:
            return mi  # apply raises/logs identically to the sync path
        pub = rs.validators.get_proposer().pub_key
        ok = await self._hub_verify(
            pub, proposal.sign_bytes(self.cs.state.chain_id), proposal.signature, ctx
        )
        if ok is None:
            self.stats["unverified"] += 1
            return mi
        self.stats["pre_verified" if ok else "sig_invalid"] += 1
        return replace(mi, sig_ok=ok)

    def _duplicate_vote(self, vote) -> bool:
        """Exact duplicate of a vote already tallied (same validator,
        same block) — the add_vote outcome would be a no-op False, so
        the signature is not worth verifying. A DIFFERENT block from
        the same validator is NOT a duplicate: it must verify and reach
        the SM in order so equivocation evidence is still produced."""
        rs = self.cs.rs
        if rs.votes is not None and vote.height == rs.height:
            vs = (
                rs.votes.prevotes(vote.round)
                if vote.type == SignedMsgType.PREVOTE
                else rs.votes.precommits(vote.round)
            )
            if vs is None:
                return False
            existing = vs.get_vote(vote.validator_index)
            return existing is not None and existing.block_id == vote.block_id
        if (
            vote.height + 1 == rs.height
            and vote.type == SignedMsgType.PRECOMMIT
            and rs.last_commit is not None
        ):
            existing = rs.last_commit.get_vote(vote.validator_index)
            return existing is not None and existing.block_id == vote.block_id
        return False

    def _resolve_vote_pubkey(self, vote, peer_id: str = ""):
        """The pubkey the apply-time vote-set would check this vote
        against, or None when stage 1 cannot attribute it. Validator
        sets are fixed per height, so a verdict computed here stays
        valid even if the SM advances before the in-order apply."""
        rs = self.cs.rs
        if rs.votes is not None and vote.height == rs.height:
            if not rs.votes.wanted(vote, peer_id):
                # unwanted round: apply drops it without a signature
                # check — don't spend one here either (DoS guard)
                return None
            vals = rs.votes.val_set
        elif vote.height + 1 == rs.height and rs.last_validators is not None:
            vals = rs.last_validators
        else:
            return None
        val = vals.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return None
        return val.pub_key

    async def _hub_verify(self, pub, sign_bytes, sig, ctx=None):
        """Async hub verdict, or None when no hub is running (the
        apply-time check then decides). A hub error (a failed device
        batch) is counted in `hub_errors` and re-raised: the worker
        releases the message unverified, and its apply-time check goes
        back through the hub (module docstring)."""
        from ..crypto.verify_hub import LANE_LIVE, running_hub

        hub = running_hub()
        if hub is None:
            return None
        try:
            return await hub.verify(
                pub, sign_bytes, sig, lane=LANE_LIVE, trace_ctx=ctx
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            self.stats["hub_errors"] += 1
            raise

    # -- stage 2 hand-off: in-order release ------------------------------

    async def _release_loop(self) -> None:
        """Drain the reorder buffer strictly in sequence order into the
        SM's input queue. Single consumer: release order == arrival
        order, bit-for-bit what the sequential facade produced."""
        while True:
            await self._completed.wait()
            self._completed.clear()
            while self._next_release in self._buf:
                done_at, out, ctx = self._buf.pop(self._next_release)
                self._next_release += 1
                if out is None:
                    self._sem.release()
                    continue  # dropped in stage 1 (dup / malformed)
                t_rel = self.cs.clock.monotonic()
                self.reorder_wait.observe(max(0.0, t_rel - done_at))
                if ctx is not None:
                    trace.record(ctx, "consensus", "ingest.reorder", done_at, t_rel)
                    ctx.marks["release"] = t_rel
                    if out.trace is None:
                        out = replace(out, trace=ctx)
                self.stats["released"] += 1
                # put BEFORE releasing the permit: a stalled SM (full
                # msg_queue) keeps the in-flight bound strict
                await self.cs.msg_queue.put(out)
                self._sem.release()
