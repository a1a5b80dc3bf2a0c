"""Evidence pool (reference internal/evidence/pool.go:30; the port's copy
of tendermint_tpu/evidence/pool.py).

`EvidencePool(..., device=)` verifies a light-client attack's commits on
`device` ("cuda" by default; raises without a card unless "cpu" is
asked for), through `verify_commit_light(_trusting)` on the hub's
backfill lane; a duplicate vote's two signatures go through
`Vote.verify` (the single-signature chokepoint, the running hub or the
host), as in the reference.

Evidence lives in two DB buckets — pending (verified, awaiting block
inclusion) and committed (markers to prevent re-submission). Conflicting
votes reported by consensus are buffered until `update` runs for the
height that committed them, when the pool can stamp the evidence with
that block's time and validator power (reference
processConsensusBuffer pool.go:512). Expiry follows the consensus
params' max_age_num_blocks AND max_age_duration (both must pass,
reference pool.go:61 isExpired)."""

from __future__ import annotations

import logging
from collections import OrderedDict

from ..crypto.hashes import sha256
from ..device import DEFAULT_DEVICE, resolve
from ..store.db import DB
from ..types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
    decode_evidence,
)
from ..types.keys import SignedMsgType
from . import EvidencePoolI

_PENDING = b"evp/"
_COMMITTED = b"evc/"


def _key(prefix: bytes, height: int, hash_: bytes) -> bytes:
    return prefix + height.to_bytes(8, "big") + hash_


class EvidenceError(ValueError):
    pass


class EvidencePool(EvidencePoolI):
    def __init__(
        self,
        db: DB,
        state_store,
        block_store,
        *,
        device=DEFAULT_DEVICE,
        logger: logging.Logger | None = None,
    ):
        self.device = resolve(device)
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger or logging.getLogger("evidence")
        self._consensus_buffer: list[tuple] = []  # (vote_a, vote_b) pairs
        # cached tip, advanced by update()
        self.state = state_store.load()
        # pending_evidence is polled by the gossip reactor per peer at
        # 4 Hz; decoding the whole pending bucket on every poll turned
        # the first height WITH evidence into an event-loop meltdown at
        # committee scale (50 nodes × 8 peers × 4 Hz × N decodes/s on
        # one core — observed as a liveness wedge the moment 16
        # traitors' evidence became pending). The decoded list is
        # cached and invalidated by the version stamp every mutation
        # bumps.
        self._version = 0
        self._pending_cache: tuple[int, list] | None = None
        # one buffered conflict per (H, R, type, validator): gossip
        # re-delivers an equivocating pair once per re-offer cycle, and
        # without dedup a committee-scale equivocation flood grows the
        # buffer (and the per-commit processing pass) without bound
        self._conflict_keys: set[tuple] = set()
        # verified-LCA memo (bounded, hash-keyed): light-client-attack
        # verification reruns TWO commit checks over a committee-scale
        # conflicting block (trusting + own-set — pairing-heavy for BLS
        # committees), and every proposal carrying the evidence re-asks
        # through check_evidence until it's pending here. The inputs
        # behind a hash are immutable (committed historical state), so
        # a PASSED verdict is safe to replay; failures are never
        # memoized — a "conflicting height not committed yet" rejection
        # legitimately becomes a pass as the tip advances.
        self._lca_verified: "OrderedDict[bytes, bool]" = OrderedDict()

    # -- intake ----------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """Verify and persist gossiped/RPC-submitted evidence (reference
        pool.go:137 AddEvidence)."""
        if self._is_pending(ev):
            return
        if self._is_committed(ev):
            return
        self.verify(ev)
        self._add_pending(ev)
        self.logger.info("added evidence height=%d hash=%s", ev.height, ev.hash().hex()[:12])

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        key = self._conflict_key(vote_a)
        if key in self._conflict_keys:
            return
        if len(self._conflict_keys) >= 1 << 14:
            self._conflict_keys.clear()  # bounded memory; dups re-dedup above
        self._conflict_keys.add(key)
        self._consensus_buffer.append((vote_a, vote_b))

    # -- verification ----------------------------------------------------

    def verify(self, ev) -> None:
        """Full verification against historical state (reference
        verify.go:24 verify)."""
        if self.state is None:
            raise EvidenceError("evidence pool has no state")
        state = self.state
        height = ev.height
        if height > state.last_block_height:
            raise EvidenceError("evidence from the future")
        # expiry window: BOTH dimensions must be exceeded to expire
        params = state.consensus_params.evidence
        age_blocks = state.last_block_height - height
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            raise EvidenceError(f"no block meta at evidence height {height}")
        age_ns = state.last_block_time_ns - meta.header.time_ns
        if (
            age_blocks > params.max_age_num_blocks
            and age_ns > params.max_age_duration_ns
        ):
            raise EvidenceError("evidence has expired")

        if isinstance(ev, DuplicateVoteEvidence):
            self._verify_duplicate_vote(ev, meta.header.time_ns)
        elif isinstance(ev, LightClientAttackEvidence):
            # memo key covers the FULL encoding, not ev.hash():
            # the dedup hash deliberately collapses variants that differ
            # in attribution/timestamp/power, and a same-hash variant
            # with a forged byzantine_validators list must re-run the
            # attribution check, never ride a previous verdict
            memo_key = sha256(ev.encode())
            if self._lca_verified.get(memo_key):
                self._lca_verified.move_to_end(memo_key)
                return
            self._verify_light_client_attack(ev, meta.header.time_ns)
            self._lca_verified[memo_key] = True
            while len(self._lca_verified) > 512:
                self._lca_verified.popitem(last=False)
        else:
            raise EvidenceError(f"unsupported evidence type {type(ev).__name__}")

    def _verify_duplicate_vote(self, ev: DuplicateVoteEvidence, block_time_ns: int) -> None:
        """Reference verify.go VerifyDuplicateVote."""
        ev.validate_basic()
        vals = self.state_store.load_validators(ev.height)
        if vals is None:
            raise EvidenceError(f"no validator set at height {ev.height}")
        idx, val = vals.get_by_address(ev.vote_a.validator_address)
        if val is None:
            raise EvidenceError("validator not in set at evidence height")
        if ev.vote_a.type != SignedMsgType.PRECOMMIT and ev.vote_a.type != SignedMsgType.PREVOTE:
            raise EvidenceError("bad vote type in evidence")
        # power and total must match the historical set (verify.go:104)
        if ev.validator_power != val.voting_power:
            raise EvidenceError("evidence validator power mismatch")
        if ev.total_voting_power != vals.total_voting_power():
            raise EvidenceError("evidence total power mismatch")
        if ev.timestamp_ns != block_time_ns:
            raise EvidenceError("evidence timestamp != block time")
        chain_id = self.state.chain_id
        # vote.verify routes through the VerifyHub: the consensus
        # reactor already verified both votes of a live equivocation, so
        # these are usually verdict-cache hits, not device work
        for vote in (ev.vote_a, ev.vote_b):
            if not vote.verify(chain_id, val.pub_key):
                raise EvidenceError("invalid signature on evidence vote")

    def _verify_light_client_attack(
        self, ev: LightClientAttackEvidence, common_block_time_ns: int
    ) -> None:
        """Reference verify.go:159 VerifyLightClientAttack:
        1. the conflicting block must be properly signed — by 1/3+ of the
           common-height validator set when the attack skips heights
           (VerifyCommitLightTrusting), or carry the exact common-height
           validator hash when adjacent;
        2. AND by +2/3 of its own claimed validator set (VerifyCommitLight
           — this funnels into the device batch path, verify.go:176);
        3. the header must actually conflict with the block we committed;
        4. attribution/power/time fields must match what this node derives."""
        from fractions import Fraction

        from ..types.validation import (
            InvalidCommitError,
            verify_commit_light,
            verify_commit_light_trusting,
        )

        ev.validate_basic()
        chain_id = self.state.chain_id
        common_vals = self.state_store.load_validators(ev.common_height)
        if common_vals is None:
            raise EvidenceError(
                f"no validator set at common height {ev.common_height}"
            )
        conflicting = ev.conflicting_block
        sh = conflicting.signed_header
        try:
            # backfill lane: evidence verification is accountability
            # traffic, never the consensus hot path — a flood of LCA
            # reports fills device batches behind live votes
            if ev.common_height != conflicting.height:
                # skipping attack: 1/3 of the common set must have signed
                verify_commit_light_trusting(
                    chain_id, common_vals, sh.commit, Fraction(1, 3),
                    device=self.device, lane="backfill",
                )
            else:
                if conflicting.header.validators_hash != common_vals.hash():
                    raise EvidenceError(
                        "adjacent attack: conflicting header carries a "
                        "different validator set than the common height"
                    )
            verify_commit_light(
                chain_id,
                conflicting.validators,
                sh.commit.block_id,
                conflicting.height,
                sh.commit,
                device=self.device,
                lane="backfill",
            )
        except InvalidCommitError as e:
            raise EvidenceError(f"conflicting block not properly signed: {e}") from e

        # must actually conflict with what we committed at that height
        trusted_meta = self.block_store.load_block_meta(conflicting.height)
        if trusted_meta is None:
            raise EvidenceError(
                f"no committed block at conflicting height {conflicting.height}"
            )
        if trusted_meta.header.hash() == conflicting.header.hash():
            raise EvidenceError("conflicting header matches the committed one")

        # attribution and the snapshot fields must match our own derivation
        trusted_commit = self.block_store.load_block_commit(conflicting.height)
        if trusted_commit is None:
            # canonical commit for H is stored with block H+1 — at the
            # store tip only the seen-commit exists
            trusted_commit = self.block_store.load_seen_commit(conflicting.height)
        if trusted_commit is None:
            raise EvidenceError(
                f"no commit for conflicting height {conflicting.height}"
            )
        from ..light.types import SignedHeader

        trusted_sh = SignedHeader(trusted_meta.header, trusted_commit)
        expect_byz = ev.get_byzantine_validators(common_vals, trusted_sh)
        if [v.address for v in ev.byzantine_validators] != [
            v.address for v in expect_byz
        ]:
            raise EvidenceError("byzantine validator attribution mismatch")
        if ev.total_voting_power != common_vals.total_voting_power():
            raise EvidenceError("evidence total power mismatch")
        if ev.timestamp_ns != common_block_time_ns:
            raise EvidenceError("evidence timestamp != common block time")

    # -- proposal / block flow ------------------------------------------

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        cache = self._pending_cache
        if cache is not None and cache[0] == self._version:
            return self._clip(cache[1], max_bytes)
        full: list[tuple[object, int]] = []
        for _, raw in self.db.iterate(_PENDING, _PENDING + b"\xff"):
            full.append((decode_evidence(raw), len(raw)))
        self._pending_cache = (self._version, full)
        return self._clip(full, max_bytes)

    @staticmethod
    def _clip(entries: list, max_bytes: int) -> tuple[list, int]:
        out, size = [], 0
        for ev, sz in entries:
            if size + sz > max_bytes:
                break
            out.append(ev)
            size += sz
        return out, size

    def check_evidence(self, evidence: tuple) -> None:
        """Verify all evidence in a proposed block (reference
        pool.go:166 CheckEvidence)."""
        seen = set()
        for ev in evidence:
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            if self._is_committed(ev):
                raise EvidenceError("evidence already committed")
            if not self._is_pending(ev):
                self.verify(ev)

    def update(self, state, evidence: tuple) -> None:
        """Block committed: mark its evidence committed, convert buffered
        consensus equivocations, prune expired (reference pool.go Update)."""
        self.state = state
        for ev in evidence:
            self._mark_committed(ev)
        self._process_consensus_buffer(state)
        self._prune(state)

    @staticmethod
    def _conflict_key(vote_a) -> tuple:
        return (
            vote_a.height,
            vote_a.round,
            int(vote_a.type),
            vote_a.validator_address,
        )

    def _process_consensus_buffer(self, state) -> None:
        buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            try:
                vals = self.state_store.load_validators(vote_a.height)
                meta = self.block_store.load_block_meta(vote_a.height)
                if vals is None or meta is None:
                    # too old or not yet committed; re-buffer if plausible
                    if vote_a.height > state.last_block_height:
                        self._consensus_buffer.append((vote_a, vote_b))
                    continue
                ev = DuplicateVoteEvidence.from_votes(
                    vote_a, vote_b, meta.header.time_ns, vals
                )
                if not self._is_pending(ev) and not self._is_committed(ev):
                    self.verify(ev)
                    self._add_pending(ev)
                    self.logger.info(
                        "equivocation evidence from consensus height=%d val=%s",
                        ev.height,
                        ev.vote_a.validator_address.hex()[:12],
                    )
            except Exception as e:
                # forget the dedup key: with it retained, the NEXT
                # gossip re-delivery of this pair would be silently
                # dropped at report time and a transient failure here
                # (store hiccup mid-update) would cost the evidence
                # forever
                self._conflict_keys.discard(self._conflict_key(vote_a))
                self.logger.error("failed to build consensus evidence: %r", e)

    def _prune(self, state) -> None:
        params = state.consensus_params.evidence
        for key, raw in list(self.db.iterate(_PENDING, _PENDING + b"\xff")):
            ev = decode_evidence(raw)
            age_blocks = state.last_block_height - ev.height
            meta = self.block_store.load_block_meta(ev.height)
            expired_time = True
            if meta is not None:
                expired_time = (
                    state.last_block_time_ns - meta.header.time_ns
                    > params.max_age_duration_ns
                )
            if age_blocks > params.max_age_num_blocks and expired_time:
                self._version += 1
                self.db.delete(key)
                self.logger.debug("pruned expired evidence at height %d", ev.height)

    # -- storage helpers -------------------------------------------------

    def _add_pending(self, ev) -> None:
        self._version += 1
        self.db.set(_key(_PENDING, ev.height, ev.hash()), ev.encode())

    def _mark_committed(self, ev) -> None:
        self._version += 1
        self.db.delete(_key(_PENDING, ev.height, ev.hash()))
        self.db.set(_key(_COMMITTED, ev.height, ev.hash()), b"\x01")

    def _is_pending(self, ev) -> bool:
        return self.db.has(_key(_PENDING, ev.height, ev.hash()))

    def _is_committed(self, ev) -> bool:
        return self.db.has(_key(_COMMITTED, ev.height, ev.hash()))
