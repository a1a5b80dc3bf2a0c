"""VoteSet — collects votes of one (height, round, type), tracks the 2/3
tally, detects conflicting votes (reference types/vote_set.go; the port's
copy of tendermint_tpu/types/vote_set.py).

A vote set accepts at most one vote per validator; a second, different vote
from the same validator is rejected and surfaced as a conflict pair for the
evidence pool. `two_thirds_majority()` returns the BlockID once >2/3 of the
voting power has voted for it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs.bits import BitArray
from .block import BlockID
from .keys import SignedMsgType
from .validator_set import ValidatorSet
from .vote import Vote


class VoteSetError(ValueError):
    pass


@dataclass
class ConflictingVoteError(Exception):
    existing: Vote
    new: Vote


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        type_: SignedMsgType,
        val_set: ValidatorSet,
    ):
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = type_
        self.val_set = val_set
        self.votes: list[Vote | None] = [None] * len(val_set)
        self.votes_bit_array = BitArray(len(val_set))
        self.sum = 0
        self._by_block: dict[bytes, int] = {}  # block key -> tallied power
        self._block_votes: dict[bytes, BitArray] = {}
        self.maj23: BlockID | None = None
        # peer-claimed +2/3 blocks (reference SetPeerMaj23): conflicting
        # votes for a CLAIMED block stay admissible, so a catching-up
        # node can still assemble the committed majority when an
        # equivocator's twin got tallied first and occupies the slot —
        # without this, one reordered twin wedges the laggard forever
        # (it re-rejects the committed majority's real vote as a
        # conflict on every catch-up re-serve).
        self._peer_maj23_blocks: dict[bytes, BlockID] = {}
        self._maj23_claims_by_peer: dict[str, set[bytes]] = {}
        self._maj23_votes: dict[bytes, dict[int, Vote]] = {}

    def size(self) -> int:
        return len(self.val_set)

    def add_vote(self, vote: Vote, *, verified: bool = False) -> bool:
        """Validate + add a vote. Returns True if added; raises on invalid
        votes; raises ConflictingVoteError on an equivocation (the caller
        turns it into DuplicateVoteEvidence).

        `verified=True` is the pre-verified-vote path: the pipelined
        ingest (consensus/ingest.py) already proved this exact vote's
        signature against the pubkey this set resolves for its index,
        so the apply-time re-check is skipped. Index/address identity
        and conflict detection still run unconditionally."""
        if vote is None:
            raise VoteSetError("nil vote")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.type
        ):
            raise VoteSetError(
                f"vote {vote.height}/{vote.round}/{vote.type} does not match "
                f"set {self.height}/{self.round}/{self.type}"
            )
        idx = vote.validator_index
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise VoteSetError(f"no validator at index {idx}")
        if val.address != vote.validator_address:
            raise VoteSetError("validator address does not match index")

        existing = self.votes[idx]
        if existing is not None:
            if existing.block_id == vote.block_id:
                return False  # duplicate, not an error
            key = vote.block_id.key()
            if key in self._peer_maj23_blocks:
                return self._add_conflicting_maj23_vote(
                    vote, idx, val, key, verified
                )
            raise ConflictingVoteError(existing, vote)

        if not verified and not vote.verify(self.chain_id, val.pub_key):
            raise VoteSetError(f"invalid signature from validator {idx}")

        self.votes[idx] = vote
        self.votes_bit_array.set(idx, True)
        self.sum += val.voting_power
        key = vote.block_id.key()
        self._by_block[key] = self._by_block.get(key, 0) + val.voting_power
        ba = self._block_votes.setdefault(key, BitArray(len(self.val_set)))
        ba.set(idx, True)
        self._maybe_cross_maj23(key, vote.block_id)
        return True

    def _maybe_cross_maj23(self, key: bytes, block_id: BlockID) -> None:
        """Single place +2/3 crossing is decided — BOTH add paths call
        it, so conflict-admitted bucket votes are adopted into the
        canonical slots no matter which vote tipped the tally over.
        (Adopting only inside the conflict path left make_commit
        holding twins — an under-quorum commit — whenever the crossing
        vote arrived through the normal path.)"""
        if self.maj23 is not None:
            return
        total = self.val_set.total_voting_power()
        if self._by_block.get(key, 0) * 3 <= total * 2:
            return
        self.maj23 = block_id
        for i, v in self._maj23_votes.get(key, {}).items():
            cur = self.votes[i]
            if cur is not None and cur.block_id != block_id:
                self.votes[i] = v

    def set_peer_maj23_block(
        self, block_id: BlockID | None, peer_id: str = ""
    ) -> None:
        """A peer claims +2/3 voted `block_id` (reference vote_set.go
        SetPeerMaj23): record the block so conflicting votes for it
        become admissible (see `_add_conflicting_maj23_vote`). Bounded
        PER PEER (reference keys claims by peer): a lying peer can burn
        only its own two slots — it cannot exhaust a shared table and
        crowd out an honest donor's claim for the real committed block.
        A claim changes nothing until +2/3 of real signatures arrive."""
        if block_id is None or block_id.is_nil():
            return
        key = block_id.key()
        if key in self._peer_maj23_blocks:
            return
        claims = self._maj23_claims_by_peer.setdefault(peer_id, set())
        if len(claims) >= 2:
            return
        claims.add(key)
        self._peer_maj23_blocks[key] = block_id

    def _add_conflicting_maj23_vote(
        self, vote: Vote, idx: int, val, key: bytes, verified: bool
    ) -> bool:
        """Admit a conflicting vote for a peer-claimed +2/3 block
        (reference vote_set.go votesByBlock): the vote counts toward
        THAT block's tally only — the canonical slot keeps its first
        vote — and when the claimed block actually crosses +2/3 the
        canonical slots adopt its votes, so `make_commit` materializes
        the real committed majority, not the equivocator's twins.

        The (existing, vote) pair is NOT re-raised here: the node is
        rescuing itself with already-gossiped votes, and every node
        that tallied the pair in the other order produced the
        DuplicateVoteEvidence through the normal conflict path."""
        bucket = self._maj23_votes.setdefault(key, {})
        if idx in bucket:
            return False  # same conflicting vote again: plain duplicate
        if not verified and not vote.verify(self.chain_id, val.pub_key):
            raise VoteSetError(f"invalid signature from validator {idx}")
        bucket[idx] = vote
        ba = self._block_votes.setdefault(key, BitArray(len(self.val_set)))
        if not ba.get(idx):
            ba.set(idx, True)
            self._by_block[key] = self._by_block.get(key, 0) + val.voting_power
        self._maybe_cross_maj23(key, self._peer_maj23_blocks[key])
        return True

    def get_vote(self, idx: int) -> Vote | None:
        if 0 <= idx < len(self.votes):
            return self.votes[idx]
        return None

    def two_thirds_majority(self) -> BlockID | None:
        return self.maj23

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.sum * 3 > self.val_set.total_voting_power() * 2

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        ba = self._block_votes.get(block_id.key())
        return ba.copy() if ba is not None else None

    def make_commit(self) -> "Commit":
        """Materialize a Commit once a block has +2/3 precommits
        (reference types/vote_set.go MakeCommit)."""
        from .block import Commit, CommitSig

        if self.type != SignedMsgType.PRECOMMIT:
            raise VoteSetError("commit requires precommits")
        if self.maj23 is None or self.maj23.is_nil():
            raise VoteSetError("no +2/3 majority for a block")
        sigs = []
        for i, vote in enumerate(self.votes):
            if vote is None:
                sigs.append(CommitSig.absent())
            elif vote.block_id == self.maj23:
                sigs.append(
                    CommitSig.for_block(
                        vote.validator_address, vote.timestamp_ns, vote.signature
                    )
                )
            elif vote.is_nil():
                sigs.append(
                    CommitSig.for_nil(
                        vote.validator_address, vote.timestamp_ns, vote.signature
                    )
                )
            else:
                # vote for a different block: recorded as absent in the commit
                sigs.append(CommitSig.absent())
        return Commit(self.height, self.round, self.maj23, tuple(sigs))
