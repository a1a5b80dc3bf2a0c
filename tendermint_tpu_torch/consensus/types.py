"""Consensus round state (reference internal/consensus/types/round_state.go)
and HeightVoteSet (reference internal/consensus/types/height_vote_set.go;
the port's copy of tendermint_tpu/consensus/types.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..libs.bits import BitArray
from ..types.block import Block, BlockID, Commit
from ..types.keys import SignedMsgType
from ..types.part_set import PartSet
from ..types.validator_set import ValidatorSet
from ..types.vote import Proposal, Vote
from ..types.vote_set import ConflictingVoteError, VoteSet


class RoundStep(enum.IntEnum):
    """Step within a round (reference round_state.go:20-28). Ordering is
    meaningful: later steps compare greater."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class RoundState:
    """Mutable state of the consensus SM for one height (reference
    round_state.go:60). `round` resets the proposal/vote fields; `height`
    resets everything."""

    height: int = 0
    round: int = 0
    step: RoundStep = RoundStep.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0

    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None

    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None

    # the POL round/block for the `valid` value (reference round_state.go:79-87):
    # the most recent block known to have a +2/3 prevote polka
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None

    votes: "HeightVoteSet | None" = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def round_state_event(self):
        from ..types.events import EventDataRoundState

        return EventDataRoundState(self.height, self.round, self.step.name)


@dataclass(frozen=True)
class RoundVoteSet:
    prevotes: VoteSet
    precommits: VoteSet


class HeightVoteSet:
    """All VoteSets for one height, keyed by round; tracks peers'
    claimed +2/3 majorities to cap round skipping (reference
    height_vote_set.go). Rounds 0..round+1 are kept "open"; votes for
    other rounds are only admitted if some peer claimed a majority there
    (set_peer_maj23)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._round_vote_sets: dict[int, RoundVoteSet] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)
        self._add_round(1)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        self._round_vote_sets[round_] = RoundVoteSet(
            prevotes=VoteSet(
                self.chain_id, self.height, round_, SignedMsgType.PREVOTE, self.val_set
            ),
            precommits=VoteSet(
                self.chain_id,
                self.height,
                round_,
                SignedMsgType.PRECOMMIT,
                self.val_set,
            ),
        )

    def set_round(self, round_: int) -> None:
        """Open vote sets up to round+1 (reference height_vote_set.go
        SetRound)."""
        if round_ < self.round:
            raise ValueError("set_round going backwards")
        for r in range(self.round, round_ + 2):
            self._add_round(r)
        self.round = round_

    def add_vote(
        self, vote: Vote, peer_id: str = "", *, verified: bool = False
    ) -> bool:
        """Returns True if added. Unwanted catch-up rounds (beyond
        round+1 with no peer maj23 claim) return False rather than
        raising (reference height_vote_set.go:126). `verified` marks a
        vote whose signature the ingest pipeline already proved."""
        if vote.height != self.height:
            return False
        vs = self._get_vote_set(vote.round, vote.type)
        if vs is None:
            rounds = self._peer_catchup_rounds.get(peer_id, [])
            if vote.round in rounds:
                self._add_round(vote.round)
                vs = self._get_vote_set(vote.round, vote.type)
            else:
                return False  # unwanted round; possible DoS, drop
        return vs.add_vote(vote, verified=verified)

    def wanted(self, vote: Vote, peer_id: str = "") -> bool:
        """Would add_vote even look at this vote — open round, or a
        catch-up round this peer claimed a +2/3 majority for? The
        pipelined ingest checks this BEFORE spending a signature
        verification, mirroring the unwanted-round DoS drop below: a
        flood of far-future-round votes must not burn live-lane hub
        capacity the sequential path never spent."""
        if self._get_vote_set(vote.round, vote.type) is not None:
            return True
        return vote.round in self._peer_catchup_rounds.get(peer_id, [])

    def _get_vote_set(self, round_: int, type_: SignedMsgType) -> VoteSet | None:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs.prevotes if type_ == SignedMsgType.PREVOTE else rvs.precommits

    def prevotes(self, round_: int) -> VoteSet | None:
        return self._get_vote_set(round_, SignedMsgType.PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        return self._get_vote_set(round_, SignedMsgType.PRECOMMIT)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a +2/3 prevote polka (reference
        height_vote_set.go POLInfo)."""
        for r in range(self.round, -1, -1):
            vs = self.prevotes(r)
            if vs is not None:
                maj = vs.two_thirds_majority()
                if maj is not None:
                    return r, maj
        return -1, None

    def set_peer_maj23(
        self,
        round_: int,
        type_: SignedMsgType,
        peer_id: str,
        block_id=None,
    ) -> None:
        """A peer claims a +2/3 majority for (round, type): open that
        round so its votes can be gossiped to us (max 2 catch-up rounds
        per peer, reference height_vote_set.go:165). When the claim
        names a block, the round's vote set records it so conflicting
        votes for THAT block stay admissible (reference SetPeerMaj23 —
        the equivocation-vs-catch-up case: an equivocator's twin in a
        laggard's slot must not block the committed majority forever)."""
        rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
        if round_ not in rounds and len(rounds) < 2:
            rounds.append(round_)
            self._add_round(round_)
        if block_id is not None:
            # record the claim on whichever vote set is reachable — an
            # already-open round takes it even when this peer's
            # catch-up budget is spent; claims are bounded PER PEER in
            # the vote set, so a liar can't crowd out honest donors
            vs = self._get_vote_set(round_, type_)
            if vs is not None:
                vs.set_peer_maj23_block(block_id, peer_id)
