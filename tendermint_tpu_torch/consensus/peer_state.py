"""Per-peer consensus view (reference internal/consensus/peer_state.go; the
port's copy of tendermint_tpu/consensus/peer_state.py).

Tracks what one peer has — its height/round/step, which proposal parts
and votes it holds — so the gossip routines send only what is missing."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs.bits import BitArray
from ..types.keys import SignedMsgType
from ..types.vote import Vote


@dataclass
class PeerRoundState:
    """The peer's claimed round state (reference
    internal/consensus/types/peer_round_state.go)."""

    height: int = 0
    round: int = -1
    step: int = 0
    proposal: bool = False
    proposal_block_parts_header: tuple[int, bytes] | None = None
    proposal_block_parts: BitArray | None = None
    proposal_pol_round: int = -1
    proposal_pol: BitArray | None = None
    prevotes: dict[int, BitArray] = field(default_factory=dict)
    precommits: dict[int, BitArray] = field(default_factory=dict)
    last_commit_round: int = -1
    last_commit: BitArray | None = None
    catchup_commit_round: int = -1
    catchup_commit: BitArray | None = None


class PeerState:
    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self.prs = PeerRoundState()

    # -- updates from the state channel ---------------------------------

    def apply_new_round_step(self, msg) -> None:
        """Reference peer_state.go ApplyNewRoundStepMessage."""
        prs = self.prs
        initial = (prs.height, prs.round)
        if msg.height != prs.height or msg.round != prs.round:
            prs.proposal = False
            prs.proposal_block_parts_header = None
            prs.proposal_block_parts = None
            prs.proposal_pol_round = -1
            prs.proposal_pol = None
        if msg.height != prs.height:
            # shift vote bookkeeping: the peer's precommits of the old
            # height become its last-commit
            if prs.height + 1 == msg.height and prs.round in prs.precommits:
                prs.last_commit_round = prs.round
                prs.last_commit = prs.precommits.get(prs.round)
            else:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = None
            prs.prevotes = {}
            prs.precommits = {}
            prs.catchup_commit_round = -1
            prs.catchup_commit = None
        prs.height = msg.height
        prs.round = msg.round
        prs.step = msg.step

    def apply_new_valid_block(self, msg) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.round != msg.round and not msg.is_commit:
            return
        prs.proposal_block_parts_header = msg.block_part_set_header
        prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.proposal_pol_round != msg.proposal_pol_round:
            return
        prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg) -> None:
        if self.prs.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def set_has_proposal(self, proposal) -> None:
        prs = self.prs
        if prs.height != proposal.height or prs.round != proposal.round:
            return
        if prs.proposal:
            return
        prs.proposal = True
        if prs.proposal_block_parts is None:
            psh = proposal.block_id.part_set_header
            prs.proposal_block_parts_header = (psh.total, psh.hash)
            prs.proposal_block_parts = BitArray(psh.total)
        prs.proposal_pol_round = proposal.pol_round
        prs.proposal_pol = None

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        prs = self.prs
        if prs.height != height or prs.round != round_:
            return
        if prs.proposal_block_parts is None:
            return
        prs.proposal_block_parts.set(index, True)

    # -- vote bookkeeping ------------------------------------------------

    def _votes_bits(self, height: int, round_: int, type_: SignedMsgType, size: int) -> BitArray | None:
        prs = self.prs
        if height == prs.height:
            table = prs.prevotes if type_ == SignedMsgType.PREVOTE else prs.precommits
            if round_ not in table:
                table[round_] = BitArray(size)
            ba = table[round_]
            if ba.size == 0 and size:
                table[round_] = ba = BitArray(size)
            return ba
        if height + 1 == prs.height and type_ == SignedMsgType.PRECOMMIT:
            if round_ == prs.last_commit_round:
                if prs.last_commit is None:
                    prs.last_commit = BitArray(size)
                return prs.last_commit
        if height < prs.height and type_ == SignedMsgType.PRECOMMIT:
            if round_ == prs.catchup_commit_round:
                if prs.catchup_commit is None:
                    prs.catchup_commit = BitArray(size)
                return prs.catchup_commit
        return None

    def set_has_vote(self, height: int, round_: int, type_: SignedMsgType, index: int) -> None:
        ba = self._votes_bits(height, round_, type_, index + 1)
        if ba is not None:
            if ba.size <= index:
                grown = BitArray(index + 1)
                for i in ba.true_indices():
                    grown.set(i, True)
                self._replace_bits(height, round_, type_, ba, grown)
                ba = grown
            ba.set(index, True)

    def _replace_bits(self, height, round_, type_, old, new) -> None:
        prs = self.prs
        if height == prs.height:
            table = prs.prevotes if type_ == SignedMsgType.PREVOTE else prs.precommits
            table[round_] = new
        elif old is prs.last_commit:
            prs.last_commit = new
        elif old is prs.catchup_commit:
            prs.catchup_commit = new

    def reset_gossip_marks(self) -> None:
        """Forget what we believe the peer already holds (proposal flag,
        part bits, vote bits, catch-up bits) while KEEPING its claimed
        height/round/step. The gossip routines mark an item as delivered
        at SEND time, so a frame the wire ate — dropped, or corrupted
        into something else — leaves a false positive that is never
        resent. The reactor calls this when a link looks wedged (both
        round states static, nothing left to send): the next gossip
        passes re-offer everything, and the receiver's dedup (VoteSet /
        PartSet add) makes re-sends idempotent."""
        prs = self.prs
        prs.proposal = False
        prs.proposal_block_parts_header = None
        prs.proposal_block_parts = None
        prs.proposal_pol_round = -1
        prs.proposal_pol = None
        prs.prevotes = {}
        prs.precommits = {}
        prs.last_commit = None
        prs.catchup_commit_round = -1
        prs.catchup_commit = None

    def apply_vote_set_bits(self, msg, our_votes: BitArray | None) -> None:
        """Reference peer_state.go ApplyVoteSetBitsMessage: a VoteSetBits
        reply is an AUTHORITATIVE statement of what the peer holds for
        the queried (height, round, type, block), so it REPLACES our
        bookkeeping instead of or-ing into it. This is the only
        mechanism that can clear a false `has_vote` mark — e.g. a
        corrupted frame that still decoded as a plausible HasVote, or a
        vote we sent that the wire silently ate — and without it one
        poisoned bit starves the peer of that vote forever (a liveness
        wedge the router-chaos matrix reproduces). `our_votes` (our own
        bit array for the queried block) keeps bits for OTHER blocks
        that the reply cannot speak for."""
        votes = self._votes_bits(
            msg.height, msg.round, msg.type, msg.votes.size
        )
        if votes is None:
            return
        if our_votes is None:
            new = msg.votes.copy()
        else:
            other_block_bits = votes.sub(our_votes)
            new = other_block_bits.or_(msg.votes)
        self._replace_bits(msg.height, msg.round, msg.type, votes, new)

    def ensure_catchup_commit(self, height: int, round_: int, size: int) -> None:
        """Peer is far behind; track which precommits of `height`'s seen
        commit we have sent it (reference EnsureCatchupCommitRound)."""
        prs = self.prs
        if prs.catchup_commit_round != round_:
            prs.catchup_commit_round = round_
            prs.catchup_commit = BitArray(size)

    def pick_vote_to_send(self, votes) -> Vote | None:
        """A vote from `votes` (a VoteSet) the peer does not have
        (reference PickSendVote/PickVoteToSend)."""
        picked = self.pick_votes_to_send(votes, 1)
        return picked[0] if picked else None

    def pick_votes_to_send(self, votes, limit: int) -> list[Vote]:
        """Up to `limit` votes the peer is missing — the batched gossip
        pick. Committee-scale nets move votes in VoteBatch frames (one
        envelope per ~32 votes instead of one each); which missing votes
        go first doesn't affect correctness, so this takes them in
        index order rather than paying a random draw per vote."""
        if votes is None or votes.size() == 0:
            return []
        ba = self._votes_bits(votes.height, votes.round, votes.type, votes.size())
        if ba is None:
            return []
        missing = votes.votes_bit_array.sub(ba)
        out: list[Vote] = []
        for idx in missing.true_indices():
            v = votes.get_vote(idx)
            if v is not None:
                out.append(v)
                if len(out) >= limit:
                    break
        return out
