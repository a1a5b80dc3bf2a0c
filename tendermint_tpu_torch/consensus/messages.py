"""Consensus protocol messages (reference proto/tendermint/consensus/types.proto
and internal/consensus/msgs.go; the port's copy of
tendermint_tpu/consensus/messages.py, with the interpreted codec only).

One union envelope `Message` with a type tag; used both on the wire
(reactor channels) and in the WAL (wrapped in MsgInfo with the peer id,
or TimeoutInfo for timer ticks — reference wal.go WALMessage)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protoenc as pe
from ..libs.bits import BitArray
from ..types.block import BlockID, NIL_BLOCK_ID
from ..types.keys import SignedMsgType
from ..types.part_set import Part
from ..types.vote import Proposal, Vote
from .ticker import TimeoutInfo
from .types import RoundStep

# message type tags (stable wire ids)
T_NEW_ROUND_STEP = 1
T_NEW_VALID_BLOCK = 2
T_PROPOSAL = 3
T_PROPOSAL_POL = 4
T_BLOCK_PART = 5
T_VOTE = 6
T_HAS_VOTE = 7
T_VOTE_SET_MAJ23 = 8
T_VOTE_SET_BITS = 9
T_VOTE_BATCH = 10
T_HAS_VOTE_BATCH = 11

# WAL record tags
W_MSG_INFO = 1
W_TIMEOUT = 2


@dataclass(frozen=True)
class NewRoundStepMessage:
    """Peer's current HRS (reference msgs: NewRoundStep, gossiped on the
    state channel every step change)."""

    height: int
    round: int
    step: int
    seconds_since_start_time: int
    last_commit_round: int


@dataclass(frozen=True)
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: tuple[int, bytes]
    block_parts: BitArray
    is_commit: bool


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal


@dataclass(frozen=True)
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote


@dataclass(frozen=True)
class VoteBatchMessage:
    """Several votes in one frame. Committee-scale gossip is dominated
    by per-message overhead (framing + four queue hops + a task wakeup
    per envelope); at 150 validators a height moves ~45k single-vote
    envelopes per node-neighborhood, and batching them 32:1 is the
    difference between a soak that converges and one that starves. The
    receiver splits the batch back into individual `add_vote` calls, so
    the SM/WAL path is unchanged."""

    votes: tuple


@dataclass(frozen=True)
class HasVoteMessage:
    height: int
    round: int
    type: SignedMsgType
    index: int


@dataclass(frozen=True)
class HasVoteBatchMessage:
    """Coalesced have-vote hints. The SM announces every added vote;
    at committee scale that is O(validators) broadcasts per height per
    node — pure advisory traffic — so the reactor buffers them briefly
    and ships one frame (see ConsensusReactor._flush_has_votes)."""

    entries: tuple  # of HasVoteMessage


@dataclass(frozen=True)
class VoteSetMaj23Message:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID


@dataclass(frozen=True)
class VoteSetBitsMessage:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID
    votes: BitArray


Message = (
    NewRoundStepMessage
    | NewValidBlockMessage
    | ProposalMessage
    | ProposalPOLMessage
    | BlockPartMessage
    | VoteMessage
    | VoteBatchMessage
    | HasVoteMessage
    | HasVoteBatchMessage
    | VoteSetMaj23Message
    | VoteSetBitsMessage
)

# batch frames are size-bounded at decode like every other wire field:
# a corrupt count must cost the sender its connection, not an allocation
MAX_BATCH_VOTES = 1024


# Wire-side sanity bounds. These messages arrive from untrusted peers
# and — under the chaos matrix — from CORRUPTED frames that still parse:
# a flipped byte in a varint can turn a 150-validator bit array into a
# 2^40-bit allocation request. Anything beyond these caps is malformed
# by construction (validator sets and part sets are orders of magnitude
# smaller), raises ValueError, and costs the sender its connection.
MAX_WIRE_BITS = 1 << 20  # vote-set / part-set bit arrays
MAX_WIRE_INDEX = 1 << 20  # has-vote validator indices


def _encode_has_vote_body(msg: "HasVoteMessage") -> bytes:
    return (
        pe.varint_field(1, msg.height)
        + pe.varint_field(2, msg.round)
        + pe.varint_field(3, int(msg.type))
        + pe.varint_field(4, msg.index + 1)
    )


def _decode_has_vote_body(body: bytes) -> "HasVoteMessage":
    br = pe.Reader(body)
    kw = dict(height=0, round=0, type=SignedMsgType.UNKNOWN, index=-1)
    while not br.eof():
        bf, bwt = br.read_tag()
        if bf == 1:
            kw["height"] = br.read_uvarint()
        elif bf == 2:
            kw["round"] = br.read_uvarint()
        elif bf == 3:
            kw["type"] = SignedMsgType(br.read_uvarint())
        elif bf == 4:
            kw["index"] = br.read_uvarint() - 1
        else:
            br.skip(bwt)
    if kw["index"] > MAX_WIRE_INDEX:
        raise ValueError(
            f"has-vote index {kw['index']} exceeds {MAX_WIRE_INDEX}"
        )
    return HasVoteMessage(**kw)


def _encode_bits(ba: BitArray) -> bytes:
    return pe.varint_field(1, len(ba)) + pe.bytes_field(2, ba.to_bytes())


def _decode_bits(data: bytes) -> BitArray:
    r = pe.Reader(data)
    n, raw = 0, b""
    while not r.eof():
        f, wt = r.read_tag()
        if f == 1:
            n = r.read_uvarint()
        elif f == 2:
            raw = r.read_bytes()
        else:
            r.skip(wt)
    if n > MAX_WIRE_BITS:
        raise ValueError(f"wire bit array of {n} bits exceeds {MAX_WIRE_BITS}")
    return BitArray.from_bytes(n, raw)


def encode_message_py(msg: Message) -> bytes:
    if isinstance(msg, NewRoundStepMessage):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round + 1)
            + pe.varint_field(3, msg.step)
            + pe.varint_field(4, msg.seconds_since_start_time)
            + pe.varint_field(5, msg.last_commit_round + 1)
        )
        return pe.message_field(T_NEW_ROUND_STEP, body)
    if isinstance(msg, NewValidBlockMessage):
        total, h = msg.block_part_set_header
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round)
            + pe.message_field(3, pe.varint_field(1, total) + pe.bytes_field(2, h))
            + pe.message_field(4, _encode_bits(msg.block_parts))
            + pe.varint_field(5, 1 if msg.is_commit else 0)
        )
        return pe.message_field(T_NEW_VALID_BLOCK, body)
    if isinstance(msg, ProposalMessage):
        return pe.message_field(T_PROPOSAL, msg.proposal.encode())
    if isinstance(msg, ProposalPOLMessage):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.proposal_pol_round)
            + pe.message_field(3, _encode_bits(msg.proposal_pol))
        )
        return pe.message_field(T_PROPOSAL_POL, body)
    if isinstance(msg, BlockPartMessage):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round)
            + pe.message_field(3, msg.part.encode())
        )
        return pe.message_field(T_BLOCK_PART, body)
    if isinstance(msg, VoteMessage):
        return pe.message_field(T_VOTE, msg.vote.encode())
    if isinstance(msg, VoteBatchMessage):
        body = b"".join(pe.bytes_field(1, v.encode()) for v in msg.votes)
        return pe.message_field(T_VOTE_BATCH, body)
    if isinstance(msg, HasVoteMessage):
        return pe.message_field(T_HAS_VOTE, _encode_has_vote_body(msg))
    if isinstance(msg, HasVoteBatchMessage):
        body = b"".join(
            pe.message_field(1, _encode_has_vote_body(e)) for e in msg.entries
        )
        return pe.message_field(T_HAS_VOTE_BATCH, body)
    if isinstance(msg, VoteSetMaj23Message):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round)
            + pe.varint_field(3, int(msg.type))
            + pe.message_field(4, msg.block_id.encode())
        )
        return pe.message_field(T_VOTE_SET_MAJ23, body)
    if isinstance(msg, VoteSetBitsMessage):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round)
            + pe.varint_field(3, int(msg.type))
            + pe.message_field(4, msg.block_id.encode())
            + pe.message_field(5, _encode_bits(msg.votes))
        )
        return pe.message_field(T_VOTE_SET_BITS, body)
    raise TypeError(f"unknown consensus message {type(msg)}")


def decode_message_py(data: bytes) -> Message:
    r = pe.Reader(data)
    f, wt = r.read_tag()
    body = r.read_bytes()
    if f == T_NEW_ROUND_STEP:
        br = pe.Reader(body)
        kw = dict(height=0, round=-1, step=0, seconds_since_start_time=0, last_commit_round=-1)
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                kw["height"] = br.read_uvarint()
            elif bf == 2:
                kw["round"] = br.read_uvarint() - 1
            elif bf == 3:
                kw["step"] = br.read_uvarint()
            elif bf == 4:
                kw["seconds_since_start_time"] = br.read_uvarint()
            elif bf == 5:
                kw["last_commit_round"] = br.read_uvarint() - 1
            else:
                br.skip(bwt)
        return NewRoundStepMessage(**kw)
    if f == T_NEW_VALID_BLOCK:
        br = pe.Reader(body)
        height = round_ = 0
        total, h = 0, b""
        bits = BitArray(0)
        is_commit = False
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                round_ = br.read_uvarint()
            elif bf == 3:
                hr = pe.Reader(br.read_bytes())
                while not hr.eof():
                    hf, hwt = hr.read_tag()
                    if hf == 1:
                        total = hr.read_uvarint()
                    elif hf == 2:
                        h = hr.read_bytes()
                    else:
                        hr.skip(hwt)
            elif bf == 4:
                bits = _decode_bits(br.read_bytes())
            elif bf == 5:
                is_commit = br.read_uvarint() == 1
            else:
                br.skip(bwt)
        return NewValidBlockMessage(height, round_, (total, h), bits, is_commit)
    if f == T_PROPOSAL:
        return ProposalMessage(Proposal.decode(body))
    if f == T_PROPOSAL_POL:
        br = pe.Reader(body)
        height = pol_round = 0
        bits = BitArray(0)
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                pol_round = br.read_uvarint()
            elif bf == 3:
                bits = _decode_bits(br.read_bytes())
            else:
                br.skip(bwt)
        return ProposalPOLMessage(height, pol_round, bits)
    if f == T_BLOCK_PART:
        br = pe.Reader(body)
        height = round_ = 0
        part = None
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                round_ = br.read_uvarint()
            elif bf == 3:
                part = Part.decode(br.read_bytes())
            else:
                br.skip(bwt)
        return BlockPartMessage(height, round_, part)
    if f == T_VOTE:
        return VoteMessage(Vote.decode(body))
    if f == T_VOTE_BATCH:
        br = pe.Reader(body)
        votes = []
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                votes.append(Vote.decode(br.read_bytes()))
                if len(votes) > MAX_BATCH_VOTES:
                    raise ValueError(
                        f"vote batch exceeds {MAX_BATCH_VOTES} votes"
                    )
            else:
                br.skip(bwt)
        return VoteBatchMessage(tuple(votes))
    if f == T_HAS_VOTE:
        return _decode_has_vote_body(body)
    if f == T_HAS_VOTE_BATCH:
        br = pe.Reader(body)
        entries = []
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                entries.append(_decode_has_vote_body(br.read_bytes()))
                if len(entries) > MAX_BATCH_VOTES:
                    raise ValueError(
                        f"has-vote batch exceeds {MAX_BATCH_VOTES} entries"
                    )
            else:
                br.skip(bwt)
        return HasVoteBatchMessage(tuple(entries))
    if f in (T_VOTE_SET_MAJ23, T_VOTE_SET_BITS):
        br = pe.Reader(body)
        height = round_ = 0
        type_ = SignedMsgType.UNKNOWN
        bid = NIL_BLOCK_ID
        bits = BitArray(0)
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                round_ = br.read_uvarint()
            elif bf == 3:
                type_ = SignedMsgType(br.read_uvarint())
            elif bf == 4:
                bid = BlockID.decode(br.read_bytes())
            elif bf == 5:
                bits = _decode_bits(br.read_bytes())
            else:
                br.skip(bwt)
        if f == T_VOTE_SET_MAJ23:
            return VoteSetMaj23Message(height, round_, type_, bid)
        return VoteSetBitsMessage(height, round_, type_, bid, bits)
    raise ValueError(f"unknown consensus message tag {f}")


# -- codec dispatch -------------------------------------------------------
# The reference binds `encode_message` / `decode_message` to a generated
# codec (its consensus/wire_gen.py, built by tools/wiregen) unless
# TMTPU_WIREGEN=0. Both of its codecs give the same bytes as the
# interpreted one above, which is the port's only codec until the
# generator is ported: TMTPU_WIREGEN is not read, and asking for the
# generated codec raises rather than silently keeping this one.

encode_message = encode_message_py
decode_message = decode_message_py


def use_wiregen(enabled: bool) -> bool:
    """`use_wiregen(False)` keeps the interpreted codec and returns False.
    `use_wiregen(True)` raises NotImplementedError: the generated codec
    waits for the port of tools/wiregen (ROADMAP item 17)."""
    if enabled:
        raise NotImplementedError(
            "the generated consensus codec (wire_gen.py) is not ported yet "
            "(ROADMAP item 17); the interpreted codec is the port's only one"
        )
    return False


def wiregen_active() -> bool:
    """True when gossip frames flow through the generated codec: never,
    in the port."""
    return encode_message is not encode_message_py


# -- WAL message wrapping -------------------------------------------------


def encode_wal_message(msg, peer_id: str = "") -> bytes:
    """MsgInfo{msg, peer} or TimeoutInfo → WAL payload (reference
    wal.go WALMessage union)."""
    if isinstance(msg, TimeoutInfo):
        body = (
            pe.varint_field(1, msg.duration_ns)
            + pe.varint_field(2, msg.height)
            + pe.varint_field(3, msg.round)
            + pe.varint_field(4, int(msg.step))
        )
        return pe.message_field(W_TIMEOUT, body)
    body = pe.bytes_field(1, encode_message(msg)) + pe.string_field(2, peer_id)
    return pe.message_field(W_MSG_INFO, body)


def decode_wal_message(data: bytes):
    """Returns (msg, peer_id) for MsgInfo or (TimeoutInfo, None)."""
    r = pe.Reader(data)
    f, wt = r.read_tag()
    body = r.read_bytes()
    if f == W_TIMEOUT:
        br = pe.Reader(body)
        dur = height = round_ = 0
        step = RoundStep.NEW_HEIGHT
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                dur = br.read_uvarint()
            elif bf == 2:
                height = br.read_uvarint()
            elif bf == 3:
                round_ = br.read_uvarint()
            elif bf == 4:
                step = RoundStep(br.read_uvarint())
            else:
                br.skip(bwt)
        return TimeoutInfo(dur, height, round_, step), None
    br = pe.Reader(body)
    raw, peer = b"", ""
    while not br.eof():
        bf, bwt = br.read_tag()
        if bf == 1:
            raw = br.read_bytes()
        elif bf == 2:
            peer = br.read_string()
        else:
            br.skip(bwt)
    return decode_message(raw), peer
