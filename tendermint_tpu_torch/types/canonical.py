"""Canonical vote and proposal sign-bytes (the port's copy of
tendermint_tpu/types/canonical.py).

The bytes a validator signs must be identical across every implementation
that ever validates them, so they are built with the deterministic encoder.
Height and round are sfixed64, as in the reference (types/canonical.go:56).

  CanonicalVote: 1 type (varint), 2 height (sfixed64), 3 round (sfixed64),
                 4 block_id (msg), 5 timestamp (msg), 6 chain_id (string)
  CanonicalProposal: as the vote, with 4 pol_round (sfixed64), so that
                 block_id is 5, timestamp 6 and chain_id 7
  CanonicalBlockID: 1 hash (bytes), 2 part_set_header (msg)
  CanonicalPartSetHeader: 1 total (varint), 2 hash (bytes)
  Timestamp: 1 seconds (varint), 2 nanos (varint)

The result is length-prefixed.
"""

from __future__ import annotations

from ..libs import protoenc as pe
from .keys import SignedMsgType

NANOS = 1_000_000_000


def encode_timestamp(ns: int) -> bytes:
    seconds, nanos = divmod(ns, NANOS)
    return pe.varint_field(1, seconds) + pe.varint_field(2, nanos)


def encode_canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return pe.varint_field(1, total) + pe.bytes_field(2, hash_)


def encode_canonical_block_id(block_id) -> bytes | None:
    """None for nil/absent block IDs (field omitted entirely)."""
    if block_id is None or block_id.is_nil():
        return None
    return pe.bytes_field(1, block_id.hash) + pe.message_field(
        2,
        encode_canonical_part_set_header(
            block_id.part_set_header.total, block_id.part_set_header.hash
        ),
    )


def vote_sign_bytes(
    chain_id: str,
    msg_type: SignedMsgType,
    height: int,
    round_: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    out = pe.varint_field(1, int(msg_type))
    out += pe.sfixed64_field(2, height)
    out += pe.sfixed64_field(3, round_)
    cbid = encode_canonical_block_id(block_id)
    if cbid is not None:
        out += pe.message_field(4, cbid)
    out += pe.message_field(5, encode_timestamp(timestamp_ns))
    out += pe.string_field(6, chain_id)
    return pe.len_prefixed(out)


def strip_timestamp(sign_bytes: bytes, field: int = 5) -> tuple[bytes, int]:
    """Canonical sign-bytes with the timestamp field removed (field 5 for
    votes, 6 for proposals); returns (stripped, timestamp_ns). Used by
    privval to allow re-signing messages that differ only in their
    timestamp (reference privval/file.go
    checkVotesOnlyDifferByTimestamp)."""
    r = pe.Reader(sign_bytes)
    inner = pe.Reader(r.read_bytes())  # drop the length prefix
    out = b""
    ts_ns = 0
    while not inner.eof():
        start = inner.pos
        f, wt = inner.read_tag()
        if f == field:
            tr = pe.Reader(inner.read_bytes())
            seconds = nanos = 0
            while not tr.eof():
                tf, twt = tr.read_tag()
                if tf == 1:
                    seconds = tr.read_uvarint()
                elif tf == 2:
                    nanos = tr.read_uvarint()
                else:
                    tr.skip(twt)
            ts_ns = seconds * NANOS + nanos
            continue
        inner.skip(wt)
        out += inner.data[start : inner.pos]
    return out, ts_ns


def proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    out = pe.varint_field(1, int(SignedMsgType.PROPOSAL))
    out += pe.sfixed64_field(2, height)
    out += pe.sfixed64_field(3, round_)
    out += pe.sfixed64_field(4, pol_round if pol_round >= 0 else -1)
    cbid = encode_canonical_block_id(block_id)
    if cbid is not None:
        out += pe.message_field(5, cbid)
    out += pe.message_field(6, encode_timestamp(timestamp_ns))
    out += pe.string_field(7, chain_id)
    return pe.len_prefixed(out)
