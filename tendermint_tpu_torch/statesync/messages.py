"""Statesync wire messages (the port's copy of
tendermint_tpu/statesync/messages.py; reference proto/tendermint/statesync).

Decode-bound discipline: every length-delimited field and repeated
decode loop is clamped by a named MAX_* below — a peer-supplied frame can
never allocate unbounded memory before validation sees it. Every message
encodes to the reference's bytes (tests/test_torch_statesync.py)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protoenc as pe
from ..light.types import LightBlock
from ..types.params import ConsensusParams

T_SNAPSHOTS_REQUEST = 1
T_SNAPSHOTS_RESPONSE = 2
T_CHUNK_REQUEST = 3
T_CHUNK_RESPONSE = 4
T_LIGHT_BLOCK_REQUEST = 5
T_LIGHT_BLOCK_RESPONSE = 6
T_PARAMS_REQUEST = 7
T_PARAMS_RESPONSE = 8
T_LIGHT_BLOCK_BATCH_REQUEST = 9
T_LIGHT_BLOCK_BATCH_RESPONSE = 10

#: a snapshot's claimed chunk COUNT drives the joiner's fetch loop
#: (reference MaxChunkCount e2e shape) — a lying donor must not be able
#: to schedule millions of fetches from one 10-byte frame
MAX_WIRE_SNAPSHOT_CHUNKS = 1 << 16
#: snapshot hashes are digest-sized; metadata is app-defined but small
#: (the kvstore app ships none)
MAX_WIRE_SNAPSHOT_HASH = 128
MAX_WIRE_SNAPSHOT_METADATA = 1 << 16
#: one chunk's payload (reference p2p chunk msgs cap at 16 MiB)
MAX_WIRE_CHUNK = 16 << 20
#: light blocks per backfill batch response — the hub backfill-lane
#: verification window; a donor can serve fewer, never more
MAX_WIRE_BACKFILL_BATCH = 64


@dataclass(frozen=True)
class SnapshotsRequest:
    pass


@dataclass(frozen=True)
class SnapshotsResponse:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


@dataclass(frozen=True)
class ChunkRequest:
    height: int
    format: int
    index: int


@dataclass(frozen=True)
class ChunkResponse:
    height: int
    format: int
    index: int
    chunk: bytes = b""
    missing: bool = False
    #: the donor's BootD shed this request at its session bound —
    #: backpressure, not failure: retry the SAME donor after backoff
    #: (a busy donor still HAS the chunk; `missing` would wrongly
    #: steer the fetcher away from it)
    busy: bool = False


@dataclass(frozen=True)
class LightBlockRequest:
    height: int


@dataclass(frozen=True)
class LightBlockResponse:
    light_block: LightBlock | None  # None = don't have it


@dataclass(frozen=True)
class LightBlockBatchRequest:
    """Backfill window fetch: light blocks for heights
    [from_height - count + 1, from_height], newest first — one frame
    per verification batch instead of one per height."""

    from_height: int
    count: int


@dataclass(frozen=True)
class LightBlockBatchResponse:
    """Consecutive light blocks, descending from the requested
    `from_height`; a donor missing part of the window serves the
    prefix it has (possibly empty)."""

    light_blocks: tuple[LightBlock, ...] = ()


@dataclass(frozen=True)
class ParamsRequest:
    height: int


@dataclass(frozen=True)
class ParamsResponse:
    height: int
    params: ConsensusParams | None


Message = (
    SnapshotsRequest
    | SnapshotsResponse
    | ChunkRequest
    | ChunkResponse
    | LightBlockRequest
    | LightBlockResponse
    | LightBlockBatchRequest
    | LightBlockBatchResponse
    | ParamsRequest
    | ParamsResponse
)


def encode_message(msg: Message) -> bytes:
    if isinstance(msg, SnapshotsRequest):
        return pe.message_field(T_SNAPSHOTS_REQUEST, b"")
    if isinstance(msg, SnapshotsResponse):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.chunks)
            + pe.bytes_field(4, msg.hash)
            + pe.bytes_field(5, msg.metadata)
        )
        return pe.message_field(T_SNAPSHOTS_RESPONSE, body)
    if isinstance(msg, ChunkRequest):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.index)
        )
        return pe.message_field(T_CHUNK_REQUEST, body)
    if isinstance(msg, ChunkResponse):
        body = (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.index)
            + pe.bytes_field(4, msg.chunk)
            + pe.varint_field(5, 1 if msg.missing else 0)
            + pe.varint_field(6, 1 if msg.busy else 0)
        )
        return pe.message_field(T_CHUNK_RESPONSE, body)
    if isinstance(msg, LightBlockRequest):
        return pe.message_field(T_LIGHT_BLOCK_REQUEST, pe.varint_field(1, msg.height))
    if isinstance(msg, LightBlockBatchRequest):
        body = pe.varint_field(1, msg.from_height) + pe.varint_field(2, msg.count)
        return pe.message_field(T_LIGHT_BLOCK_BATCH_REQUEST, body)
    if isinstance(msg, LightBlockBatchResponse):
        body = b"".join(
            pe.message_field(1, lb.encode()) for lb in msg.light_blocks
        )
        return pe.message_field(T_LIGHT_BLOCK_BATCH_RESPONSE, body)
    if isinstance(msg, LightBlockResponse):
        body = b""
        if msg.light_block is not None:
            body = pe.message_field(1, msg.light_block.encode())
        return pe.message_field(T_LIGHT_BLOCK_RESPONSE, body)
    if isinstance(msg, ParamsRequest):
        return pe.message_field(T_PARAMS_REQUEST, pe.varint_field(1, msg.height))
    if isinstance(msg, ParamsResponse):
        body = pe.varint_field(1, msg.height)
        if msg.params is not None:
            body += pe.message_field(2, msg.params.encode())
        return pe.message_field(T_PARAMS_RESPONSE, body)
    raise TypeError(f"unknown statesync message {type(msg)}")


def decode_message(data: bytes) -> Message:
    r = pe.Reader(data)
    f, _wt = r.read_tag()
    body = r.read_bytes()
    br = pe.Reader(body)
    if f == T_SNAPSHOTS_REQUEST:
        return SnapshotsRequest()
    if f == T_SNAPSHOTS_RESPONSE:
        height = fmt = chunks = 0
        hash_ = metadata = b""
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                fmt = br.read_uvarint()
            elif bf == 3:
                chunks = br.read_uvarint()
                if chunks > MAX_WIRE_SNAPSHOT_CHUNKS:
                    raise ValueError(
                        f"snapshot chunk count {chunks} exceeds "
                        f"{MAX_WIRE_SNAPSHOT_CHUNKS}"
                    )
            elif bf == 4:
                hash_ = br.read_bytes()
                if len(hash_) > MAX_WIRE_SNAPSHOT_HASH:
                    raise ValueError(
                        f"snapshot hash of {len(hash_)} bytes exceeds "
                        f"{MAX_WIRE_SNAPSHOT_HASH}"
                    )
            elif bf == 5:
                metadata = br.read_bytes()
                if len(metadata) > MAX_WIRE_SNAPSHOT_METADATA:
                    raise ValueError(
                        f"snapshot metadata of {len(metadata)} bytes exceeds "
                        f"{MAX_WIRE_SNAPSHOT_METADATA}"
                    )
            else:
                br.skip(bwt)
        return SnapshotsResponse(height, fmt, chunks, hash_, metadata)
    if f in (T_CHUNK_REQUEST, T_CHUNK_RESPONSE):
        height = fmt = index = 0
        chunk = b""
        missing = busy = False
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                fmt = br.read_uvarint()
            elif bf == 3:
                index = br.read_uvarint()
            elif bf == 4:
                chunk = br.read_bytes()
                if len(chunk) > MAX_WIRE_CHUNK:
                    raise ValueError(
                        f"snapshot chunk of {len(chunk)} bytes exceeds "
                        f"{MAX_WIRE_CHUNK}"
                    )
            elif bf == 5:
                missing = br.read_uvarint() == 1
            elif bf == 6:
                busy = br.read_uvarint() == 1
            else:
                br.skip(bwt)
        if f == T_CHUNK_REQUEST:
            return ChunkRequest(height, fmt, index)
        return ChunkResponse(height, fmt, index, chunk, missing, busy)
    if f == T_LIGHT_BLOCK_REQUEST:
        height = 0
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            else:
                br.skip(bwt)
        return LightBlockRequest(height)
    if f == T_LIGHT_BLOCK_RESPONSE:
        lb = None
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                lb = LightBlock.decode(br.read_bytes())
            else:
                br.skip(bwt)
        return LightBlockResponse(lb)
    if f == T_LIGHT_BLOCK_BATCH_REQUEST:
        from_height = count = 0
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                from_height = br.read_uvarint()
            elif bf == 2:
                count = br.read_uvarint()
                if count > MAX_WIRE_BACKFILL_BATCH:
                    raise ValueError(
                        f"backfill batch request of {count} exceeds "
                        f"{MAX_WIRE_BACKFILL_BATCH}"
                    )
            else:
                br.skip(bwt)
        return LightBlockBatchRequest(from_height, count)
    if f == T_LIGHT_BLOCK_BATCH_RESPONSE:
        lbs: list[LightBlock] = []
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                if len(lbs) >= MAX_WIRE_BACKFILL_BATCH:
                    raise ValueError(
                        f"backfill batch exceeds {MAX_WIRE_BACKFILL_BATCH} "
                        "light blocks"
                    )
                lbs.append(LightBlock.decode(br.read_bytes()))
            else:
                br.skip(bwt)
        return LightBlockBatchResponse(tuple(lbs))
    if f == T_PARAMS_REQUEST:
        height = 0
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            else:
                br.skip(bwt)
        return ParamsRequest(height)
    if f == T_PARAMS_RESPONSE:
        height = 0
        params = None
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                params = ConsensusParams.decode(br.read_bytes())
            else:
                br.skip(bwt)
        return ParamsResponse(height, params)
    raise ValueError(f"unknown statesync tag {f}")
