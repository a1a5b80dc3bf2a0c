"""ABCI request/response types (reference abci/types, proto/tendermint/abci).

The reference's 0.34-line ABCI surface: Info/InitChain/Query/CheckTx +
BeginBlock/DeliverTx/EndBlock/Commit + the four snapshot RPCs
(reference abci/types/application.go:11-31). Dataclasses instead of
generated protobuf; encode()/decode() (libs/protoenc) is the socket wire
format for out-of-process apps.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..libs import protoenc as pe


class CheckTxType(enum.IntEnum):
    NEW = 0
    RECHECK = 1


CODE_TYPE_OK = 0

# Wire-side sanity bounds. ABCI frames usually come from the node's own
# app, but the same decoders run over the remote-socket client AND over
# the state store's durable bytes (where chaos bit-rot applies): a
# corrupt repeat-count must raise ValueError, never allocate
# (tmtlint wire-bounds; the RouterNet corrupt-frame class).
MAX_WIRE_EVENTS = 1 << 16
MAX_WIRE_EVENT_ATTRS = 1 << 16


# --------------------------------------------------------------------------
# events (reference abci/types/types.pb.go Event/EventAttribute)


@dataclass(frozen=True)
class EventAttribute:
    key: str
    value: str
    index: bool = False

    def encode(self) -> bytes:
        return (
            pe.string_field(1, self.key)
            + pe.string_field(2, self.value)
            + pe.bool_field(3, self.index)
        )

    @classmethod
    def decode(cls, data: bytes) -> "EventAttribute":
        r = pe.Reader(data)
        key = value = ""
        index = False
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                key = r.read_bytes().decode()
            elif f == 2:
                value = r.read_bytes().decode()
            elif f == 3:
                index = bool(r.read_uvarint())
            else:
                r.skip(wt)
        return cls(key, value, index)


@dataclass(frozen=True)
class Event:
    type: str
    attributes: tuple[EventAttribute, ...] = ()

    def encode(self) -> bytes:
        out = pe.string_field(1, self.type)
        for a in self.attributes:
            out += pe.message_field(2, a.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Event":
        r = pe.Reader(data)
        type_ = ""
        attrs: list[EventAttribute] = []
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                type_ = r.read_bytes().decode()
            elif f == 2:
                attrs.append(EventAttribute.decode(r.read_bytes()))
                if len(attrs) > MAX_WIRE_EVENT_ATTRS:
                    raise ValueError(
                        f"event attributes exceed {MAX_WIRE_EVENT_ATTRS}"
                    )
            else:
                r.skip(wt)
        return cls(type_, tuple(attrs))


def _encode_events(first_field: int, events: tuple[Event, ...]) -> bytes:
    return b"".join(pe.message_field(first_field, e.encode()) for e in events)


# --------------------------------------------------------------------------
# validator types crossing the ABCI boundary


@dataclass(frozen=True)
class ValidatorUpdate:
    """App-requested validator-set change (reference abci ValidatorUpdate):
    power 0 removes the validator. bls12381 additions must carry `pop`
    (proof of possession) — aggregate-commit soundness requires every
    key in the set to have proven its secret, and validator updates are
    the only post-genesis entry point (state/execution enforces it)."""

    pub_key_type: str
    pub_key: bytes
    power: int
    pop: bytes = b""

    def encode(self) -> bytes:
        out = (
            pe.string_field(1, self.pub_key_type)
            + pe.bytes_field(2, self.pub_key)
            + pe.varint_field(3, self.power)
        )
        if self.pop:
            out += pe.bytes_field(4, self.pop)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorUpdate":
        r = pe.Reader(data)
        t, pk, power, pop = "ed25519", b"", 0, b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                t = r.read_bytes().decode()
            elif f == 2:
                pk = r.read_bytes()
            elif f == 3:
                power = r.read_uvarint()
            elif f == 4:
                pop = r.read_bytes()
            else:
                r.skip(wt)
        return cls(t, pk, power, pop)


@dataclass(frozen=True)
class VoteInfo:
    """Who signed the last commit (reference abci VoteInfo), fed to
    BeginBlock for fee distribution / liveness tracking."""

    validator_address: bytes
    power: int
    signed_last_block: bool

    def encode(self) -> bytes:
        return (
            pe.bytes_field(1, self.validator_address)
            + pe.varint_field(2, self.power)
            + pe.bool_field(3, self.signed_last_block)
        )

    @classmethod
    def decode(cls, data: bytes) -> "VoteInfo":
        r = pe.Reader(data)
        addr, power, signed = b"", 0, False
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                addr = r.read_bytes()
            elif f == 2:
                power = r.read_uvarint()
            elif f == 3:
                signed = bool(r.read_uvarint())
            else:
                r.skip(wt)
        return cls(addr, power, signed)


@dataclass(frozen=True)
class Misbehavior:
    """Byzantine-validator report to BeginBlock (reference abci Evidence)."""

    type: str  # "duplicate_vote" | "light_client_attack"
    validator_address: bytes
    power: int
    height: int
    time_ns: int
    total_voting_power: int

    def encode(self) -> bytes:
        return (
            pe.string_field(1, self.type)
            + pe.bytes_field(2, self.validator_address)
            + pe.varint_field(3, self.power)
            + pe.varint_field(4, self.height)
            + pe.varint_field(5, self.time_ns)
            + pe.varint_field(6, self.total_voting_power)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Misbehavior":
        r = pe.Reader(data)
        kw = dict(
            type="", validator_address=b"", power=0, height=0, time_ns=0,
            total_voting_power=0,
        )
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["type"] = r.read_bytes().decode()
            elif f == 2:
                kw["validator_address"] = r.read_bytes()
            elif f == 3:
                kw["power"] = r.read_uvarint()
            elif f == 4:
                kw["height"] = r.read_uvarint()
            elif f == 5:
                kw["time_ns"] = r.read_uvarint()
            elif f == 6:
                kw["total_voting_power"] = r.read_uvarint()
            else:
                r.skip(wt)
        return cls(**kw)


# --------------------------------------------------------------------------
# requests


@dataclass(frozen=True)
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass(frozen=True)
class RequestInitChain:
    time_ns: int
    chain_id: str
    consensus_params: object | None  # types.ConsensusParams
    validators: tuple[ValidatorUpdate, ...]
    app_state_bytes: bytes
    initial_height: int


@dataclass(frozen=True)
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass(frozen=True)
class RequestCheckTx:
    tx: bytes
    type: CheckTxType = CheckTxType.NEW


@dataclass(frozen=True)
class LastCommitInfo:
    round: int
    votes: tuple[VoteInfo, ...] = ()


@dataclass(frozen=True)
class RequestBeginBlock:
    hash: bytes
    header: object  # types.Header
    last_commit_info: LastCommitInfo
    byzantine_validators: tuple[Misbehavior, ...] = ()


@dataclass(frozen=True)
class RequestDeliverTx:
    tx: bytes


@dataclass(frozen=True)
class RequestEndBlock:
    height: int


@dataclass(frozen=True)
class Snapshot:
    """App snapshot advertisement (reference abci Snapshot)."""

    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""

    def encode(self) -> bytes:
        return (
            pe.varint_field(1, self.height)
            + pe.varint_field(2, self.format)
            + pe.varint_field(3, self.chunks)
            + pe.bytes_field(4, self.hash)
            + pe.bytes_field(5, self.metadata)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Snapshot":
        r = pe.Reader(data)
        kw = dict(height=0, format=0, chunks=0, hash=b"", metadata=b"")
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["height"] = r.read_uvarint()
            elif f == 2:
                kw["format"] = r.read_uvarint()
            elif f == 3:
                kw["chunks"] = r.read_uvarint()
            elif f == 4:
                kw["hash"] = r.read_bytes()
            elif f == 5:
                kw["metadata"] = r.read_bytes()
            else:
                r.skip(wt)
        return cls(**kw)


@dataclass(frozen=True)
class RequestOfferSnapshot:
    snapshot: Snapshot
    app_hash: bytes


@dataclass(frozen=True)
class RequestLoadSnapshotChunk:
    height: int
    format: int
    chunk: int


@dataclass(frozen=True)
class RequestApplySnapshotChunk:
    index: int
    chunk: bytes
    sender: str = ""


# --------------------------------------------------------------------------
# responses


@dataclass(frozen=True)
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass(frozen=True)
class ResponseInitChain:
    consensus_params: object | None = None
    validators: tuple[ValidatorUpdate, ...] = ()
    app_hash: bytes = b""


@dataclass(frozen=True)
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: tuple = ()
    height: int = 0
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple[Event, ...] = ()
    codespace: str = ""
    sender: str = ""
    priority: int = 0

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class ResponseBeginBlock:
    events: tuple[Event, ...] = ()


@dataclass(frozen=True)
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple[Event, ...] = ()
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        out = pe.varint_field(1, self.code)
        out += pe.bytes_field(2, self.data)
        out += pe.string_field(3, self.log)
        out += pe.varint_field(4, self.gas_wanted)
        out += pe.varint_field(5, self.gas_used)
        out += _encode_events(6, self.events)
        out += pe.string_field(7, self.codespace)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ResponseDeliverTx":
        r = pe.Reader(data)
        kw: dict = {}
        events: list[Event] = []
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["code"] = r.read_uvarint()
            elif f == 2:
                kw["data"] = r.read_bytes()
            elif f == 3:
                kw["log"] = r.read_bytes().decode()
            elif f == 4:
                kw["gas_wanted"] = r.read_uvarint()
            elif f == 5:
                kw["gas_used"] = r.read_uvarint()
            elif f == 6:
                events.append(Event.decode(r.read_bytes()))
                if len(events) > MAX_WIRE_EVENTS:
                    raise ValueError(
                        f"deliver-tx events exceed {MAX_WIRE_EVENTS}"
                    )
            elif f == 7:
                kw["codespace"] = r.read_bytes().decode()
            else:
                r.skip(wt)
        return cls(events=tuple(events), **kw)


@dataclass(frozen=True)
class ResponseEndBlock:
    validator_updates: tuple[ValidatorUpdate, ...] = ()
    consensus_param_updates: object | None = None
    events: tuple[Event, ...] = ()


@dataclass(frozen=True)
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass(frozen=True)
class ResponseListSnapshots:
    snapshots: tuple[Snapshot, ...] = ()


class OfferSnapshotResult(enum.IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


@dataclass(frozen=True)
class ResponseOfferSnapshot:
    result: OfferSnapshotResult = OfferSnapshotResult.UNKNOWN


@dataclass(frozen=True)
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


class ApplySnapshotChunkResult(enum.IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


@dataclass(frozen=True)
class ResponseApplySnapshotChunk:
    result: ApplySnapshotChunkResult = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: tuple[int, ...] = ()
    reject_senders: tuple[str, ...] = ()
