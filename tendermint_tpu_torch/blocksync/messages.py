"""Blocksync wire messages (reference proto/tendermint/blocksync)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protoenc as pe
from ..types.block import Block

T_BLOCK_REQUEST = 1
T_NO_BLOCK_RESPONSE = 2
T_BLOCK_RESPONSE = 3
T_STATUS_REQUEST = 4
T_STATUS_RESPONSE = 5


@dataclass(frozen=True)
class BlockRequest:
    height: int


@dataclass(frozen=True)
class NoBlockResponse:
    height: int


@dataclass(frozen=True)
class BlockResponse:
    block: Block


@dataclass(frozen=True)
class StatusRequest:
    pass


@dataclass(frozen=True)
class StatusResponse:
    height: int
    base: int


Message = BlockRequest | NoBlockResponse | BlockResponse | StatusRequest | StatusResponse


def encode_message(msg: Message) -> bytes:
    if isinstance(msg, BlockRequest):
        return pe.message_field(T_BLOCK_REQUEST, pe.varint_field(1, msg.height))
    if isinstance(msg, NoBlockResponse):
        return pe.message_field(T_NO_BLOCK_RESPONSE, pe.varint_field(1, msg.height))
    if isinstance(msg, BlockResponse):
        return pe.message_field(T_BLOCK_RESPONSE, msg.block.encode())
    if isinstance(msg, StatusRequest):
        return pe.message_field(T_STATUS_REQUEST, b"")
    if isinstance(msg, StatusResponse):
        return pe.message_field(
            T_STATUS_RESPONSE,
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.base),
        )
    raise TypeError(f"unknown blocksync message {type(msg)}")


def decode_message(data: bytes) -> Message:
    r = pe.Reader(data)
    f, _wt = r.read_tag()
    body = r.read_bytes()
    if f == T_BLOCK_REQUEST or f == T_NO_BLOCK_RESPONSE:
        br = pe.Reader(body)
        height = 0
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            else:
                br.skip(bwt)
        return BlockRequest(height) if f == T_BLOCK_REQUEST else NoBlockResponse(height)
    if f == T_BLOCK_RESPONSE:
        return BlockResponse(Block.decode(body))
    if f == T_STATUS_REQUEST:
        return StatusRequest()
    if f == T_STATUS_RESPONSE:
        br = pe.Reader(body)
        height = base = 0
        while not br.eof():
            bf, bwt = br.read_tag()
            if bf == 1:
                height = br.read_uvarint()
            elif bf == 2:
                base = br.read_uvarint()
            else:
                br.skip(bwt)
        return StatusResponse(height, base)
    raise ValueError(f"unknown blocksync tag {f}")
