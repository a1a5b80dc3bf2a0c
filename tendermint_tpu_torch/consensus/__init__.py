"""Consensus layer (reference internal/consensus/; the port's copy of
tendermint_tpu/consensus/): the state machine, its vote sets, WAL,
ticker, pipelined ingest and reactor, and the ABCI handshake."""

from .replay import AppHashMismatchError, Handshaker, HandshakeError
from .wal import WAL, WALRecord, KIND_END_HEIGHT, KIND_MESSAGE

__all__ = [
    "AppHashMismatchError",
    "Handshaker",
    "HandshakeError",
    "WAL",
    "WALRecord",
    "KIND_END_HEIGHT",
    "KIND_MESSAGE",
]
