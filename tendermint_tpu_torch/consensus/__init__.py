"""Consensus layer (reference internal/consensus/): the port has the ABCI
handshake (replay.py) so far; the state machine, the WAL and its repair
wait for the consensus port."""

from .replay import AppHashMismatchError, Handshaker, HandshakeError

__all__ = ["AppHashMismatchError", "Handshaker", "HandshakeError"]
