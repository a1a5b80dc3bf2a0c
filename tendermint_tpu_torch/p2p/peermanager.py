"""Peer up/down updates (the port's copy of `PeerStatus` and `PeerUpdate`
from tendermint_tpu/p2p/peermanager.py, reference
internal/p2p/peermanager.go): what reactors read from their
peer-updates queue. The peer manager itself waits for the p2p port."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .types import NodeID


class PeerStatus(str, Enum):
    UP = "up"
    DOWN = "down"


@dataclass(frozen=True)
class PeerUpdate:
    node_id: NodeID
    status: PeerStatus
