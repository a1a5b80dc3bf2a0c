"""P2P stack — the distributed communication backend (reference
internal/p2p/; the port's copy of tendermint_tpu/p2p/).

Reactors hold `Channel` handles; a `Router` (router.py) moves `Envelope`s
between per-peer connections and per-reactor channels; a `Transport`
abstracts the wire: in-memory (memory.py) for in-process nets, TCP or a
Unix socket with the secret connection (tcp.py, secret.py) between
processes. The peer manager (peermanager.py) owns dialing, scores and
bans; PEX (pex.py) and the address book (addrbook.py) spread and keep
addresses. The wire bytes are the reference's, so port and reference
nodes interoperate."""

from .types import (
    Envelope,
    NodeAddress,
    NodeID,
    NodeInfo,
    PeerError,
    node_id_from_pubkey,
)

__all__ = [
    "Envelope",
    "NodeAddress",
    "NodeID",
    "NodeInfo",
    "PeerError",
    "node_id_from_pubkey",
]
