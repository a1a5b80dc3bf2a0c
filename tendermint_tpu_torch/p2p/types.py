"""P2P wire types (reference internal/p2p/router.go:28 Envelope,
types/node_id.go NodeID; the port's copy of `NodeID`, `Envelope` and
`PeerError` from tendermint_tpu/p2p/types.py). NodeAddress and NodeInfo
wait for the p2p port."""

from __future__ import annotations

from dataclasses import dataclass

# NodeID = lowercase hex of the 20-byte address of the node's ed25519
# pubkey (reference types/node_id.go, types/node_key.go)
NodeID = str


@dataclass(frozen=True)
class Envelope:
    """A routed message (reference router.go:28). Exactly one of
    `to`/`broadcast` is set on outbound envelopes; `from_` is set on
    inbound ones. `message` is the decoded reactor message; `raw` carries
    the wire bytes."""

    channel_id: int
    message: object = None
    raw: bytes = b""
    from_: NodeID = ""
    to: NodeID = ""
    broadcast: bool = False
    # monotonic stamp taken by the router as the bytes came off the
    # wire (libs/trace flight recorder: the "gossip byte" edge of an
    # end-to-end span). 0.0 when tracing is disabled.
    recv_at: float = 0.0


@dataclass(frozen=True)
class PeerError(Exception):
    """Reported by reactors to evict/penalize a peer (reference
    router.go:54)."""

    node_id: NodeID
    err: str
    fatal: bool = True  # fatal errors disconnect the peer
    # ban=True promotes the error into the peer manager's dial
    # quarantine (escalating cooldown) — e.g. blocksync's
    # repeated-request-timeout bans, so a persistently bad peer stops
    # being redialed instead of bouncing through pool-local bans forever
    ban: bool = False
