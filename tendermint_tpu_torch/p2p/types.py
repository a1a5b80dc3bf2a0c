"""P2P wire types (reference internal/p2p/router.go:28 Envelope,
types/node_id.go NodeID, types/node_info.go NodeInfo; the port's copy of
tendermint_tpu/p2p/types.py). `NodeInfo.encode` is byte-for-byte the
reference's protoenc frame, so a port node and a reference node can
handshake with each other."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protoenc as pe

# NodeID = lowercase hex of the 20-byte address of the node's ed25519
# pubkey (reference types/node_id.go, types/node_key.go)
NodeID = str


def node_id_from_pubkey(pub_key) -> NodeID:
    return pub_key.address().hex()


@dataclass(frozen=True)
class NodeAddress:
    """tcp://nodeid@host:port or memory:nodeid (reference
    internal/p2p/address.go)."""

    node_id: NodeID
    protocol: str = "tcp"
    host: str = ""
    port: int = 0

    def __str__(self) -> str:
        if self.protocol == "memory":
            return f"memory:{self.node_id}"
        return f"{self.protocol}://{self.node_id}@{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "NodeAddress":
        if s.startswith("memory:"):
            return cls(node_id=s[len("memory:"):], protocol="memory")
        proto, rest = s.split("://", 1)
        if "@" not in rest:
            raise ValueError(f"address {s!r} missing node id")
        nid, hostport = rest.split("@", 1)
        host, _, port = hostport.rpartition(":")
        return cls(node_id=nid.lower(), protocol=proto, host=host, port=int(port))

    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass(frozen=True)
class NodeInfo:
    """Exchanged during the connection handshake (reference
    types/node_info.go)."""

    node_id: NodeID
    network: str  # chain id
    listen_addr: str = ""
    version: str = "0.1.0"
    channels: bytes = b""  # supported channel ids, one byte each
    moniker: str = ""

    def encode(self) -> bytes:
        return (
            pe.string_field(1, self.node_id)
            + pe.string_field(2, self.network)
            + pe.string_field(3, self.listen_addr)
            + pe.string_field(4, self.version)
            + pe.bytes_field(5, self.channels)
            + pe.string_field(6, self.moniker)
        )

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        r = pe.Reader(data)
        kw = dict(node_id="", network="", listen_addr="", version="", channels=b"", moniker="")
        fields = {1: "node_id", 2: "network", 3: "listen_addr", 4: "version", 6: "moniker"}
        while not r.eof():
            f, wt = r.read_tag()
            if f in fields:
                kw[fields[f]] = r.read_string()
            elif f == 5:
                kw["channels"] = r.read_bytes()
            else:
                r.skip(wt)
        return cls(**kw)

    def compatible_with(self, other: "NodeInfo") -> str | None:
        """None if compatible, else the reason (reference
        node_info.go CompatibleWith)."""
        if self.network != other.network:
            return f"network mismatch: {self.network} != {other.network}"
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                return "no common channels"
        return None


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
