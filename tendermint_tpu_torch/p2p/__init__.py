"""The pieces of the p2p stack that the block-sync reactor touches (the
port's copy of parts of tendermint_tpu/p2p/): `Envelope` and `PeerError`
(types.py), `PeerStatus`/`PeerUpdate` (peermanager.py) and the
reactor-facing `Channel` (router.py). The Router, the transports and the
peer manager wait for the p2p port."""

from .types import Envelope, NodeID, PeerError

__all__ = ["Envelope", "NodeID", "PeerError"]
