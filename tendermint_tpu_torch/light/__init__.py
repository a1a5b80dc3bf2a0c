"""Light client (reference light/; the port's copy of tendermint_tpu/light/):
verify headers against a trusted header using validator-set overlap
instead of replaying the chain. The stateless core verifier is
light/verifier.py; the stateful client with bisection, a pluggable
trusted store, and witness cross-checking is light/client.py; the
serving layer (LightD, hop proofs) is light/fleet.py and the lunatic
provider light/byzantine.py. The reference's proxy is not ported yet."""

from .types import LightBlock, SignedHeader

__all__ = ["LightBlock", "SignedHeader"]
