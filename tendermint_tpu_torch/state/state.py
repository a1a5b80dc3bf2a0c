"""Consensus state snapshot (reference internal/state/state.go:66).

`State` is the deterministic function of the applied block chain: heights,
the three validator-set views (last/current/next), consensus params, and
the latest app hash / results hash. It is immutable — ApplyBlock returns a
new State."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..libs import protoenc as pe
from ..types.block import Block, BlockID, Commit, Header
from ..types.block import txs_hash
from ..types.evidence import evidence_hash
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet

# version of the state-machine replication protocol spoken on the wire
BLOCK_PROTOCOL_VERSION = 11


@dataclass(frozen=True)
class State:
    chain_id: str
    initial_height: int

    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0

    # validators for height last_block_height+1 (who vote on the next block)
    validators: ValidatorSet | None = None
    # validators for height last_block_height+2
    next_validators: ValidatorSet | None = None
    # validators who signed last_block's commit (height last_block_height)
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def is_empty(self) -> bool:
        return self.validators is None

    def copy(self, **kwargs) -> "State":
        return replace(self, **kwargs)

    def make_block(
        self,
        height: int,
        txs: tuple[bytes, ...],
        last_commit: Commit | None,
        evidence: tuple,
        proposer_address: bytes,
        time_ns: int,
    ) -> Block:
        """Build the proposal block for `height` on top of this state
        (reference internal/state/state.go MakeBlock)."""
        header = Header(
            version=BLOCK_PROTOCOL_VERSION,
            chain_id=self.chain_id,
            height=height,
            time_ns=time_ns,
            last_block_id=self.last_block_id,
            last_commit_hash=last_commit.hash() if last_commit else b"",
            data_hash=txs_hash(txs),
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=evidence_hash(evidence),
            proposer_address=proposer_address,
        )
        return Block(header, txs, evidence, last_commit)

    # -- serialization ---------------------------------------------------

    def encode(self) -> bytes:
        out = pe.string_field(1, self.chain_id)
        out += pe.varint_field(2, self.initial_height)
        out += pe.varint_field(3, self.last_block_height)
        out += pe.message_field(4, self.last_block_id.encode())
        out += pe.varint_field(5, self.last_block_time_ns)
        if self.validators is not None:
            out += pe.message_field(6, self.validators.encode())
        if self.next_validators is not None:
            out += pe.message_field(7, self.next_validators.encode())
        if self.last_validators is not None and len(self.last_validators):
            out += pe.message_field(8, self.last_validators.encode())
        out += pe.varint_field(9, self.last_height_validators_changed)
        out += pe.message_field(10, self.consensus_params.encode())
        out += pe.varint_field(11, self.last_height_consensus_params_changed)
        out += pe.bytes_field(12, self.last_results_hash)
        out += pe.bytes_field(13, self.app_hash)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "State":
        r = pe.Reader(data)
        kw: dict = {"chain_id": "", "initial_height": 1}
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["chain_id"] = r.read_bytes().decode()
            elif f == 2:
                kw["initial_height"] = r.read_uvarint()
            elif f == 3:
                kw["last_block_height"] = r.read_uvarint()
            elif f == 4:
                kw["last_block_id"] = BlockID.decode(r.read_bytes())
            elif f == 5:
                kw["last_block_time_ns"] = r.read_uvarint()
            elif f == 6:
                kw["validators"] = ValidatorSet.decode(r.read_bytes())
            elif f == 7:
                kw["next_validators"] = ValidatorSet.decode(r.read_bytes())
            elif f == 8:
                kw["last_validators"] = ValidatorSet.decode(r.read_bytes())
            elif f == 9:
                kw["last_height_validators_changed"] = r.read_uvarint()
            elif f == 10:
                kw["consensus_params"] = ConsensusParams.decode(r.read_bytes())
            elif f == 11:
                kw["last_height_consensus_params_changed"] = r.read_uvarint()
            elif f == 12:
                kw["last_results_hash"] = r.read_bytes()
            elif f == 13:
                kw["app_hash"] = r.read_bytes()
            else:
                r.skip(wt)
        if "last_validators" not in kw:
            kw["last_validators"] = ValidatorSet([])
        return cls(**kw)


def state_from_genesis(doc: GenesisDoc) -> State:
    """Initial State before InitChain (reference state.go MakeGenesisState)."""
    doc.validate_basic()
    vals = doc.validator_set()
    return State(
        chain_id=doc.chain_id,
        initial_height=doc.initial_height,
        last_block_height=0,
        last_block_time_ns=doc.genesis_time_ns,
        validators=vals,
        next_validators=vals.copy_increment_proposer_priority(1),
        last_validators=ValidatorSet([]),
        last_height_validators_changed=doc.initial_height,
        consensus_params=doc.consensus_params,
        last_height_consensus_params_changed=doc.initial_height,
        app_hash=doc.app_hash,
    )
