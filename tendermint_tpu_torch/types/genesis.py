"""Genesis document (reference types/genesis.go) — JSON, human-editable.
The port's copy of tendermint_tpu/types/genesis.py."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .. import crypto
from ..crypto.hashes import sha256
from .params import ConsensusParams, BlockParams, EvidenceParams, ValidatorParams
from .validator_set import Validator


@dataclass
class GenesisValidator:
    pub_key: crypto.PubKey
    power: int
    name: str = ""
    # bls12381 validators MUST carry a proof of possession (a signature
    # over the pubkey bytes under the POP domain tag): aggregate-commit
    # positions are only sound against rogue-key attacks when every
    # aggregated key proved knowledge of its secret. Checked at
    # validator-set construction, not per verification.
    pop: bytes = b""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validator_set(self):
        from .validator_set import ValidatorSet

        self._check_pops()
        return ValidatorSet(
            [Validator(gv.pub_key, gv.power) for gv in self.validators]
        )

    def _check_pops(self) -> None:
        """Rogue-key defense: every bls12381 genesis validator must
        prove possession of its secret key before the set is
        constructed — an unproven key in an aggregate position could be
        a rogue-key combination of honest keys. (Per-validator verify
        results are memoized in crypto/bls, so multi-node in-process
        tests pay the pairing once per key.)"""
        for gv in self.validators:
            if gv.pub_key.TYPE != "bls12381":
                continue
            if not gv.pop:
                raise ValueError(
                    f"bls12381 genesis validator {gv.name or gv.pub_key!r} "
                    "missing proof of possession"
                )
            if not gv.pub_key.pop_verify(gv.pop):
                raise ValueError(
                    f"bls12381 genesis validator {gv.name or gv.pub_key!r} "
                    "has an invalid proof of possession"
                )

    def validate_basic(self) -> None:
        if not self.chain_id or len(self.chain_id) > 50:
            raise ValueError("bad chain id")
        if self.initial_height < 1:
            raise ValueError("initial height must be >= 1")
        self.consensus_params.validate_basic()
        for gv in self.validators:
            if gv.power <= 0:
                raise ValueError("genesis validator with non-positive power")
        self._check_pops()

    def to_json(self) -> str:
        return json.dumps(
            {
                "chain_id": self.chain_id,
                "genesis_time_ns": self.genesis_time_ns,
                "initial_height": self.initial_height,
                "consensus_params": {
                    "block": {
                        "max_bytes": self.consensus_params.block.max_bytes,
                        "max_gas": self.consensus_params.block.max_gas,
                    },
                    "evidence": {
                        "max_age_num_blocks": self.consensus_params.evidence.max_age_num_blocks,
                        "max_age_duration_ns": self.consensus_params.evidence.max_age_duration_ns,
                        "max_bytes": self.consensus_params.evidence.max_bytes,
                    },
                    "validator": {
                        "pub_key_types": list(
                            self.consensus_params.validator.pub_key_types
                        )
                    },
                },
                "validators": [
                    {
                        "pub_key_type": gv.pub_key.TYPE,
                        "pub_key": gv.pub_key.bytes().hex(),
                        "power": gv.power,
                        "name": gv.name,
                        **({"pop": gv.pop.hex()} if gv.pop else {}),
                    }
                    for gv in self.validators
                ],
                "app_hash": self.app_hash.hex(),
                "app_state": self.app_state.decode(),
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "GenesisDoc":
        d = json.loads(text)
        cp = d.get("consensus_params", {})
        params = ConsensusParams(
            block=BlockParams(**cp.get("block", {})),
            evidence=EvidenceParams(**cp.get("evidence", {})),
            validator=ValidatorParams(
                pub_key_types=tuple(
                    cp.get("validator", {}).get("pub_key_types", ("ed25519",))
                )
            ),
        )
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time_ns=d.get("genesis_time_ns", 0),
            initial_height=d.get("initial_height", 1),
            consensus_params=params,
            validators=[
                GenesisValidator(
                    crypto.pubkey_from_type_and_bytes(
                        v.get("pub_key_type", "ed25519"), bytes.fromhex(v["pub_key"])
                    ),
                    v["power"],
                    v.get("name", ""),
                    bytes.fromhex(v.get("pop", "")),
                )
                for v in d.get("validators", [])
            ],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state", "{}").encode(),
        )
        doc.validate_basic()
        return doc

    def hash(self) -> bytes:
        return sha256(self.to_json().encode())  # tmtlint: allow[hash-chokepoint] -- genesis doc hashes once at startup, cold by definition
