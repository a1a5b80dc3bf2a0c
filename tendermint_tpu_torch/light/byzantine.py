"""Light-client attack injection — the lunatic provider strategy (the
port's copy of tendermint_tpu/light/byzantine.py).

`consensus/byzantine.py` made validators lie on the consensus wire;
this module makes a *provider* lie to light clients: a `LunaticProvider`
wraps an honest provider and, at seeded attack heights, serves a FORGED
light block — a header whose state-derived fields (app_hash, and the
claimed validator set) are fabricated, signed for real by a colluding
subset of the actual committee (the classic lunatic light-client
attack: the attackers reuse their genuine keys out of band, so the
forged commit passes every signature check and only the witness
cross-check can catch it).

Like the consensus strategy layer, every decision is a pure function of
(seed, height) — never arrival order or wall time — so two same-seed
attack runs serve bit-identical forged blocks and the formed
`LightClientAttackEvidence` bytes are reproducible. And like it, the
module is QUARANTINED: no production module of the package imports it
(tests/test_torch_light_fleet.py checks the import graph in a fresh
interpreter); only tests and chip_smoke.py name it — production wiring
holding validator keys must be structurally unable to sign a forged
header.

The construction (what honest verification sees):

  * the forged header copies the real header at the attack height
    (time, chain id, last_block_id) but fabricates app_hash — a
    state-derived field, so `conflicting_header_is_invalid` classifies
    the attack as lunatic and attribution lands on every common-set
    validator that signed it;
  * it claims a validator set consisting of exactly the colluding
    subset, whose members all sign — so the conflicting block verifies
    +2/3 of its OWN claimed set (`verify_commit_light`), and the subset
    is chosen to hold > trust-level power of the real common-height set
    (`verify_commit_light_trusting`) — both checks the evidence pool
    reruns before pooling;
  * attack heights must be NON-adjacent to the client's trust anchor:
    adjacent verification pins the exact next validator set by hash and
    rejects the forgery before the witness cross-check even runs (a
    useful negative test, not an attack).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..types.block import BlockID, Commit, CommitSig, Header, PartSetHeader
from ..types.canonical import vote_sign_bytes
from ..types.keys import SignedMsgType
from ..types.validator_set import Validator, ValidatorSet
from .provider import Provider
from .types import LightBlock, SignedHeader


@dataclass(frozen=True)
class LunaticConfig:
    """One lunatic attack plan: which heights to forge at and how many
    committee members collude. Deterministic in `seed`."""

    attack_heights: tuple[int, ...]
    seed: int = 0
    #: colluding validators (must hold > 1/3 of the common-height power
    #: for the forged block to survive the evidence pool's trusting
    #: check; the scenario harness sizes this for the committee)
    n_traitors: int = 2


def _seeded_hash(seed: int, tag: str, *coords) -> bytes:
    return hashlib.sha256(
        f"tmtpu-lunatic:{seed}:{tag}:{coords!r}".encode()
    ).digest()


def traitor_indices(cfg: LunaticConfig, n_vals: int) -> tuple[int, ...]:
    """The colluding subset, a pure function of (seed, n_vals): a seeded
    starting offset and stride walk over the validator indices."""
    n = min(cfg.n_traitors, n_vals)
    start = int.from_bytes(_seeded_hash(cfg.seed, "subset", n_vals)[:4], "big")
    return tuple(sorted((start + i) % n_vals for i in range(n)))


def forge_light_block(
    cfg: LunaticConfig,
    real: LightBlock,
    vals: ValidatorSet,
    keys_by_addr: dict,
    chain_id: str,
) -> LightBlock:
    """The lunatic forgery for one height: a header copied from the real
    block with a seeded app_hash and the colluding subset as the claimed
    validator set, committed by every colluder at the real header's
    timestamp (deterministic under same-seed runs)."""
    idxs = traitor_indices(cfg, len(vals.validators))
    subset = [vals.validators[i] for i in idxs]
    claimed = ValidatorSet([Validator(v.pub_key, v.voting_power) for v in subset])
    header = Header(
        chain_id=real.header.chain_id,
        height=real.height,
        time_ns=real.header.time_ns,
        last_block_id=real.header.last_block_id,
        last_commit_hash=real.header.last_commit_hash,
        data_hash=real.header.data_hash,
        validators_hash=claimed.hash(),
        next_validators_hash=claimed.hash(),
        consensus_hash=real.header.consensus_hash,
        app_hash=_seeded_hash(cfg.seed, "app", real.height),
        last_results_hash=real.header.last_results_hash,
        evidence_hash=real.header.evidence_hash,
        proposer_address=claimed.validators[0].address,
        version=real.header.version,
    )
    bid = BlockID(
        header.hash(),
        PartSetHeader(1, _seeded_hash(cfg.seed, "parts", real.height)),
    )
    sigs = []
    for val in claimed.validators:
        ts = real.header.time_ns
        sb = vote_sign_bytes(
            chain_id, SignedMsgType.PRECOMMIT, real.height, 0, bid, ts
        )
        sigs.append(
            CommitSig.for_block(val.address, ts, keys_by_addr[val.address].sign(sb))
        )
    commit = Commit(real.height, 0, bid, tuple(sigs))
    return LightBlock(SignedHeader(header, commit), claimed)


class LunaticProvider(Provider):
    """A traitor primary: honest pass-through everywhere except the
    seeded attack heights, where the forged block is served instead.
    Forgeries are built once per height and cached, so every client
    (and every same-seed run) sees byte-identical lies."""

    def __init__(
        self,
        inner: Provider,
        cfg: LunaticConfig,
        vals: ValidatorSet,
        keys_by_addr: dict,
    ):
        self.inner = inner
        self.cfg = cfg
        self.vals = vals
        self.keys_by_addr = keys_by_addr
        self._forged: dict[int, LightBlock] = {}
        #: observation log for the scenario auditor (heights served
        #: forged, in request order — bounded by the attack plan)
        self.served_forged: list[int] = []

    def __repr__(self) -> str:
        return f"LunaticProvider({self.inner!r}, heights={self.cfg.attack_heights})"

    def chain_id(self) -> str:
        return self.inner.chain_id()

    def traitor_addresses(self) -> tuple[bytes, ...]:
        return tuple(
            self.vals.validators[i].address
            for i in traitor_indices(self.cfg, len(self.vals.validators))
        )

    async def light_block(self, height: int) -> LightBlock:
        real = await self.inner.light_block(height)
        if real.height not in self.cfg.attack_heights:
            return real
        forged = self._forged.get(real.height)
        if forged is None:
            forged = forge_light_block(
                self.cfg, real, self.vals, self.keys_by_addr, self.chain_id()
            )
            self._forged[real.height] = forged
        self.served_forged.append(real.height)
        return forged

    async def report_evidence(self, evidence) -> None:
        # a real attacker drops evidence against itself on the floor
        pass
