"""State store (reference internal/state/store.go:77).

Persists the latest State plus per-height validator sets, consensus params
and ABCI responses, so historical commits can be verified (block-sync,
light client, evidence) after the state has moved on."""

from __future__ import annotations

from ..abci import types as abci
from ..crypto import merkle
from ..libs import protoenc as pe
from ..store.db import DB
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet
from .state import State

_STATE_KEY = b"stateKey"
_VALS = b"validatorsKey:"
_PARAMS = b"consensusParamsKey:"
_ABCI = b"abciResponsesKey:"


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


# Durable bytes are the node's own writes, but chaos bit-rot applies to
# the DB file like to any other storage — a corrupted repeat count must
# raise at decode, never allocate (tmtlint wire-bounds).
MAX_STORE_ITEMS = 1 << 20


#: repeated-field clamp — the shared codec checker with this module's bound
_check_items = pe.check_repeat


class ABCIResponses:
    """The app's responses to one block (reference tmstate.ABCIResponses)."""

    def __init__(
        self,
        deliver_txs: tuple[abci.ResponseDeliverTx, ...] = (),
        end_block: abci.ResponseEndBlock | None = None,
        begin_block: abci.ResponseBeginBlock | None = None,
    ):
        self.deliver_txs = deliver_txs
        self.end_block = end_block or abci.ResponseEndBlock()
        self.begin_block = begin_block or abci.ResponseBeginBlock()

    def results_hash(self) -> bytes:
        """Merkle root over deterministic (code, data) of each DeliverTx
        (reference types.NewResults(...).Hash(), what goes into the next
        header's last_results_hash)."""
        leaves = [
            pe.varint_field(1, r.code) + pe.bytes_field(2, r.data)
            for r in self.deliver_txs
        ]
        return merkle.hash_from_byte_slices(leaves)

    def encode(self) -> bytes:
        out = b""
        for r in self.deliver_txs:
            out += pe.message_field(1, r.encode())
        eb = b"".join(
            pe.message_field(1, u.encode()) for u in self.end_block.validator_updates
        )
        if self.end_block.consensus_param_updates is not None:
            eb += pe.message_field(
                2, self.end_block.consensus_param_updates.encode()
            )
        eb += b"".join(pe.message_field(3, e.encode()) for e in self.end_block.events)
        out += pe.message_field(2, eb)
        bb = b"".join(
            pe.message_field(1, e.encode()) for e in self.begin_block.events
        )
        out += pe.message_field(3, bb)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ABCIResponses":
        r = pe.Reader(data)
        txs: list[abci.ResponseDeliverTx] = []
        updates: list[abci.ValidatorUpdate] = []
        param_updates = None
        eb_events: list[abci.Event] = []
        bb_events: list[abci.Event] = []
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                txs.append(abci.ResponseDeliverTx.decode(r.read_bytes()))
                _check_items(txs, MAX_STORE_ITEMS, "deliver-txs")
            elif f == 2:
                rr = pe.Reader(r.read_bytes())
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        updates.append(abci.ValidatorUpdate.decode(rr.read_bytes()))
                        _check_items(updates, MAX_STORE_ITEMS, "validator-updates")
                    elif ff == 2:
                        param_updates = ConsensusParams.decode(rr.read_bytes())
                    elif ff == 3:
                        eb_events.append(abci.Event.decode(rr.read_bytes()))
                        _check_items(eb_events, MAX_STORE_ITEMS, "end-block events")
                    else:
                        rr.skip(wwt)
            elif f == 3:
                rr = pe.Reader(r.read_bytes())
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        bb_events.append(abci.Event.decode(rr.read_bytes()))
                        _check_items(bb_events, MAX_STORE_ITEMS, "begin-block events")
                    else:
                        rr.skip(wwt)
            else:
                r.skip(wt)
        return cls(
            tuple(txs),
            abci.ResponseEndBlock(tuple(updates), param_updates, tuple(eb_events)),
            abci.ResponseBeginBlock(tuple(bb_events)),
        )


class StateStore:
    def __init__(self, db: DB):
        self.db = db

    # -- state blob ------------------------------------------------------

    def load(self) -> State | None:
        raw = self.db.get(_STATE_KEY)
        return State.decode(raw) if raw is not None else None

    def save(self, state: State) -> None:
        """Persist state; indexes the *next* validators at the height they
        become active (reference store.go save: nextValidators at
        lastBlockHeight+2, genesis seeds heights initial and initial+1)."""
        sets: list[tuple[bytes, bytes]] = [(_STATE_KEY, state.encode())]
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:  # genesis bootstrap
            sets.append(
                (_hkey(_VALS, state.initial_height), state.validators.encode())
            )
            sets.append(
                (
                    _hkey(_VALS, state.initial_height + 1),
                    state.next_validators.encode(),
                )
            )
            sets.append(
                (_hkey(_PARAMS, state.initial_height), state.consensus_params.encode())
            )
        else:
            sets.append(
                (_hkey(_VALS, next_height + 1), state.next_validators.encode())
            )
            sets.append((_hkey(_PARAMS, next_height), state.consensus_params.encode()))
        self.db.write_batch(sets)

    def bootstrap(self, state: State) -> None:
        """Seed the store from an out-of-band state (statesync restore)."""
        height = state.last_block_height
        sets = [(_STATE_KEY, state.encode())]
        if height > 0 and state.last_validators is not None and len(state.last_validators):
            sets.append((_hkey(_VALS, height), state.last_validators.encode()))
        sets.append((_hkey(_VALS, height + 1), state.validators.encode()))
        sets.append((_hkey(_VALS, height + 2), state.next_validators.encode()))
        sets.append((_hkey(_PARAMS, height + 1), state.consensus_params.encode()))
        self.db.write_batch(sets)

    def save_validators(self, height: int, vals: ValidatorSet) -> None:
        """Index a historical validator set directly (statesync backfill)."""
        self.db.set(_hkey(_VALS, height), vals.encode())

    # -- per-height lookups ---------------------------------------------

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(_hkey(_VALS, height))
        return ValidatorSet.decode(raw) if raw is not None else None

    def load_consensus_params(self, height: int) -> ConsensusParams | None:
        raw = self.db.get(_hkey(_PARAMS, height))
        if raw is not None:
            return ConsensusParams.decode(raw)
        # params persist only on change heights in the reference; we store
        # each height, so a miss means "walk back to the last stored one"
        for _, v in self.db.iterate(_PARAMS, _hkey(_PARAMS, height + 1), reverse=True):
            return ConsensusParams.decode(v)
        return None

    def save_abci_responses(self, height: int, responses: ABCIResponses) -> None:
        self.db.set(_hkey(_ABCI, height), responses.encode())

    def load_abci_responses(self, height: int) -> ABCIResponses | None:
        raw = self.db.get(_hkey(_ABCI, height))
        return ABCIResponses.decode(raw) if raw is not None else None

    def prune_states(self, retain_height: int) -> None:
        """Drop per-height data below retain_height (reference store.go:220)."""
        deletes: list[bytes] = []
        for prefix in (_VALS, _PARAMS, _ABCI):
            for k, _ in self.db.iterate(prefix, _hkey(prefix, retain_height)):
                deletes.append(k)
        self.db.write_batch([], deletes)
