"""EventBus: typed event publication over pubsub (reference
types/event_bus.go:35, types/events.go; the port's copy of
tendermint_tpu/types/events.py).

Consensus and the block executor publish here; the indexer and RPC
websocket subscribers consume. Composite event keys follow the reference:
`tm.event` plus per-ABCI-event `type.attr` keys."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..libs.pubsub import PubSub, Query, Subscription

# canonical tm.event values (reference types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_UNLOCK = "Unlock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_BLOCK_SYNC_STATUS = "BlockSyncStatus"
EVENT_STATE_SYNC_STATUS = "StateSyncStatus"

TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event: str) -> Query:
    return Query.parse(f"{TYPE_KEY}='{event}'")


@dataclass
class EventDataNewBlock:
    block: Any
    result_begin_block: Any = None
    result_end_block: Any = None


@dataclass
class EventDataNewBlockHeader:
    header: Any
    num_txs: int = 0
    result_begin_block: Any = None
    result_end_block: Any = None


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    index: int
    result: Any  # abci.ResponseDeliverTx


@dataclass
class EventDataNewEvidence:
    height: int
    evidence: Any


@dataclass
class EventDataVote:
    vote: Any


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: Any = None


def abci_events_to_map(abci_events) -> dict[str, list[str]]:
    """Flatten ABCI events into composite-key map entries (reference
    types/events.go TryUnwrapXXX / indexer key scheme)."""
    out: dict[str, list[str]] = {}
    for ev in abci_events or ():
        for attr in ev.attributes:
            key = f"{ev.type}.{attr.key}"
            out.setdefault(key, []).append(attr.value)
    return out


class EventBus:
    def __init__(self):
        self.pubsub = PubSub()

    def subscribe(
        self, subscriber: str, query: Query, buffer: int = 100,
        drop_on_full: bool = False,
    ) -> Subscription:
        return self.pubsub.subscribe(subscriber, query, buffer, drop_on_full)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    def _publish(self, event: str, data: Any, extra: dict[str, list[str]] | None = None):
        events = {TYPE_KEY: [event]}
        if extra:
            for k, v in extra.items():
                events.setdefault(k, []).extend(v)
        self.pubsub.publish(data, events)

    def publish_new_block(self, data: EventDataNewBlock) -> None:
        extra = abci_events_to_map(
            tuple(getattr(data.result_begin_block, "events", ()) or ())
            + tuple(getattr(data.result_end_block, "events", ()) or ())
        )
        extra.setdefault(BLOCK_HEIGHT_KEY, []).append(str(data.block.header.height))
        self._publish(EVENT_NEW_BLOCK, data, extra)

    def publish_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(
            EVENT_NEW_BLOCK_HEADER,
            data,
            {BLOCK_HEIGHT_KEY: [str(data.header.height)]},
        )

    def publish_tx(self, data: EventDataTx) -> None:
        from ..crypto.hash_hub import sha256_one

        extra = abci_events_to_map(getattr(data.result, "events", ()))
        extra.setdefault(TX_HASH_KEY, []).append(sha256_one(data.tx).hex().upper())
        extra.setdefault(TX_HEIGHT_KEY, []).append(str(data.height))
        self._publish(EVENT_TX, data, extra)

    def publish_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_validator_set_updates(self, data: EventDataValidatorSetUpdates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_new_round(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data)

    def publish_unlock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_UNLOCK, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)
