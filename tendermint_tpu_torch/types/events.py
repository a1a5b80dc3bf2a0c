"""EventBus: typed event publication over pubsub (reference
types/event_bus.go:35, types/events.go; the port's copy of
tendermint_tpu/types/events.py, as far as the block executor publishes:
new block, new block header, tx and validator-set updates). The
consensus events wait for the consensus port. Composite event keys follow the reference:
`tm.event` plus per-ABCI-event `type.attr` keys."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..libs.pubsub import PubSub, Query, Subscription

# canonical tm.event values (reference types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

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
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


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

    def publish_validator_set_updates(self, data: EventDataValidatorSetUpdates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)
