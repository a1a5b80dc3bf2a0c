"""Event indexer (reference internal/state/indexer/): subscribes to the
event bus and persists tx results + event attributes so RPC `tx`,
`tx_search`, and `block_search` can answer queries over history.

The kv sink scheme mirrors the reference's (sink/kv): primary record by
tx hash; secondary keys `evt/<composite-key>/<value>/<height>/<index>`
pointing at the hash. Search takes one pubsub Query: equality conditions
narrow via the secondary index, everything else filters on the stored
event map. The port's copy of tendermint_tpu/state/indexer.py (the same
keys and records); the SQL sink waits for the RPC port."""

from __future__ import annotations

import json
import logging

from ..crypto.hash_hub import sha256_one
from ..libs.pubsub import Query
from ..libs.service import Service
from ..store.db import DB
from ..types.events import (
    EVENT_NEW_BLOCK_HEADER,
    EVENT_TX,
    EventBus,
    abci_events_to_map,
    query_for_event,
)

_TX = b"tx/"
_EVT = b"evt/"
_BLK = b"bevt/"


def _prefix_end(prefix: bytes) -> bytes:
    """Exclusive upper bound covering every key with this prefix (DB
    iterate is [start, end); a bare prefix+0xff bound would drop keys
    whose next byte IS 0xff)."""
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] != 0xFF:
            p[i] += 1
            return bytes(p[: i + 1])
    return None  # prefix is all 0xff: unbounded


class TxResult:
    def __init__(
        self,
        height: int,
        index: int,
        tx: bytes,
        code: int,
        data: bytes,
        log: str,
        events: dict[str, list[str]],
    ):
        self.height = height
        self.index = index
        self.tx = tx
        self.code = code
        self.data = data
        self.log = log
        self.events = events

    @property
    def hash(self) -> bytes:
        return sha256_one(self.tx)

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "height": self.height,
                "index": self.index,
                "tx": self.tx.hex(),
                "code": self.code,
                "data": self.data.hex(),
                "log": self.log,
                "events": self.events,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "TxResult":
        d = json.loads(raw)
        return cls(
            d["height"], d["index"], bytes.fromhex(d["tx"]), d["code"],
            bytes.fromhex(d["data"]), d["log"], d["events"],
        )


class KVSink:
    """DB-backed event sink (reference indexer/sink/kv)."""

    def __init__(self, db: DB):
        self.db = db

    # -- writes ----------------------------------------------------------

    def index_tx(self, res: TxResult) -> None:
        h = res.hash
        sets: list[tuple[bytes, bytes]] = [(_TX + h, res.to_json())]
        pos = res.height.to_bytes(8, "big") + res.index.to_bytes(4, "big")
        for key, values in res.events.items():
            for v in values:
                sets.append(
                    (_EVT + key.encode() + b"/" + v.encode() + b"/" + pos, h)
                )
        # implicit tx.height key (reference indexes tx.height always)
        sets.append((_EVT + b"tx.height/" + str(res.height).encode() + b"/" + pos, h))
        self.db.write_batch(sets)

    def index_block(self, height: int, events: dict[str, list[str]]) -> None:
        self.db.set(
            _BLK + height.to_bytes(8, "big"), json.dumps(events).encode()
        )

    # -- reads -----------------------------------------------------------

    def get_tx(self, hash_: bytes) -> TxResult | None:
        raw = self.db.get(_TX + hash_)
        return TxResult.from_json(raw) if raw is not None else None

    def search_txs(self, query: Query, limit: int = 100) -> list[TxResult]:
        # narrow by the first equality condition if possible
        hashes: list[bytes] = []
        eq = next(
            (c for c in query.conditions if c.op == "=" and c.key != "tm.event"),
            None,
        )
        results_by_hash: dict[bytes, TxResult] = {}
        if eq is not None:
            prefix = _EVT + eq.key.encode() + b"/" + str(eq.operand).encode() + b"/"
            for _k, h in self.db.iterate(prefix, _prefix_end(prefix)):
                if h not in results_by_hash:
                    res = self.get_tx(h)
                    if res is not None:
                        results_by_hash[h] = res
        else:
            for k, raw in self.db.iterate(_TX, _prefix_end(_TX)):
                h = k[len(_TX):]  # key is _TX + hash
                if h not in results_by_hash:
                    results_by_hash[h] = TxResult.from_json(raw)
        out = []
        for h, res in results_by_hash.items():
            evmap = dict(res.events)
            evmap.setdefault("tx.height", [str(res.height)])
            evmap.setdefault("tx.hash", [res.hash.hex().upper()])
            if query.matches(evmap):
                out.append(res)
                if len(out) >= limit:
                    break
        out.sort(key=lambda r: (r.height, r.index))
        return out

    def search_blocks(self, query: Query, limit: int = 100) -> list[int]:
        out = []
        for k, raw in self.db.iterate(_BLK, _prefix_end(_BLK)):
            height = int.from_bytes(k[len(_BLK):], "big")
            evmap = json.loads(raw)
            evmap.setdefault("block.height", [str(height)])
            if query.matches(evmap):
                out.append(height)
                if len(out) >= limit:
                    break
        return out


class IndexerService(Service):
    """Subscribes the sink to the event bus (reference
    indexer_service.go)."""

    def __init__(self, sink: KVSink, event_bus: EventBus, *, logger=None):
        super().__init__("indexer", logger)
        self.sink = sink
        self.event_bus = event_bus

    async def on_start(self) -> None:
        tx_sub = self.event_bus.subscribe(
            "indexer", query_for_event(EVENT_TX), buffer=1024
        )
        blk_sub = self.event_bus.subscribe(
            "indexer", query_for_event(EVENT_NEW_BLOCK_HEADER), buffer=1024
        )
        self.spawn(self._run_tx(tx_sub), name="indexer.tx")
        self.spawn(self._run_block(blk_sub), name="indexer.blk")

    async def _run_tx(self, sub) -> None:
        async for msg in sub:
            data = msg.data
            res = data.result
            events = abci_events_to_map(getattr(res, "events", ()))
            self.sink.index_tx(
                TxResult(
                    data.height,
                    data.index,
                    data.tx,
                    getattr(res, "code", 0),
                    getattr(res, "data", b""),
                    getattr(res, "log", ""),
                    events,
                )
            )

    async def _run_block(self, sub) -> None:
        async for msg in sub:
            header = msg.data.header
            events: dict[str, list[str]] = {}
            for src in (msg.data.result_begin_block, msg.data.result_end_block):
                if src is not None:
                    for k, vs in abci_events_to_map(getattr(src, "events", ())).items():
                        events.setdefault(k, []).extend(vs)
            self.sink.index_block(header.height, events)
