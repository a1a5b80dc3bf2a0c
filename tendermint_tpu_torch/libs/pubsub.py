"""Event pubsub with a query DSL (reference libs/pubsub/pubsub.go:111 and
libs/pubsub/query).

Messages are published with an attached event map `{composite_key:
[values]}` (e.g. `{"tm.event": ["Tx"], "tx.hash": ["AB12…"]}`); subscribers
filter with queries like `tm.event='Tx' AND tx.height>5`. The same Query
class drives RPC websocket subscriptions and the event indexer."""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Any


class QueryError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND)\b
      | (?P<op><=|>=|=|<|>)
      | (?P<exists>EXISTS)\b
      | (?P<contains>CONTAINS)\b
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<time>TIME\s+\S+|DATE\s+\S+)
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '<', '>', '<=', '>=', 'EXISTS', 'CONTAINS'
    operand: Any = None

    def matches(self, values: list[str]) -> bool:
        if self.op == "EXISTS":
            return True
        for v in values:
            if self.op == "=":
                if isinstance(self.operand, (int, float)):
                    try:
                        if float(v) == float(self.operand):
                            return True
                    except ValueError:
                        pass
                elif v == self.operand:
                    return True
            elif self.op == "CONTAINS":
                if str(self.operand) in v:
                    return True
            else:  # numeric comparisons
                try:
                    x = float(v)
                except ValueError:
                    continue
                y = float(self.operand)
                if (
                    (self.op == "<" and x < y)
                    or (self.op == ">" and x > y)
                    or (self.op == "<=" and x <= y)
                    or (self.op == ">=" and x >= y)
                ):
                    return True
        return False


@dataclass(frozen=True)
class Query:
    """Conjunction of conditions over the event map."""

    conditions: tuple[Condition, ...] = ()
    source: str = ""

    @classmethod
    def parse(cls, s: str) -> "Query":
        tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if m is None or m.end() == pos:
                if s[pos:].strip():
                    raise QueryError(f"bad query near {s[pos:]!r}")
                break
            pos = m.end()
            for name, val in m.groupdict().items():
                if val is not None:
                    tokens.append((name, val))
                    break
        conds: list[Condition] = []
        i = 0
        while i < len(tokens):
            kind, val = tokens[i]
            if kind == "and":
                i += 1
                continue
            if kind != "key":
                raise QueryError(f"expected key, got {val!r}")
            if i + 1 >= len(tokens):
                raise QueryError(f"dangling key {val!r}")
            okind, oval = tokens[i + 1]
            if okind == "exists":
                conds.append(Condition(val, "EXISTS"))
                i += 2
                continue
            if okind == "contains":
                if i + 2 >= len(tokens):
                    raise QueryError("CONTAINS needs an operand")
                _, sval = tokens[i + 2]
                conds.append(Condition(val, "CONTAINS", _unquote(sval)))
                i += 3
                continue
            if okind != "op":
                raise QueryError(f"expected operator after {val!r}")
            if i + 2 >= len(tokens):
                raise QueryError("operator needs an operand")
            vkind, vval = tokens[i + 2]
            if vkind == "str":
                operand: Any = _unquote(vval)
            elif vkind == "num":
                operand = float(vval) if "." in vval else int(vval)
            elif vkind == "time":
                operand = vval.split(None, 1)[1]
            else:
                raise QueryError(f"bad operand {vval!r}")
            conds.append(Condition(val, oval, operand))
            i += 3
        return cls(tuple(conds), s)

    def matches(self, events: dict[str, list[str]]) -> bool:
        return all(
            c.key in events and c.matches(events[c.key]) for c in self.conditions
        )

    def __str__(self) -> str:
        return self.source


ALL = Query(source="<all>")  # empty conjunction matches everything


@dataclass
class Message:
    data: Any
    events: dict[str, list[str]] = field(default_factory=dict)


_CANCELLED = object()  # sentinel waking readers parked on the queue

#: process-wide drop accounting for drop_on_full subscriptions (the
#: websocket event fan-out); NodeMetrics folds it in at render time
DROPPED: dict[str, float] = {"events": 0.0}


class Subscription:
    def __init__(
        self, subscriber: str, query: Query, buffer: int,
        drop_on_full: bool = False,
    ):
        self.subscriber = subscriber
        self.query = query
        # +1 slot so the cancellation sentinel always fits
        self._queue: asyncio.Queue = asyncio.Queue(buffer + 1)
        self.cancelled: str | None = None  # cancellation reason
        # drop-with-counter instead of cancel-the-laggard: a slow
        # websocket consumer loses events (counted) but keeps its
        # subscription — bounded fan-out, never an unbounded queue
        self.drop_on_full = drop_on_full
        self.dropped = 0

    def _cancel(self, reason: str) -> None:
        self.cancelled = reason
        try:
            self._queue.put_nowait(_CANCELLED)
        except asyncio.QueueFull:
            pass

    async def next(self) -> Message:
        if self.cancelled and self._queue.empty():
            raise RuntimeError(f"subscription cancelled: {self.cancelled}")
        msg = await self._queue.get()
        if msg is _CANCELLED:
            raise RuntimeError(f"subscription cancelled: {self.cancelled}")
        return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.next()
        except RuntimeError:
            raise StopAsyncIteration from None


class PubSub:
    """In-process pubsub server. Unlike the Go original there is no
    subscriber goroutine: publish fans out synchronously to subscription
    queues; a full queue cancels the laggard (out-of-band, like the
    reference's ErrOutOfCapacity)."""

    def __init__(self):
        self._subs: dict[tuple[str, str], Subscription] = {}

    def subscribe(
        self, subscriber: str, query: Query, buffer: int = 100,
        drop_on_full: bool = False,
    ) -> Subscription:
        key = (subscriber, str(query))
        if key in self._subs:
            raise ValueError(f"already subscribed: {key}")
        sub = Subscription(subscriber, query, buffer, drop_on_full)
        self._subs[key] = sub
        return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        sub = self._subs.pop((subscriber, str(query)), None)
        if sub is not None:
            sub._cancel("unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        for key in [k for k in self._subs if k[0] == subscriber]:
            self._subs.pop(key)._cancel("unsubscribed")

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    def publish(self, data: Any, events: dict[str, list[str]] | None = None) -> None:
        events = events or {}
        msg = Message(data, events)
        for key, sub in list(self._subs.items()):
            if not sub.query.matches(events):
                continue
            if sub._queue.qsize() >= sub._queue.maxsize - 1:
                if sub.drop_on_full:
                    # slow subscriber: drop THIS event with a counter,
                    # keep the subscription (websocket fan-out contract)
                    sub.dropped += 1
                    DROPPED["events"] += 1
                else:
                    self._subs.pop(key, None)
                    sub._cancel("out of capacity")
            else:
                sub._queue.put_nowait(msg)


def _unquote(s: str) -> str:
    return s[1:-1].replace("\\'", "'") if s.startswith("'") else s
