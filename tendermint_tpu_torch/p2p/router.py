"""The reactor-facing `Channel` (the port's copy of
tendermint_tpu/p2p/router.py:31-56, reference router.go:61). A reactor
reads inbound envelopes from `in_q`, queues outbound ones on `out_q` and
reports misbehaving peers on `err_q`; whatever moves envelopes between
channels and peers (the Router, or a test's in-process peer) drains
them. The Router waits for the p2p port."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable

from .types import Envelope, PeerError


@dataclass
class Channel:
    """Reactor-facing handle (reference router.go:61)."""

    id: int
    name: str
    priority: int
    encode: Callable[[object], bytes]
    decode: Callable[[bytes], object]
    in_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=1024))
    out_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=1024))
    err_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=64))

    async def send(self, envelope: Envelope) -> None:
        await self.out_q.put(envelope)

    async def receive(self) -> Envelope:
        return await self.in_q.get()

    async def error(self, err: PeerError) -> None:
        await self.err_q.put(err)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Envelope:
        return await self.in_q.get()
