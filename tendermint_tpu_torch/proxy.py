"""App-connection multiplexer (reference internal/proxy/multi_app_conn.go:36).

The node talks to the application over four logical connections —
consensus, mempool, query, snapshot — so a slow query can never block
block execution. For a local app all four share one client (and hence one
lock, exactly like the reference's local client); a client factory can
return distinct clients for out-of-process apps."""

from __future__ import annotations

from typing import Callable

from .abci.application import Application
from .abci.client import Client, LocalClient


class AppConns:
    def __init__(
        self,
        consensus: Client,
        mempool: Client,
        query: Client,
        snapshot: Client,
    ):
        self.consensus = consensus
        self.mempool = mempool
        self.query = query
        self.snapshot = snapshot

    @classmethod
    def local(cls, app: Application) -> "AppConns":
        client = LocalClient(app)
        return cls(client, client, client, client)

    @classmethod
    def from_factory(cls, factory: Callable[[str], Client]) -> "AppConns":
        return cls(
            factory("consensus"), factory("mempool"), factory("query"),
            factory("snapshot"),
        )

    async def start(self) -> None:
        for c in {self.consensus, self.mempool, self.query, self.snapshot}:
            await c.start()

    async def stop(self) -> None:
        for c in {self.consensus, self.mempool, self.query, self.snapshot}:
            await c.stop()
