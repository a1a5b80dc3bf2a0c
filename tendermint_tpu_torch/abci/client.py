"""ABCI clients (reference abci/client).

`Client` is the async interface the node talks to; `LocalClient` wraps an
in-process Application behind a lock (reference abci/client/local_client.go
— one mutex, serialized calls). The socket client for out-of-process apps
lives in abci/socket.py."""

from __future__ import annotations

import asyncio

from . import types as abci
from .application import Application


class Client:
    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    async def echo(self, msg: str) -> str:
        raise NotImplementedError

    async def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    async def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    async def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    async def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    async def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    async def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    async def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    async def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    async def list_snapshots(self) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    async def offer_snapshot(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    async def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    async def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError


class LocalClient(Client):
    """In-process client: every call takes the app lock, mirroring the
    reference's mutex-serialized local client. All four node connections
    (consensus/mempool/query/snapshot) share one lock so the app never sees
    concurrent calls."""

    def __init__(self, app: Application, lock: asyncio.Lock | None = None):
        self.app = app
        self._lock = lock or asyncio.Lock()

    async def _call(self, fn, *args):
        async with self._lock:
            return fn(*args)

    async def echo(self, msg: str) -> str:
        return msg

    async def info(self, req):
        return await self._call(self.app.info, req)

    async def query(self, req):
        return await self._call(self.app.query, req)

    async def check_tx(self, req):
        return await self._call(self.app.check_tx, req)

    async def init_chain(self, req):
        return await self._call(self.app.init_chain, req)

    async def begin_block(self, req):
        return await self._call(self.app.begin_block, req)

    async def deliver_tx(self, req):
        return await self._call(self.app.deliver_tx, req)

    async def end_block(self, req):
        return await self._call(self.app.end_block, req)

    async def commit(self):
        return await self._call(self.app.commit)

    async def list_snapshots(self):
        return await self._call(self.app.list_snapshots)

    async def offer_snapshot(self, req):
        return await self._call(self.app.offer_snapshot, req)

    async def load_snapshot_chunk(self, req):
        return await self._call(self.app.load_snapshot_chunk, req)

    async def apply_snapshot_chunk(self, req):
        return await self._call(self.app.apply_snapshot_chunk, req)
