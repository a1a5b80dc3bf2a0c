"""Application interface (reference abci/types/application.go:11-31).

Applications are synchronous objects; the client layer serializes access
and presents an async interface to the node. BaseApplication provides
no-op defaults so apps override only what they need."""

from __future__ import annotations

from . import types as abci


class Application:
    """The state-transition machine replicated by consensus."""

    # info/query connection
    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    # mempool connection
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    # consensus connection
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    # snapshot connection (state sync)
    def list_snapshots(self) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError


class BaseApplication(Application):
    """No-op defaults (reference abci/types/application.go BaseApplication)."""

    def info(self, req):
        return abci.ResponseInfo()

    def query(self, req):
        return abci.ResponseQuery()

    def check_tx(self, req):
        return abci.ResponseCheckTx()

    def init_chain(self, req):
        return abci.ResponseInitChain()

    def begin_block(self, req):
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req):
        return abci.ResponseDeliverTx()

    def end_block(self, req):
        return abci.ResponseEndBlock()

    def commit(self):
        return abci.ResponseCommit()

    def list_snapshots(self):
        return abci.ResponseListSnapshots()

    def offer_snapshot(self, req):
        return abci.ResponseOfferSnapshot(abci.OfferSnapshotResult.ABORT)

    def load_snapshot_chunk(self, req):
        return abci.ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req):
        return abci.ResponseApplySnapshotChunk(abci.ApplySnapshotChunkResult.ABORT)
