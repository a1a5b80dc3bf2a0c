"""ABCI handshake: sync the app with the block store on startup
(reference internal/consensus/replay.go:242 Handshaker; the port's copy
of the Handshaker in tendermint_tpu/consensus/replay.py, with `device=`
for the executors it replays blocks through).

Compares the app's last height (ABCI Info) with the store and state
heights, sends InitChain on a fresh chain, replays stored blocks through
the app as needed, and asserts app-hash agreement. Together with WAL
replay (consensus/state.catchup_replay) and `report_wal_repair` this is
the crash-recovery path."""

from __future__ import annotations

import logging

from ..abci import types as abci
from ..device import DEFAULT_DEVICE, resolve
from ..proxy import AppConns
from ..state.execution import BlockExecutor, validator_updates_to_validators
from ..state.state import State
from ..state.store import StateStore
from ..store.blockstore import BlockStore
from ..types.genesis import GenesisDoc
from ..types.validator_set import ValidatorSet


def report_wal_repair(wal, logger: logging.Logger | None = None) -> None:
    """Surface the WAL's open-time crash repair in the recovery log: the
    exact truncation point (file:byte), how many whole records survived,
    and where the damaged tail went. Called on the node startup path next
    to the ABCI handshake so a post-crash boot reads as one coherent
    recovery story; a clean open logs nothing."""
    repairs = getattr(wal, "last_repair", None)
    if not repairs:
        return
    logger = logger or logging.getLogger("replay")
    for rep in repairs:
        logger.warning(
            "crash recovery: WAL truncated at %s:%d (%s; %d whole record(s) "
            "kept, %d damaged byte(s) moved to %s) — replaying to the "
            "pre-crash state",
            rep.path, rep.valid_end, rep.reason, rep.n_records,
            rep.file_size - rep.valid_end, rep.tail_path,
        )


class HandshakeError(RuntimeError):
    pass


class AppHashMismatchError(HandshakeError):
    pass


class Handshaker:
    def __init__(
        self,
        state_store: StateStore,
        state: State,
        block_store: BlockStore,
        genesis_doc: GenesisDoc,
        logger: logging.Logger | None = None,
        *,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis_doc = genesis_doc
        self.logger = logger or logging.getLogger("handshaker")
        self.n_blocks_replayed = 0

    async def handshake(self, app_conns: AppConns) -> State:
        res = await app_conns.query.info(abci.RequestInfo())
        app_height = res.last_block_height
        app_hash = res.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")
        self.logger.info(
            "ABCI handshake: app height=%d hash=%s", app_height, app_hash.hex()
        )
        state = await self.replay_blocks(
            self.initial_state, app_hash, app_height, app_conns
        )
        return state

    async def replay_blocks(
        self,
        state: State,
        app_hash: bytes,
        app_height: int,
        app_conns: AppConns,
    ) -> State:
        store_height = self.block_store.height()
        store_base = self.block_store.base()
        state_height = state.last_block_height

        # 1. fresh chain → InitChain (reference replay.go:285 region)
        if app_height == 0 and state_height == 0:
            # carry genesis proofs of possession into the InitChain
            # updates (as the reference does)
            pops = {
                gv.pub_key.bytes(): gv.pop for gv in self.genesis_doc.validators
            }
            validators = [
                abci.ValidatorUpdate(
                    v.pub_key.TYPE,
                    v.pub_key.bytes(),
                    v.voting_power,
                    pops.get(v.pub_key.bytes(), b""),
                )
                for v in state.validators.validators
            ]
            res = await app_conns.consensus.init_chain(
                abci.RequestInitChain(
                    time_ns=self.genesis_doc.genesis_time_ns,
                    chain_id=self.genesis_doc.chain_id,
                    consensus_params=state.consensus_params,
                    validators=tuple(validators),
                    app_state_bytes=self.genesis_doc.app_state,
                    initial_height=self.genesis_doc.initial_height,
                )
            )
            updates = {}
            if res.app_hash:
                updates["app_hash"] = res.app_hash
            if res.consensus_params is not None:
                updates["consensus_params"] = res.consensus_params
            if res.validators:
                vals = ValidatorSet(
                    validator_updates_to_validators(
                        res.validators,
                        updates.get("consensus_params", state.consensus_params),
                    )
                )
                updates["validators"] = vals
                updates["next_validators"] = vals.copy_increment_proposer_priority(1)
            if updates:
                state = state.copy(**updates)
            self.state_store.save(state)
            app_hash = state.app_hash

        if store_height == 0:
            self._assert_app_hash(state, app_hash)
            return state

        # 2. fresh state + populated store + fresh app → full replay:
        #    rebuild state by applying every stored block from the base
        #    (reference replay.go:415-443 replays the whole span when the
        #    app is behind the store; this is also what `replay` builds:
        #    a genesis state, a fresh app, and the node's block store).
        #    apply_block's header checks (app_hash chaining, last_block_id)
        #    validate each step against the stored chain.
        if state_height == 0 and app_height == 0 and store_height > 0:
            if store_base > state.initial_height:
                raise HandshakeError(
                    f"cannot replay from genesis: store pruned to base {store_base}"
                )
            executor = BlockExecutor(
                self.state_store, app_conns.consensus, device=self.device
            )
            for h in range(store_base, store_height + 1):
                block = self.block_store.load_block(h)
                meta = self.block_store.load_block_meta(h)
                if block is None or meta is None:
                    raise HandshakeError(f"missing block {h} in store")
                self.logger.info("replaying block %d from genesis", h)
                state, _ = await executor.apply_block(state, meta.block_id, block)
                self.n_blocks_replayed += 1
            return state

        # 3. sanity (reference replay.go checkAppHashEqualsOneFromState region)
        if app_height > store_height:
            raise HandshakeError(
                f"app height {app_height} ahead of store height {store_height}"
            )
        if state_height not in (store_height, store_height - 1):
            raise HandshakeError(
                f"state height {state_height} inconsistent with store height {store_height}"
            )
        if app_height < store_base - 1:
            raise HandshakeError(
                f"app height {app_height} below pruned store base {store_base}"
            )

        executor = BlockExecutor(
            self.state_store, app_conns.consensus, device=self.device
        )

        # 4. replay app-missing blocks up to store_height-1 via exec+commit
        #    (reference replayBlocks replay.go:528 region)
        replay_to = store_height - 1 if state_height == store_height - 1 else store_height
        for h in range(app_height + 1, replay_to + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"missing block {h} in store")
            self.logger.info("replaying block %d against app", h)
            app_hash = await executor.exec_commit_block(state, block)
            self.n_blocks_replayed += 1

        # 5. if state lags the store by one, apply the tip block fully
        #    (crash happened between SaveBlock and ApplyBlock)
        if state_height == store_height - 1:
            block = self.block_store.load_block(store_height)
            meta = self.block_store.load_block_meta(store_height)
            if block is None or meta is None:
                raise HandshakeError(f"missing tip block {store_height}")
            self.logger.info("applying tip block %d", store_height)
            state, _ = await executor.apply_block(state, meta.block_id, block)
            self.n_blocks_replayed += 1
            app_hash = state.app_hash

        self._assert_app_hash(state, app_hash)
        return state

    def _assert_app_hash(self, state: State, app_hash: bytes) -> None:
        if state.app_hash != app_hash:
            raise AppHashMismatchError(
                f"app hash {app_hash.hex()} != state app hash {state.app_hash.hex()}"
            )
