"""Block executor (reference internal/state/execution.go:25; the port's
copy of tendermint_tpu/state/execution.py, with `device=`).

The ApplyBlock pipeline: validate → ABCI exec (BeginBlock → DeliverTx* →
EndBlock) → persist responses → update state (validator rotation, params)
→ app Commit under the mempool lock → prune → fire events."""

from __future__ import annotations

import logging

from .. import crypto
from ..abci import types as abci
from ..device import DEFAULT_DEVICE, resolve
from ..libs import fail
from ..abci.client import Client
from ..evidence import EvidencePoolI, NopEvidencePool
from ..mempool import Mempool, NopMempool
from ..store.blockstore import BlockStore
from ..types.block import Block, BlockID, Commit
from ..types.events import (
    EventBus,
    EventDataNewBlock,
    EventDataNewBlockHeader,
    EventDataTx,
    EventDataValidatorSetUpdates,
)
from ..types.evidence import DuplicateVoteEvidence
from ..types.part_set import PartSet
from ..types.validator_set import Validator, ValidatorSet
from .state import State
from .store import ABCIResponses, StateStore
from .validation import BlockValidationError, median_time, validate_block


def validator_updates_to_validators(
    updates: tuple[abci.ValidatorUpdate, ...], params
) -> list[Validator]:
    """Convert & validate app validator updates (reference
    types/protobuf.go PB2TM + validateValidatorUpdates execution.go)."""
    out = []
    for u in updates:
        if u.power < 0:
            raise ValueError("validator update with negative power")
        if u.power > 0 and u.pub_key_type not in params.validator.pub_key_types:
            raise ValueError(
                f"validator pubkey type {u.pub_key_type} not allowed by params"
            )
        pub = crypto.pubkey_from_type_and_bytes(u.pub_key_type, u.pub_key)
        if u.power > 0 and u.pub_key_type == "bls12381":
            # rogue-key defense must hold at EVERY entry point into the
            # validator set, not just genesis: an unproven BLS key in an
            # aggregate position could be a rogue combination of honest
            # keys (timestamps are attacker-chosen in a forged commit,
            # so the distinct-message assumption cannot be relied on)
            if not u.pop or not pub.pop_verify(u.pop):
                raise ValueError(
                    "bls12381 validator update without a valid proof of "
                    "possession"
                )
        out.append(Validator(pub, u.power))
    return out


def build_last_commit_info(
    block: Block, last_vals: ValidatorSet | None, initial_height: int
) -> abci.LastCommitInfo:
    """Who signed the previous block (reference execution.go
    getBeginBlockValidatorInfo)."""
    if block.header.height == initial_height or last_vals is None:
        return abci.LastCommitInfo(0)
    commit = block.last_commit
    votes = []
    for i, val in enumerate(last_vals.validators):
        cs = commit.signatures[i] if i < len(commit.signatures) else None
        votes.append(
            abci.VoteInfo(
                val.address, val.voting_power, cs is not None and not cs.is_absent()
            )
        )
    return abci.LastCommitInfo(commit.round, tuple(votes))


def evidence_to_misbehavior(evidence: tuple, time_ns: int) -> tuple[abci.Misbehavior, ...]:
    out = []
    for ev in evidence:
        if isinstance(ev, DuplicateVoteEvidence):
            out.append(
                abci.Misbehavior(
                    type="duplicate_vote",
                    validator_address=ev.vote_a.validator_address,
                    power=ev.validator_power,
                    height=ev.height,
                    time_ns=ev.timestamp_ns,
                    total_voting_power=ev.total_voting_power,
                )
            )
        else:  # light-client attack evidence
            # byzantine_validators holds Validator objects (the pool
            # verified the attribution against its own derivation);
            # one misbehavior entry per attributable signer
            for val in getattr(ev, "byzantine_validators", ()):
                out.append(
                    abci.Misbehavior(
                        type="light_client_attack",
                        validator_address=val.address,
                        power=val.voting_power,
                        height=ev.height,
                        time_ns=getattr(ev, "timestamp_ns", time_ns),
                        total_voting_power=getattr(ev, "total_voting_power", 0),
                    )
                )
    return tuple(out)


class BlockExecutor:
    """`device` ("cuda" by default, resolved here: it raises without a
    card unless "cpu" is asked for) is where `validate_block` verifies
    each block's LastCommit."""

    def __init__(
        self,
        state_store: StateStore,
        app: Client,
        mempool: Mempool | None = None,
        evidence_pool: EvidencePoolI | None = None,
        block_store: BlockStore | None = None,
        event_bus: EventBus | None = None,
        logger: logging.Logger | None = None,
        *,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.state_store = state_store
        self.app = app
        self.mempool = mempool or NopMempool()
        self.evidence_pool = evidence_pool or NopEvidencePool()
        self.block_store = block_store
        self.event_bus = event_bus
        self.logger = logger or logging.getLogger("executor")

    # -- proposal --------------------------------------------------------

    def create_proposal_block(
        self, height: int, state: State, last_commit: Commit | None,
        proposer_address: bytes,
    ) -> tuple[Block, PartSet]:
        """Reap evidence + txs and build the proposal (reference
        execution.go:102)."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = self.evidence_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes
        )
        # budget: block minus header/commit/evidence overhead (coarse, like
        # the reference's MaxDataBytes accounting)
        data_budget = max_bytes - ev_size - 10240 - 174 * len(state.validators)
        txs = self.mempool.reap_max_bytes_max_gas(data_budget, max_gas)
        if height == state.initial_height:
            time_ns = state.last_block_time_ns
        else:
            time_ns = median_time(last_commit, state.last_validators)
        block = state.make_block(
            height, tuple(txs), last_commit, tuple(evidence), proposer_address, time_ns
        )
        return block, PartSet.from_data(block.encode())

    # -- validation ------------------------------------------------------

    def validate_block(
        self, state: State, block: Block, *, commit_verified: bool = False
    ) -> None:
        validate_block(state, block, commit_verified=commit_verified, device=self.device)
        self.evidence_pool.check_evidence(block.evidence)

    # -- apply -----------------------------------------------------------

    async def apply_block(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        *,
        commit_verified: bool = False,
    ) -> tuple[State, int]:
        """Execute a committed block against the app and advance state
        (reference execution.go:151). Returns (new_state, retain_height).
        commit_verified: the caller proved LastCommit's signatures already
        (block-sync range batches; see state/validation.py)."""
        self.validate_block(state, block, commit_verified=commit_verified)

        responses = await self._exec_block(state, block)
        # crash points 4-5 mirror execution.go:170-217's fail.Fail sites
        fail.fail_point(4)  # block executed, before persisting responses
        self.state_store.save_abci_responses(block.header.height, responses)
        fail.fail_point(5)  # responses saved, before app Commit

        # validator + params updates requested by the app
        val_updates = validator_updates_to_validators(
            responses.end_block.validator_updates, state.consensus_params
        )
        new_state = self._update_state(state, block_id, block, responses, val_updates)

        # commit app state under the mempool lock (execution.go:245)
        async with self.mempool.lock():
            res_commit = await self.app.commit()
            await self.mempool.update(
                block.header.height,
                list(block.txs),
                list(responses.deliver_txs),
            )
        new_state = new_state.copy(app_hash=res_commit.data)
        self.state_store.save(new_state)

        self.evidence_pool.update(new_state, block.evidence)

        retain_height = res_commit.retain_height
        if retain_height > 0 and self.block_store is not None:
            try:
                base = self.block_store.base()
                if retain_height > base:
                    pruned = self.block_store.prune_blocks(retain_height)
                    self.state_store.prune_states(retain_height)
                    self.logger.debug("pruned %d blocks below %d", pruned, retain_height)
            except Exception as e:
                self.logger.error("pruning failed: %r", e)

        self._fire_events(block, block_id, responses, val_updates)
        return new_state, retain_height

    async def _exec_block(self, state: State, block: Block) -> ABCIResponses:
        """BeginBlock → DeliverTx×N → EndBlock (reference
        execBlockOnProxyApp execution.go:293)."""
        last_vals = None
        if block.header.height > state.initial_height:
            # prefer the historical set from the store: during handshake
            # replay `state` is the tip state, whose last_validators need
            # not be the set that signed this block's LastCommit
            last_vals = self.state_store.load_validators(block.header.height - 1)
            if last_vals is None:
                last_vals = state.last_validators
        res_begin = await self.app.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash(),
                header=block.header,
                last_commit_info=build_last_commit_info(
                    block, last_vals, state.initial_height
                ),
                byzantine_validators=evidence_to_misbehavior(
                    block.evidence, block.header.time_ns
                ),
            )
        )
        deliver: list[abci.ResponseDeliverTx] = []
        invalid = 0
        for tx in block.txs:
            res = await self.app.deliver_tx(abci.RequestDeliverTx(tx))
            if not res.is_ok():
                invalid += 1
            deliver.append(res)
        res_end = await self.app.end_block(
            abci.RequestEndBlock(block.header.height)
        )
        if invalid:
            self.logger.info(
                "executed block height=%d invalid_txs=%d", block.header.height, invalid
            )
        return ABCIResponses(tuple(deliver), res_end, res_begin)

    def _update_state(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        responses: ABCIResponses,
        val_updates: list[Validator],
    ) -> State:
        """Validator rotation + params (reference updateState
        execution.go:441)."""
        height = block.header.height
        n_val_set = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if val_updates:
            n_val_set.update_with_change_set(val_updates)
            last_height_vals_changed = height + 2
        n_val_set.increment_proposer_priority(1)

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        if responses.end_block.consensus_param_updates is not None:
            params = responses.end_block.consensus_param_updates
            params.validate_basic()
            last_height_params_changed = height + 1

        return state.copy(
            last_block_height=height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            validators=state.next_validators.copy(),
            next_validators=n_val_set,
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=responses.results_hash(),
        )

    def _fire_events(
        self,
        block: Block,
        block_id: BlockID,
        responses: ABCIResponses,
        val_updates: list[Validator],
    ) -> None:
        """Publish block/tx/valset events (reference fireEvents
        execution.go:509)."""
        if self.event_bus is None:
            return
        self.event_bus.publish_new_block(
            EventDataNewBlock(block, responses.begin_block, responses.end_block)
        )
        self.event_bus.publish_new_block_header(
            EventDataNewBlockHeader(
                block.header, len(block.txs), responses.begin_block, responses.end_block
            )
        )
        for i, tx in enumerate(block.txs):
            self.event_bus.publish_tx(
                EventDataTx(block.header.height, tx, i, responses.deliver_txs[i])
            )
        if val_updates:
            self.event_bus.publish_validator_set_updates(
                EventDataValidatorSetUpdates(val_updates)
            )

    # -- replay ----------------------------------------------------------

    async def exec_commit_block(self, state: State, block: Block) -> bytes:
        """Execute + commit without state bookkeeping — the ABCI-handshake
        replay path (reference ExecCommitBlock execution.go:570)."""
        await self._exec_block(state, block)
        res = await self.app.commit()
        return res.data
