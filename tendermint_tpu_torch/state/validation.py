"""Block validation against state (reference internal/state/validation.go;
the port's copy of tendermint_tpu/state/validation.py, with `device=`).

Checks everything a correct proposer must have gotten right: header wiring
to the previous block, the three hash commitments into state, the LastCommit
(+2/3 of the previous validator set — the batch-verify hot path), evidence,
and the proposer's membership."""

from __future__ import annotations

from ..device import DEFAULT_DEVICE
from ..types.block import Block
from ..types.validation import _basic_commit_checks, verify_commit
from .state import State


class BlockValidationError(ValueError):
    pass


def median_time(commit, validators) -> int:
    """Voting-power-weighted median of commit timestamps (reference
    types/validator_set.go MedianTime via vote.go weightedMedian) — the
    canonical block time for the next height."""
    pairs = []
    total = 0
    for i, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        val = validators.get_by_index(i)
        if val is None:
            continue
        pairs.append((cs.timestamp_ns, val.voting_power))
        total += val.voting_power
    if not pairs:
        return 0
    pairs.sort()
    mid = total // 2
    acc = 0
    for ts, power in pairs:
        acc += power
        if acc > mid:
            return ts
    return pairs[-1][0]


def validate_block(
    state: State,
    block: Block,
    *,
    commit_verified: bool = False,
    device=DEFAULT_DEVICE,
) -> None:
    """commit_verified=True skips the LastCommit SIGNATURE check (every
    structural check still runs): block-sync range batches prove whole
    windows of commits in one device call (blocksync/reactor.py
    _verify_and_apply), and re-verifying each one during apply would
    redo ~half the sync's total signature work. `device` is where
    `verify_commit` runs the LastCommit check ("cuda" by default; it
    raises without a card unless "cpu" is asked for)."""
    block.validate_basic()

    h = block.header
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong chain id {h.chain_id!r}, expected {state.chain_id!r}"
        )
    expected_height = state.last_block_height + 1 if state.last_block_height else state.initial_height
    if h.height != expected_height:
        raise BlockValidationError(
            f"wrong height {h.height}, expected {expected_height}"
        )
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong last_block_id")

    # hash commitments into state
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong validators_hash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong next_validators_hash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong consensus_hash")
    if h.app_hash != state.app_hash:
        raise BlockValidationError(
            f"wrong app_hash {h.app_hash.hex()}, expected {state.app_hash.hex()}"
        )
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong last_results_hash")

    # LastCommit: +2/3 of the set that voted on the previous block
    if h.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.signatures:
            raise BlockValidationError("initial block cannot carry a LastCommit")
    else:
        if block.last_commit is None:
            raise BlockValidationError("missing LastCommit")
        if len(block.last_commit.signatures) != len(state.last_validators):
            raise BlockValidationError(
                f"LastCommit has {len(block.last_commit.signatures)} signatures, "
                f"expected {len(state.last_validators)}"
            )
        if not commit_verified:
            verify_commit(
                state.chain_id,
                state.last_validators,
                state.last_block_id,
                state.last_block_height,
                block.last_commit,
                device=device,
            )
        else:
            # signatures proven by the caller's batch; the cheap
            # consistency checks still run (validate_basic already ran
            # via block.validate_basic above)
            _basic_commit_checks(
                state.last_validators,
                state.last_block_id,
                state.last_block_height,
                block.last_commit,
            )
        # canonical block time is the weighted median of the commit votes
        expected_time = median_time(block.last_commit, state.last_validators)
        if h.time_ns != expected_time:
            raise BlockValidationError(
                f"wrong block time {h.time_ns}, expected median {expected_time}"
            )

    if not state.validators.has_address(h.proposer_address):
        raise BlockValidationError("proposer not in validator set")

    # evidence size cap
    ev_bytes = sum(len(ev.encode()) for ev in block.evidence)
    if ev_bytes > state.consensus_params.evidence.max_bytes:
        raise BlockValidationError("evidence exceeds max bytes")
