"""Commit verification — the entry points of the port (analog of reference
types/validation.go:25-265, and of tendermint_tpu/types/validation.py).

  verify_commit        — full validation: every non-absent signature must
                         verify (commit AND nil votes); tallied power counts
                         only votes for the block.
  verify_commit_light  — only signatures for the committed block are
                         verified, stopping at +2/3.
  verify_commit_light_trusting — light-client skipping verification:
                         validators looked up by address in the *trusted*
                         set, `trust_level` (default 1/3) of its power.
  verify_commit_range  — a range of commits (a block-sync window) in ONE
                         batch verifier call, light semantics per commit.

When the key type batches (ed25519, sr25519) and there are at least
BATCH_VERIFY_THRESHOLD signatures, each funnels its signatures into one
`_CommitVerifier`: through the running VerifyHub when one is up, else
through `create_batch_verifier(pub_key, device)` — either way the
adaptive verifier sends a batch of at least `batch.MIN_TPU_BATCH`
signatures to `kernel_eq` (one launch per ≤8,192 signatures) and a
smaller one to the host; a bls12381 set's signatures go to the pairing
kernels. Other sets (secp256k1, mixed) verify one by one through
`verify_one`. An aggregate commit (one BLS G2 signature for every signer)
is one pairing-product check through `verify_hub.verify_aggregate`, in a
range one commit at a time. All take `device=` ("cuda" by default; "cpu" on
request; raise without a card unless the CPU was asked for) and `lane=`
(the hub's scheduler lane). Error surface and `failed_index` match the
reference.
"""

from __future__ import annotations

from fractions import Fraction

from ..crypto import batch as crypto_batch
from ..device import DEFAULT_DEVICE, resolve
from .block import BlockID, Commit
from .validator_set import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2


class InvalidCommitError(ValueError):
    pass


class _CommitVerifier:
    """Batch-verifier shim for the verify_commit* funnel: routes the
    collected signatures through the running VerifyHub (cross-subsystem
    micro-batching, gossip-duplicate dedup) and otherwise through
    `create_batch_verifier(pub_key, device)`; the verdicts are the same,
    the hub only changes where and when the batch launches. `lane` picks
    the hub lane: block-sync / light-client callers submit as
    "backfill". A failed hub call raises: unlike the reference, nothing
    verifies the signatures again locally, because a local verifier
    sends a batch below `batch.MIN_TPU_BATCH` (one commit's signatures,
    say) to the host and would answer for a batch the card failed."""

    def __init__(self, pub_key, device, lane: str = "live"):
        self._pub_key = pub_key
        self._device = device
        self._lane = lane
        self._items: list[tuple] = []

    def add(self, pub_key, msg: bytes, sig: bytes) -> None:
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        from ..crypto.verify_hub import running_hub

        hub = running_hub()
        if hub is not None:
            results = hub.verify_many(self._items, lane=self._lane)
            return all(results) and bool(results), results
        bv = crypto_batch.create_batch_verifier(self._pub_key, self._device)
        for pk, msg, sig in self._items:
            bv.add(pk, msg, sig)
        return bv.verify()


def _basic_commit_checks(
    vals: ValidatorSet, block_id: BlockID, height: int, commit: Commit
) -> None:
    if commit.height != height:
        raise InvalidCommitError(f"commit height {commit.height} != {height}")
    if commit.block_id != block_id:
        raise InvalidCommitError("commit is for a different block")
    if len(vals) != commit.size():
        raise InvalidCommitError(
            f"validator set size {len(vals)} != commit size {commit.size()}"
        )


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    return commit.size() >= BATCH_VERIFY_THRESHOLD and all(
        crypto_batch.supports_batch_verifier(v.pub_key) for v in vals.validators
    )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    *,
    device=DEFAULT_DEVICE,
    lane: str = "live",
) -> None:
    """Full commit verification (reference types/validation.go:25).
    Raises InvalidCommitError on failure."""
    dev = resolve(device)
    _basic_commit_checks(vals, block_id, height, commit)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    _verify(chain_id, vals, commit, voting_power_needed, True, True, dev, lane)


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    *,
    device=DEFAULT_DEVICE,
    lane: str = "live",
) -> None:
    """Verify only the signatures for the committed block, stopping at +2/3
    (reference types/validation.go:59) — the block-sync/light-client path."""
    dev = resolve(device)
    _basic_commit_checks(vals, block_id, height, commit)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    _verify(chain_id, vals, commit, voting_power_needed, False, True, dev, lane)


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    *,
    device=DEFAULT_DEVICE,
    lane: str = "live",
) -> None:
    """Light-client skipping verification against a *trusted* validator set
    (reference types/validation.go:94): validators are matched by address
    (the untrusted set may have rotated), and `trust_level` of the trusted
    power must have signed."""
    dev = resolve(device)
    if trust_level.numerator * 3 < trust_level.denominator or trust_level > 1:
        raise ValueError("trust level must be in [1/3, 1]")
    total = vals.total_voting_power()
    voting_power_needed = total * trust_level.numerator // trust_level.denominator
    _verify(chain_id, vals, commit, voting_power_needed, False, False, dev, lane)


def _verify(
    chain_id, vals, commit, voting_power_needed, count_all_signatures, lookup_by_index, dev, lane
):
    if commit.is_aggregate():
        _verify_aggregate(chain_id, vals, commit, voting_power_needed, lookup_by_index, dev)
    elif _should_batch_verify(vals, commit):
        _verify_batch(
            chain_id, vals, commit, voting_power_needed, count_all_signatures,
            lookup_by_index, dev, lane,
        )
    else:
        _verify_single(
            chain_id, vals, commit, voting_power_needed, count_all_signatures,
            lookup_by_index, lane,
        )


def _iter_entries(vals: ValidatorSet, commit: Commit, lookup_by_index: bool):
    """Yield (idx, commit_sig, validator) for signatures that participate.
    Absent sigs never participate; with address lookup (trusting mode),
    unknown validators are skipped and double-signing addresses rejected."""
    seen: set[bytes] = set()
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        if lookup_by_index:
            val = vals.get_by_index(idx)
            if val is None:
                raise InvalidCommitError(f"no validator at index {idx}")
        else:
            _, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if cs.validator_address in seen:
                raise InvalidCommitError("double vote from same address")
            seen.add(cs.validator_address)
        yield idx, cs, val


def _verify_aggregate(chain_id, vals, commit, voting_power_needed, lookup_by_index, dev) -> None:
    """Aggregate-commit verification: ONE pairing-product check covers
    every non-absent signer (commit AND nil votes — the aggregate is
    indivisible, so light semantics cannot skip nil signatures; the
    tally still counts only block votes). Routed through the
    crypto/verify_hub.verify_aggregate chokepoint (verdict cache, the
    pairing kernels on `dev`). Accept/reject surface matches the
    per-signature paths: a forged signer, a wrong bitmap flag, or a
    non-BLS key in an included slot all reject."""
    from ..crypto.bls import KEY_TYPE as BLS_KEY_TYPE
    from ..crypto.verify_hub import verify_aggregate

    tallied = 0
    pubs = []
    msgs = []
    seen: set[bytes] = set()
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        if lookup_by_index:
            val = vals.get_by_index(idx)
            if val is None:
                raise InvalidCommitError(f"no validator at index {idx}")
        else:
            # trusting mode: EVERY included signer must resolve in the
            # trusted set — an aggregate cannot be verified minus the
            # signers the light client doesn't know
            _, val = vals.get_by_address(cs.validator_address)
            if val is None:
                raise InvalidCommitError(
                    f"aggregate commit signer at index {idx} unknown to the "
                    "trusted validator set (aggregate cannot be partially "
                    "verified)"
                )
            if cs.validator_address in seen:
                raise InvalidCommitError("double vote from same address")
            seen.add(cs.validator_address)
        if val.pub_key.TYPE != BLS_KEY_TYPE:
            raise InvalidCommitError(
                f"aggregate commit includes non-BLS signer at index {idx}"
            )
        if cs.signature:
            raise InvalidCommitError(
                f"aggregate commit carries a per-validator signature at "
                f"index {idx}"
            )
        pubs.append(val.pub_key)
        msgs.append(commit.vote_sign_bytes(chain_id, idx))
        if cs.is_commit():
            tallied += val.voting_power
    if tallied <= voting_power_needed:
        raise InvalidCommitError(
            f"insufficient voting power: got {tallied}, need > {voting_power_needed}"
        )
    if not pubs:
        raise InvalidCommitError("no signatures to verify")
    if not verify_aggregate(pubs, msgs, commit.agg_sig, device=dev):
        raise InvalidCommitError("aggregate signature verification failed")


def _verify_batch(
    chain_id, vals, commit, voting_power_needed, count_all_signatures, lookup_by_index, dev,
    lane,
) -> None:
    bv = _CommitVerifier(vals.validators[0].pub_key, dev, lane)
    tallied = 0
    entries = []
    for idx, cs, val in _iter_entries(vals, commit, lookup_by_index):
        if not count_all_signatures and not cs.is_commit():
            continue
        bv.add(val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature)
        entries.append(idx)
        if cs.is_commit():
            tallied += val.voting_power
        # early cut-off: beyond +2/3 no further signatures are needed
        if not count_all_signatures and tallied > voting_power_needed:
            break
    if tallied <= voting_power_needed:
        raise InvalidCommitError(
            f"insufficient voting power: got {tallied}, need > {voting_power_needed}"
        )
    if not entries:
        raise InvalidCommitError("no signatures to verify")
    ok, bitmap = bv.verify()
    if not ok:
        for idx, good in zip(entries, bitmap):
            if not good:
                raise InvalidCommitError(f"invalid signature at index {idx}")
        raise InvalidCommitError("batch verification failed")


def _verify_single(
    chain_id, vals, commit, voting_power_needed, count_all_signatures, lookup_by_index, lane
) -> None:
    from ..crypto.verify_hub import verify_one

    tallied = 0
    for idx, cs, val in _iter_entries(vals, commit, lookup_by_index):
        if not count_all_signatures and not cs.is_commit():
            continue
        if not verify_one(
            val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature, lane=lane
        ):
            raise InvalidCommitError(f"invalid signature at index {idx}")
        if cs.is_commit():
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise InvalidCommitError(
            f"insufficient voting power: got {tallied}, need > {voting_power_needed}"
        )


def verify_commit_range(
    chain_id: str,
    entries: list[tuple[ValidatorSet, BlockID, int, Commit]],
    *,
    device=DEFAULT_DEVICE,
    lane: str = "backfill",
) -> None:
    """Verify a RANGE of commits — e.g. a block-sync window — in ONE batch
    verifier call, so hundreds of heights' signatures form one `kernel_eq`
    launch per ≤8,192 signatures instead of one per block.

    Each entry is (validator_set, block_id, height, commit), light
    semantics per commit (+2/3 of block signatures, early cut-off). On a
    batch failure, falls back to per-commit verification to pinpoint the
    offender, so the error surface matches verify_commit_light called per
    entry. Raises InvalidCommitError carrying `failed_index` (the entry
    index) on failure."""
    dev = resolve(device)
    if not entries:
        return
    # created lazily, from the first batchable entry: a mixed ed25519 +
    # secp256k1 set verifies through the individual path below, and
    # keying the verifier off validators[0] of a set whose first key
    # does not batch would fail
    bv = None
    added_any = False
    for ei, (vals, block_id, height, commit) in enumerate(entries):
        try:
            _basic_commit_checks(vals, block_id, height, commit)
            if commit.is_aggregate() or not _should_batch_verify(vals, commit):
                # an aggregate commit is one indivisible pairing product
                # (verdict-cached in the hub); mixed and secp256k1 sets
                # verify one by one
                verify_commit_light(
                    chain_id, vals, block_id, height, commit, device=dev, lane=lane
                )
                continue
            if bv is None:
                bv = _CommitVerifier(vals.validators[0].pub_key, dev, lane)
            voting_power_needed = vals.total_voting_power() * 2 // 3
            tallied = 0
            for idx, cs, val in _iter_entries(vals, commit, lookup_by_index=True):
                if not cs.is_commit():
                    continue
                bv.add(val.pub_key, commit.vote_sign_bytes(chain_id, idx), cs.signature)
                added_any = True
                tallied += val.voting_power
                if tallied > voting_power_needed:
                    break
            if tallied <= voting_power_needed:
                raise InvalidCommitError(
                    f"insufficient voting power at height {height}: "
                    f"got {tallied}, need > {voting_power_needed}"
                )
        except InvalidCommitError as e:
            e.failed_index = ei
            raise
    if not added_any:
        return
    ok, _bitmap = bv.verify()
    if ok:
        return
    # locate the offending commit: per-commit fallback
    for ei, (vals, block_id, height, commit) in enumerate(entries):
        try:
            verify_commit_light(
                chain_id, vals, block_id, height, commit, device=dev, lane=lane
            )
        except InvalidCommitError as e:
            e.failed_index = ei
            raise
    raise InvalidCommitError("range batch failed but all commits verify singly")
