"""Stateless light-client core verifier (reference light/verifier.go; the
port's copy of tendermint_tpu/light/verifier.py).

Two modes:
  verify_adjacent (verifier.go:103) — heights h, h+1: the trusted header
    pins the EXACT next validator set (next_validators_hash), so only
    VerifyCommitLight against that set is needed.
  verify_non_adjacent (verifier.go:33) — skipping/bisection: the trusted
    set must still hold `trust_level` (default 1/3) of the new commit's
    power (VerifyCommitLightTrusting), then the new set verifies its own
    commit (VerifyCommitLight).

Both funnel into the same batched verification path
(types/validation.py) — and through the VerifyHub when one is running,
so light-client commits share kernel launches (and the gossip dedup
cache) with live consensus and block-sync. Every entry point takes
`device=` ("cuda" by default; raises without a card unless the caller
passes "cpu") and hands it to each commit verification it makes."""

from __future__ import annotations

import time
from fractions import Fraction

from ..crypto import hash_hub
from ..device import DEFAULT_DEVICE, resolve
from ..types.validation import (
    InvalidCommitError,
    verify_commit_light,
    verify_commit_light_trusting,
    verify_commit_range,
)
from .types import LightBlock

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class VerificationError(ValueError):
    pass


class ErrNewValSetCantBeTrusted(VerificationError):
    """Trusting-period overlap check failed — caller should bisect
    (reference ErrNewValSetCantBeTrusted)."""


def _validate_untrusted(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    """Shared sanity checks (reference verifier.go
    checkRequiredHeaderFields + verifyNewHeaderAndVals)."""
    untrusted.validate_basic(chain_id)
    if untrusted.height <= trusted.height:
        raise VerificationError(
            f"untrusted height {untrusted.height} <= trusted {trusted.height}"
        )
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise VerificationError("untrusted header time is not after trusted")
    if untrusted.header.time_ns >= now_ns + max_clock_drift_ns:
        raise VerificationError("untrusted header time is from the future")


def _expired(trusted: LightBlock, trusting_period_ns: int, now_ns: int) -> bool:
    return trusted.header.time_ns + trusting_period_ns <= now_ns


def _check_adjacent_link(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    """Every non-signature check of one adjacent step — shared verbatim
    by verify_adjacent and verify_adjacent_chain so the two paths cannot
    drift."""
    if untrusted.height != trusted.height + 1:
        raise VerificationError(
            f"headers must be adjacent in height "
            f"({trusted.height} -> {untrusted.height})"
        )
    if _expired(trusted, trusting_period_ns, now_ns):
        raise VerificationError(f"trusted header {trusted.height} has expired")
    _validate_untrusted(chain_id, trusted, untrusted, now_ns, max_clock_drift_ns)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise VerificationError(
            "untrusted validators hash != trusted next_validators_hash"
        )


def verify_adjacent(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int | None = None,
    max_clock_drift_ns: int = 10 * 1_000_000_000,
    *,
    device=DEFAULT_DEVICE,
) -> None:
    """Reference VerifyAdjacent verifier.go:103."""
    dev = resolve(device)
    now_ns = time.time_ns() if now_ns is None else now_ns
    with hash_hub.lane_ctx(hash_hub.LANE_LIGHT):
        _check_adjacent_link(
            chain_id, trusted, untrusted, trusting_period_ns, now_ns, max_clock_drift_ns
        )
        try:
            verify_commit_light(
                chain_id,
                untrusted.validators,
                untrusted.signed_header.commit.block_id,
                untrusted.height,
                untrusted.signed_header.commit,
                device=dev,
                lane="backfill",
            )
        except InvalidCommitError as e:
            raise VerificationError(f"invalid commit: {e}") from e


def verify_adjacent_chain(
    chain_id: str,
    trusted: LightBlock,
    chain: list[LightBlock],
    trusting_period_ns: int,
    now_ns: int | None = None,
    max_clock_drift_ns: int = 10 * 1_000_000_000,
    *,
    device=DEFAULT_DEVICE,
) -> LightBlock:
    """Bulk sequential verification — the device-first shape of the
    reference's header-by-header VerifyAdjacent loop
    (light/client_benchmark_test.go drives exactly this workload).

    All structural and trust-linkage checks (adjacency, expiry, times,
    next_validators_hash pinning) run sequentially on the host — they are
    cheap and order-dependent — and then every header's commit signatures
    are proven in ONE range-batched verifier call
    (types/validation.py:verify_commit_range), so a 1 000-header catch-up
    is one `kernel_eq` per ≤8,192 signatures instead of 1 000 calls.
    Since each header's validator set is pinned by its predecessor's
    next_validators_hash BEFORE any signature is checked, deferring the
    signature proof to the end does not weaken the trust chain: a forged
    commit anywhere fails the batch and nothing is returned.

    Returns the new trusted head (the last block of `chain`). Raises
    VerificationError naming the offending height otherwise."""
    dev = resolve(device)
    now_ns = time.time_ns() if now_ns is None else now_ns
    with hash_hub.lane_ctx(hash_hub.LANE_LIGHT):
        entries = []
        prev = trusted
        for lb in chain:
            _check_adjacent_link(
                chain_id, prev, lb, trusting_period_ns, now_ns, max_clock_drift_ns
            )
            entries.append(
                (
                    lb.validators,
                    lb.signed_header.commit.block_id,
                    lb.height,
                    lb.signed_header.commit,
                )
            )
            prev = lb
        try:
            verify_commit_range(chain_id, entries, device=dev, lane="backfill")
        except InvalidCommitError as e:
            idx = getattr(e, "failed_index", None)
            at = f" at height {chain[idx].height}" if idx is not None else ""
            raise VerificationError(f"invalid commit{at}: {e}") from e
        return prev


def verify_non_adjacent(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int | None = None,
    max_clock_drift_ns: int = 10 * 1_000_000_000,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    *,
    device=DEFAULT_DEVICE,
) -> None:
    """Reference VerifyNonAdjacent verifier.go:33."""
    dev = resolve(device)
    now_ns = time.time_ns() if now_ns is None else now_ns
    if untrusted.height == trusted.height + 1:
        return verify_adjacent(
            chain_id, trusted, untrusted, trusting_period_ns, now_ns, max_clock_drift_ns,
            device=dev,
        )
    if _expired(trusted, trusting_period_ns, now_ns):
        raise VerificationError("trusted header has expired")
    with hash_hub.lane_ctx(hash_hub.LANE_LIGHT):
        _validate_untrusted(chain_id, trusted, untrusted, now_ns, max_clock_drift_ns)
        # the trusted validator set must still control trust_level of the new
        # commit (verifier.go:67)
        try:
            verify_commit_light_trusting(
                chain_id,
                trusted.validators,
                untrusted.signed_header.commit,
                trust_level,
                device=dev,
                lane="backfill",
            )
        except InvalidCommitError as e:
            raise ErrNewValSetCantBeTrusted(str(e)) from e
        # and the new set must verify its own commit (verifier.go:82)
        try:
            verify_commit_light(
                chain_id,
                untrusted.validators,
                untrusted.signed_header.commit.block_id,
                untrusted.height,
                untrusted.signed_header.commit,
                device=dev,
                lane="backfill",
            )
        except InvalidCommitError as e:
            raise VerificationError(f"invalid commit: {e}") from e


def verify(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int | None = None,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    max_clock_drift_ns: int = 10 * 1_000_000_000,
    *,
    device=DEFAULT_DEVICE,
) -> None:
    """Dispatch on adjacency (reference Verify verifier.go:151)."""
    dev = resolve(device)
    if untrusted.height == trusted.height + 1:
        verify_adjacent(
            chain_id, trusted, untrusted, trusting_period_ns, now_ns,
            max_clock_drift_ns, device=dev,
        )
    else:
        verify_non_adjacent(
            chain_id, trusted, untrusted, trusting_period_ns, now_ns,
            max_clock_drift_ns, trust_level=trust_level, device=dev,
        )
