"""Light client (reference light/client.go:127; the port's copy of
tendermint_tpu/light/client.py).

Holds a trusted store of verified LightBlocks, a primary provider, and
witness providers. `verify_light_block_at_height` verifies forward via
sequential or skipping (bisection) verification — skipping needs only
log(n) headers thanks to the 1/3-overlap rule — or backwards via hash
linkage (client.go:878). After primary verification the header is cross-
checked against witnesses; a mismatch raises Divergence (the detector,
light/detector.go:28). `LightClient(..., device=)` ("cuda" by default;
raises without a card unless the caller passes "cpu") runs every commit
verification it makes on that device — the strategies' verifier calls
and the lazily imported `verify_commit_light` of `initialize` and of the
witness cross-check alike — synchronously, on the event loop's thread."""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from fractions import Fraction

from ..device import DEFAULT_DEVICE, resolve
from ..store.db import DB, MemDB
from . import verifier
from .provider import LightBlockNotFoundError, Provider, ProviderError
from .types import LightBlock
from .verifier import ErrNewValSetCantBeTrusted, VerificationError

_LB_PREFIX = b"lb/"

#: ceiling on concurrent light-block fetches against a single provider
#: (the windowed sequential verifier would otherwise issue up to a full
#: 128-height window at once)
FETCH_CONCURRENCY = 16


async def _as_ready(value):
    return value


async def _gather_cancelling(coros: list) -> list:
    """gather() that bounds concurrency with a semaphore and, on the
    first failure, CANCELS every in-flight sibling and awaits them
    (no stray 'exception was never retrieved' tasks) before re-raising."""
    sem = asyncio.Semaphore(FETCH_CONCURRENCY)

    async def bounded(coro):
        try:
            async with sem:
                return await coro
        except asyncio.CancelledError:
            coro.close()  # no-op if already started; silences never-awaited
            raise

    tasks = [asyncio.ensure_future(bounded(c)) for c in coros]
    try:
        return list(await asyncio.gather(*tasks))
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise


@dataclass(frozen=True)
class TrustOptions:
    """How the client bootstraps trust (reference light/client.go
    TrustOptions): a header hash the user got out of band."""

    period_ns: int
    height: int
    hash: bytes


class Divergence(Exception):
    """A witness provided a conflicting verified header (light-client
    attack in progress; reference detector.go)."""

    def __init__(self, witness: Provider, trace: list[LightBlock], challenging: LightBlock):
        super().__init__(
            f"witness {witness!r} diverged at height {challenging.height}"
        )
        self.witness = witness
        self.trace = trace
        self.challenging = challenging


class TrustedStore:
    """Persisted verified light blocks (reference light/store/db)."""

    def __init__(self, db: DB | None = None):
        self.db = db or MemDB()

    def save(self, lb: LightBlock) -> None:
        self.db.set(_LB_PREFIX + lb.height.to_bytes(8, "big"), lb.encode())

    def get(self, height: int) -> LightBlock | None:
        raw = self.db.get(_LB_PREFIX + height.to_bytes(8, "big"))
        return LightBlock.decode(raw) if raw is not None else None

    def latest(self) -> LightBlock | None:
        for _k, raw in self.db.iterate(
            _LB_PREFIX, _LB_PREFIX + b"\xff" * 8, reverse=True
        ):
            return LightBlock.decode(raw)
        return None

    def lowest(self) -> LightBlock | None:
        for _k, raw in self.db.iterate(_LB_PREFIX, _LB_PREFIX + b"\xff" * 8):
            return LightBlock.decode(raw)
        return None

    def prune(self, keep: int) -> None:
        keys = [k for k, _ in self.db.iterate(_LB_PREFIX, _LB_PREFIX + b"\xff" * 8)]
        for k in keys[:-keep] if keep else keys:
            self.db.delete(k)


class LightClient:
    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: list[Provider] | None = None,
        *,
        store: TrustedStore | None = None,
        trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
        sequential: bool = False,
        logger: logging.Logger | None = None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses or [])
        self.store = store or TrustedStore()
        self.trust_level = trust_level
        self.sequential = sequential
        self.logger = logger or logging.getLogger("light")

    # -- bootstrap -------------------------------------------------------

    async def initialize(self) -> LightBlock:
        """Fetch + pin the trust-options header (reference
        client.go:311 initializeWithTrustOptions)."""
        lb = await self.primary.light_block(self.trust_options.height)
        lb.validate_basic(self.chain_id)
        if lb.header.hash() != self.trust_options.hash:
            raise VerificationError(
                f"trusted header hash mismatch at height {lb.height}: "
                f"{lb.header.hash().hex()} != {self.trust_options.hash.hex()}"
            )
        # the commit must actually be signed by the block's validator set
        from ..types.validation import verify_commit_light

        verify_commit_light(
            self.chain_id,
            lb.validators,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
            device=self.device,
            lane="backfill",
        )
        self.store.save(lb)
        return lb

    # -- main entry ------------------------------------------------------

    async def verify_light_block_at_height(
        self, height: int, now_ns: int | None = None
    ) -> LightBlock:
        """Reference VerifyLightBlockAtHeight client.go:406."""
        now_ns = time.time_ns() if now_ns is None else now_ns
        existing = self.store.get(height) if height else None
        if existing is not None:
            return existing
        latest = self.store.latest()
        if latest is None:
            latest = await self.initialize()
            # the anchor initialize() just pinned may BE the requested
            # height (statesync joiners trust the snapshot height
            # itself) — verifying it "forward" against itself would
            # raise "untrusted height <= trusted"
            existing = self.store.get(height) if height else None
            if existing is not None:
                return existing
        target = await self.primary.light_block(height)
        # Strategies BUFFER newly verified blocks instead of persisting:
        # nothing primary-supplied may reach the trusted store until the
        # witness cross-check has passed, or a divergence would leave
        # forged intermediate headers behind as future trust anchors.
        pending: list[LightBlock] = []
        if target.height < latest.height:
            verified = await self._verify_backwards(target, latest, pending)
        elif self.sequential:
            verified = await self._verify_sequential(latest, target, now_ns, pending)
        else:
            verified = await self._verify_skipping(latest, target, now_ns, pending)
        await self._detect_divergence(verified, now_ns, trust_anchor=latest)
        for lb in pending:
            self.store.save(lb)
        self.store.save(verified)
        return verified

    async def update(self, now_ns: int | None = None) -> LightBlock:
        """Verify the primary's latest header (reference client.go Update)."""
        latest = await self.primary.light_block(0)
        return await self.verify_light_block_at_height(latest.height, now_ns)

    # -- strategies ------------------------------------------------------

    async def _verify_sequential(
        self,
        trusted: LightBlock,
        target: LightBlock,
        now_ns: int,
        pending: list[LightBlock],
    ) -> LightBlock:
        """Reference verifySequential client.go:546, bulked: headers are
        fetched in windows and each window's commits are proven in ONE
        range-batched call (verifier.verify_adjacent_chain) — the
        structural trust chain is still checked strictly in order."""
        window = 128
        h = trusted.height + 1
        while h <= target.height:
            top = min(h + window - 1, target.height)
            # fetches are independent (verification is deferred to the
            # end of the window), so issue them concurrently — over a
            # real provider the serial RPC round-trips dominate, not the
            # signature math. Concurrency is semaphore-bounded and a
            # failed fetch cancels its in-flight siblings.
            chain = await _gather_cancelling(
                [
                    (
                        _as_ready(target)
                        if hh == target.height
                        else self.primary.light_block(hh)
                    )
                    for hh in range(h, top + 1)
                ]
            )
            trusted = verifier.verify_adjacent_chain(
                self.chain_id, trusted, chain, self.trust_options.period_ns, now_ns,
                device=self.device,
            )
            pending.extend(chain)
            h = top + 1
        return trusted

    async def _verify_skipping(
        self,
        trusted: LightBlock,
        target: LightBlock,
        now_ns: int,
        pending: list[LightBlock],
    ) -> LightBlock:
        """Bisection (reference verifySkipping client.go:639): try to jump
        straight to the target; on 1/3-overlap failure, bisect."""
        stack = [target]
        while stack:
            lb = stack[-1]
            try:
                verifier.verify(
                    self.chain_id,
                    trusted,
                    lb,
                    self.trust_options.period_ns,
                    now_ns,
                    trust_level=self.trust_level,
                    device=self.device,
                )
            except ErrNewValSetCantBeTrusted:
                mid = (trusted.height + lb.height) // 2
                if mid in (trusted.height, lb.height):
                    raise VerificationError(
                        "bisection cannot make progress (validator sets too disjoint)"
                    )
                stack.append(await self.primary.light_block(mid))
                continue
            pending.append(lb)
            trusted = lb
            stack.pop()
        return trusted

    async def _verify_backwards(
        self, target: LightBlock, trusted: LightBlock, pending: list[LightBlock]
    ) -> LightBlock:
        """Hash-linkage verification for heights below the trusted head
        (reference client.go:878): walk last_block_id back to the target."""
        cur = trusted
        while cur.height > target.height:
            prev_height = cur.height - 1
            prev = (
                target
                if prev_height == target.height
                else await self.primary.light_block(prev_height)
            )
            prev.validate_basic(self.chain_id)
            if cur.header.last_block_id.hash != prev.header.hash():
                raise VerificationError(
                    f"backwards verification failed at height {prev_height}: "
                    "hash chain broken"
                )
            pending.append(prev)
            cur = prev
        return cur

    # -- witness cross-check --------------------------------------------

    async def _detect_divergence(
        self,
        verified: LightBlock,
        now_ns: int,
        trust_anchor: LightBlock | None = None,
    ) -> None:
        """Compare the newly verified header against every witness
        (reference detector.go:28 detectDivergence). A witness that
        serves a DIFFERENT header for the same height with a valid
        commit is evidence of an attack: LightClientAttackEvidence is
        formed against the divergent chain and submitted to the primary
        and every witness (detector.go:215 newLightClientAttackEvidence),
        whose evidence pools verify and gossip it toward block inclusion."""
        if not self.witnesses:
            return
        for witness in list(self.witnesses):
            try:
                w_lb = await witness.light_block(verified.height)
            except (ProviderError, LightBlockNotFoundError):
                continue  # witness lagging; not divergence
            if w_lb.header.hash() == verified.header.hash():
                continue
            # conflicting header — check it's actually signed (i.e. a
            # real attack, not witness garbage)
            try:
                w_lb.validate_basic(self.chain_id)
                from ..types.validation import verify_commit_light

                verify_commit_light(
                    self.chain_id,
                    w_lb.validators,
                    w_lb.signed_header.commit.block_id,
                    w_lb.height,
                    w_lb.signed_header.commit,
                    device=self.device,
                    lane="backfill",
                )
            except (ValueError, VerificationError):
                self.logger.info("dropping bad witness %r", witness)
                self.witnesses.remove(witness)
                continue
            await self._report_attack(verified, w_lb, trust_anchor, witness)
            raise Divergence(witness, [verified], w_lb)

    async def _report_attack(
        self,
        verified: LightBlock,
        conflicting: LightBlock,
        trust_anchor: LightBlock | None,
        witness: Provider,
    ) -> None:
        """Form LightClientAttackEvidence and submit it to every provider
        (reference detector.go:215). The common height is the last height
        both chains agreed at — the anchor this update verified from."""
        from ..types.evidence import LightClientAttackEvidence

        anchor = trust_anchor or self.store.latest()
        if anchor is None:
            return
        if anchor.height > conflicting.height:
            # backwards verification: the trust anchor sits ABOVE the
            # conflicting height, so no common ancestor height is known —
            # evidence built from it would fail validate_basic everywhere
            self.logger.warning(
                "divergence below trust anchor (%d > %d): no evidence formed",
                anchor.height,
                conflicting.height,
            )
            return
        import dataclasses

        def build(conflicting_lb: LightBlock, trusted_sh) -> object | None:
            try:
                ev = LightClientAttackEvidence(
                    conflicting_block=conflicting_lb,
                    common_height=anchor.height,
                    byzantine_validators=(),
                    total_voting_power=anchor.validators.total_voting_power(),
                    timestamp_ns=anchor.header.time_ns,
                )
                return dataclasses.replace(
                    ev,
                    byzantine_validators=tuple(
                        ev.get_byzantine_validators(anchor.validators, trusted_sh)
                    ),
                )
            except Exception as e:  # noqa: BLE001 — must not mask Divergence
                self.logger.error("failed to build attack evidence: %r", e)
                return None

        # The client cannot know which side forged, so evidence is formed
        # in BOTH directions (reference detector.go handles primary- and
        # witness-side attacks): against the witness's block for the
        # primary's chain, and against the primary's block for the
        # witness's chain — each pool keeps only the one that actually
        # conflicts with its committed header.
        against_witness = build(conflicting, verified.signed_header)
        against_primary = build(verified, conflicting.signed_header)
        targets = []
        if against_witness is not None:
            targets += [
                (p, against_witness)
                for p in [self.primary, *self.witnesses]
                if p is not witness
            ]
        if against_primary is not None:
            targets += [
                (p, against_primary)
                for p in self.witnesses
                if p is not self.primary
            ]
        for provider, ev in targets:
            try:
                await provider.report_evidence(ev)
                self.logger.info(
                    "reported light-client attack (common height %d) to %r",
                    anchor.height,
                    provider,
                )
            except Exception as e:  # noqa: BLE001
                self.logger.warning(
                    "failed to report evidence to %r: %r", provider, e
                )
