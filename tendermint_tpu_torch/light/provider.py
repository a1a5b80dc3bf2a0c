"""Light-block providers (reference light/provider/provider.go; the
port's copy of tendermint_tpu/light/provider.py).

A provider serves LightBlocks for heights and accepts evidence reports.
`BlockStoreProvider` is the in-process implementation over a node's
stores (the analog of the reference's local provider used by tests and
the statesync backfill); the RPC-backed provider waits for the rpc
port. The port has no evidence pool yet: `BlockStoreProvider` records
what is reported in `reported` and hands it to `evidence_pool` when one
is given. `RetryingProvider` wraps any provider with the
shared backoff + circuit-breaker policy (libs/retry) so flaky transports
degrade gracefully instead of surfacing every transient error to the
verification strategies."""

from __future__ import annotations

import random

from ..libs.retry import BackoffPolicy, CircuitBreaker, RetriesExhaustedError, retry
from ..types.block import Commit
from .types import LightBlock, SignedHeader


class ProviderError(Exception):
    pass


class LightBlockNotFoundError(ProviderError):
    pass


class Provider:
    def chain_id(self) -> str:
        raise NotImplementedError

    async def light_block(self, height: int) -> LightBlock:
        """Height 0 = latest. Raises LightBlockNotFoundError."""
        raise NotImplementedError

    async def report_evidence(self, evidence) -> None:
        raise NotImplementedError


class RetryingProvider(Provider):
    """Backoff + circuit breaker around any provider.

    * transient `ProviderError`s are retried under an exponential
      full-jitter policy;
    * `LightBlockNotFoundError` is a DEFINITIVE answer (the peer simply
      lacks the height) — it propagates immediately and does not count
      against the breaker;
    * repeated failures open the breaker and subsequent calls fail fast
      with ProviderError until the half-open probe succeeds."""

    def __init__(
        self,
        inner: Provider,
        *,
        policy: BackoffPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        rng: random.Random | None = None,
    ):
        self.inner = inner
        self.policy = policy or BackoffPolicy(
            base=0.05, cap=2.0, max_attempts=4, deadline=10.0
        )
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout=5.0, name="light-provider"
        )
        self.rng = rng

    def __repr__(self) -> str:
        return f"RetryingProvider({self.inner!r})"

    def chain_id(self) -> str:
        return self.inner.chain_id()

    async def light_block(self, height: int) -> LightBlock:
        if not self.breaker.allow():
            raise ProviderError(
                f"provider {self.inner!r} circuit open (failing fast)"
            )

        async def attempt() -> LightBlock:
            try:
                return await self.inner.light_block(height)
            except LightBlockNotFoundError:
                raise  # definitive: do not retry, do not trip the breaker
            except ProviderError:
                raise
            except Exception as e:  # transport-level surprise: retryable
                raise ProviderError(f"provider failure: {e!r}") from e

        # EVERY exit path below must record an outcome on the breaker: a
        # claimed half-open probe slot is only released by record_success/
        # record_failure, so a silent exit would wedge the breaker open.
        try:
            lb = await retry(
                attempt,
                self.policy,
                retry_on=(ProviderError,),
                give_up_on=(LightBlockNotFoundError,),
                rng=self.rng,
            )
        except LightBlockNotFoundError:
            # definitive answer from a RESPONSIVE provider: the transport
            # is healthy, only the height is absent
            self.breaker.record_success()
            raise
        except RetriesExhaustedError as e:
            self.breaker.record_failure()
            last = e.last if isinstance(e.last, ProviderError) else ProviderError(str(e))
            raise last
        except BaseException:
            # cancellation / unexpected error mid-probe: release the slot
            # pessimistically so a later call can half-open again
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return lb

    async def report_evidence(self, evidence) -> None:
        await self.inner.report_evidence(evidence)


class BlockStoreProvider(Provider):
    """Serve light blocks straight from a block store + state store."""

    def __init__(self, chain_id: str, block_store, state_store, evidence_pool=None):
        self._chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.evidence_pool = evidence_pool
        self.reported: list = []

    def chain_id(self) -> str:
        return self._chain_id

    def _light_block_sync(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)  # commit FOR height
        if commit is None:
            commit = self.block_store.load_seen_commit(height)  # tip block
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise LightBlockNotFoundError(f"no light block at height {height}")
        return LightBlock(SignedHeader(meta.header, commit), vals)

    async def light_block(self, height: int) -> LightBlock:
        return self._light_block_sync(height)

    async def report_evidence(self, evidence) -> None:
        """Hand reported evidence to the backing node's pool (the
        in-process analog of the RPC provider's broadcast_evidence)."""
        self.reported.append(evidence)
        if self.evidence_pool is not None:
            self.evidence_pool.add_evidence(evidence)
