"""LightFleet — LightD, the mass light-client serving layer (the port's
copy of tendermint_tpu/light/fleet.py).

``light/`` has had a correct client (bisection verifier, witness
cross-check, divergence detector) since the seed; what it never had is a
SERVING layer. A full node asked the same "prove the chain up to height
H" question by a million light clients answers it a million times — each
answer a skipping-verification hop of ~150 signatures. LightD closes
that gap in the verifyd/ingress mold: one in-process service that owns a

  * **verified-hop cache**: skipping-verification checkpoints are
    verified ONCE (through the VerifyHub's backfill lane, so fleet
    traffic can never displace live consensus votes) and then served to
    every client. N clients syncing to tip share one verification of
    each hop instead of N x 150 signatures. Same-height concurrent
    syncs COALESCE onto one in-flight verification (the hub's
    coalescing shape, one level up);

  * **aggregate hop proofs**: when the committee signs with BLS, the
    hop target's commit is folded via the existing
    ``types.block.aggregate_commit`` machinery into ONE 96-byte G2
    aggregate plus the flag bitmap the per-validator entries already
    carry — verified through the ``crypto.verify_hub.verify_aggregate``
    chokepoint (one pairing product instead of 150 signature checks,
    the arXiv:2302.00418 committee-scale light-verification win), with
    a per-signature fallback for non-BLS committees. The folded commit
    IS the wire format a re-verifying client consumes (``HopProof``);

  * **bounded concurrency with explicit busy-shed**: at most
    ``max_sessions`` verification sessions run at once; an arrival
    beyond that is REJECTED WITH BUSY (``LightDBusyError``, counted as
    shed) — the ingress backpressure contract: never an unbounded
    queue. Cache hits and coalesced joins are not sessions and never
    shed;

  * ``lightd_*`` stats (process-wide registry, `aggregate()`; the
    /metrics fold waits for `NodeMetrics`) and ``light.sync`` trace spans
    on the flight recorder.

Deployment shape: one LightD per serving point (gateway/POP), its
primary pointed at a full node it need not trust, witnesses pointed at
independent nodes. Clients either trust their LightD (it runs the full
divergence detector on their behalf — a detected light-client attack
raises ``Divergence`` and forms ``LightClientAttackEvidence`` exactly
like the embedded client) or re-verify the served ``HopProof`` chain
themselves at one pairing per hop.

Devices: `LightD(..., device=)` and `verify_hop_proof(..., device=)`
("cuda" by default; they raise without a card unless the caller passes
"cpu") run every commit verification on that device — the per-signature
hops through the batch kernels, the aggregate hops through the pairing
kernels. A device error raises; nothing re-verifies on the host.

LightD takes its knobs from `config.LightDConfig` alone: the reference's
TMTPU_LIGHTD_SESSIONS / _PROOF_CACHE / _AGG_HOPS env overrides are not
read.
"""

from __future__ import annotations

import asyncio
import logging
import time
import weakref
from dataclasses import dataclass

from ..device import DEFAULT_DEVICE, resolve
from ..libs import protoenc as pe
from ..libs import trace
from ..libs.metrics import Histogram
from ..libs.service import Service
from ..types.block import aggregate_commit
from . import verifier
from .client import Divergence, LightClient, TrustedStore, TrustOptions
from .provider import Provider
from .types import LightBlock, SignedHeader

logger = logging.getLogger("light.fleet")

#: hop-proof schemes (per-scheme attribution on rejection)
SCHEME_AGGREGATE = "bls-aggregate"
SCHEME_PER_SIG = "per-sig"

#: sync-latency buckets: a warm hop-cache hit is sub-ms; a cold
#: committee-scale BLS hop runs seconds (host hashing and line preparation)
SYNC_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: process-wide registry of live LightDs, summed by `aggregate()`
#: (`libs.metrics.NodeMetrics` folds it at render time)
_lightds: "weakref.WeakSet[LightD]" = weakref.WeakSet()


def aggregate():
    """(summed stats, folded sync-latency hist) across live LightDs, or
    (None, None) when none is running."""
    ds = [d for d in _lightds if d.is_running]
    if not ds:
        return None, None
    keys = ds[0].stats.keys()
    s = {k: sum(d.stats[k] for d in ds) for k in keys}
    s["sessions_now"] = float(sum(d.active_sessions for d in ds))
    counts = [0] * (len(SYNC_BUCKETS) + 1)
    total_sum, total_count = 0.0, 0
    for d in ds:
        h = d.sync_latency
        for j, c in enumerate(h._counts):
            counts[j] += c
        total_sum += h._sum
        total_count += h._count
    return s, (counts, total_sum, total_count)


class LightDBusyError(Exception):
    """Explicit backpressure: every verification session slot is taken —
    back off and resubmit (the reference's RPC proxy, not ported yet,
    maps this to its busy code); nothing was queued."""


class HopProofError(ValueError):
    """A hop proof failed verification. The message leads with the
    scheme tag (``[bls-aggregate]`` / ``[per-sig]``) so a rejection is
    attributable to the pairing path vs the per-signature path from the
    error alone."""

    def __init__(self, scheme: str, detail: str):
        super().__init__(f"[{scheme}] {detail}")
        self.scheme = scheme


@dataclass(frozen=True)
class HopProof:
    """One trusted-header hop, self-contained: the target light block
    (validators + signed header) whose commit is either the BLS
    aggregate wire variant (`agg_sig` set: one 96-byte aggregate, the
    CommitSig flags as the signer bitmap, per-entry signatures empty)
    or the plain per-signature form. A client holding any trusted block
    the hop's skipping rules accept re-verifies it at one pairing (or
    one signature batch) via `verify_hop_proof`."""

    block: LightBlock
    scheme: str

    @property
    def height(self) -> int:
        return self.block.height

    def wire_bytes(self) -> int:
        return len(self.encode())

    def encode(self) -> bytes:
        # memoized (the evidence pattern — safe on a frozen dataclass):
        # a cached proof is served encode()d on every RPC hit, and the
        # encoding covers a committee-scale validator set + commit
        enc = self.__dict__.get("_enc")
        if enc is None:
            enc = pe.message_field(1, self.block.encode()) + pe.string_field(
                2, self.scheme
            )
            object.__setattr__(self, "_enc", enc)
        return enc

    @classmethod
    def decode(cls, data: bytes) -> "HopProof":
        r = pe.Reader(data)
        block = None
        scheme = ""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                block = LightBlock.decode(r.read_bytes())
            elif f == 2:
                scheme = r.read_bytes().decode()
            else:
                r.skip(wt)
        return cls(block, scheme)

    def validate_basic(self, chain_id: str) -> None:
        if self.block is None:
            raise HopProofError(self.scheme or "?", "missing light block")
        if self.scheme not in (SCHEME_AGGREGATE, SCHEME_PER_SIG):
            raise HopProofError(self.scheme or "?", "unknown hop-proof scheme")
        is_agg = self.block.signed_header.commit.is_aggregate()
        if is_agg != (self.scheme == SCHEME_AGGREGATE):
            # a proof lying about its own scheme must die before any
            # crypto: the claimed scheme drives attribution AND the
            # expected wire shape
            raise HopProofError(
                self.scheme,
                "scheme tag does not match the commit wire form "
                f"(agg_sig {'present' if is_agg else 'absent'})",
            )
        self.block.validate_basic(chain_id)


def make_hop_proof(block: LightBlock, *, aggregate_hops: bool = True) -> HopProof:
    """Fold one verified hop target into its wire proof: the BLS
    aggregate variant when every participating signer is BLS (pure data
    transformation — `types.block.aggregate_commit` sums the very
    signatures the validators gossiped), the per-signature form
    otherwise (mixed/Edwards committees — the fallback)."""
    from ..crypto import hash_hub

    with hash_hub.lane_ctx(hash_hub.LANE_LIGHT):
        commit = block.signed_header.commit
        if aggregate_hops:
            try:
                agg = aggregate_commit(commit, block.validators)
                if agg is not commit:
                    block = LightBlock(
                        SignedHeader(block.header, agg), block.validators
                    )
                return HopProof(block, SCHEME_AGGREGATE)
            except ValueError:
                pass  # non-BLS committee: per-sig fallback below
        if commit.is_aggregate():
            return HopProof(block, SCHEME_AGGREGATE)
        return HopProof(block, SCHEME_PER_SIG)


def verify_hop_proof(
    chain_id: str,
    trusted: LightBlock,
    proof: HopProof,
    trusting_period_ns: int,
    now_ns: int | None = None,
    *,
    trust_level=verifier.DEFAULT_TRUST_LEVEL,
    device=DEFAULT_DEVICE,
) -> LightBlock:
    """Client-side re-verification of one served hop against a trusted
    block: the standard skipping/adjacent rules (light/verifier.py),
    whose commit check routes through `verify_hub.verify_aggregate` for
    aggregate proofs (one pairing product + the shared verdict cache)
    and the batched per-sig path otherwise. Raises `HopProofError`
    carrying the scheme tag, so a tampered aggregate is attributable to
    the pairing path and a tampered signature to the per-sig path. The
    commit checks run on `device`."""
    from ..crypto import hash_hub

    dev = resolve(device)
    with hash_hub.lane_ctx(hash_hub.LANE_LIGHT):
        proof.validate_basic(chain_id)
        try:
            verifier.verify(
                chain_id,
                trusted,
                proof.block,
                trusting_period_ns,
                now_ns,
                trust_level=trust_level,
                device=dev,
            )
        except verifier.VerificationError as e:
            raise HopProofError(proof.scheme, str(e)) from e
        return proof.block


class _HopProvider(Provider):
    """LightD's view of its primary: light blocks pass through
    `make_hop_proof` folding BEFORE verification, so a BLS committee's
    hop is verified as ONE aggregate (through the verify_aggregate
    chokepoint the validation funnel routes aggregate commits to) and
    the verified-hop cache persists exactly the bytes `hop_proof`
    serves. Per-sig committees pass through untouched."""

    def __init__(self, inner: Provider, owner: "LightD"):
        self.inner = inner
        self.owner = owner

    def __repr__(self) -> str:
        return f"_HopProvider({self.inner!r})"

    def chain_id(self) -> str:
        return self.inner.chain_id()

    async def light_block(self, height: int) -> LightBlock:
        lb = await self.inner.light_block(height)
        if not self.owner.aggregate_hops:
            return lb
        proof = make_hop_proof(lb, aggregate_hops=True)
        if proof.scheme == SCHEME_AGGREGATE:
            self.owner.stats["agg_hops"] += 1
            return proof.block
        self.owner.stats["per_sig_hops"] += 1
        return lb

    async def report_evidence(self, evidence) -> None:
        await self.inner.report_evidence(evidence)


class _CountingStore(TrustedStore):
    """The verified-hop cache: every save is one checkpoint verified by
    THIS LightD (never by a client). Hit/miss accounting lives at the
    `sync` entry point — the embedded client's own store reads during a
    session must not double-count."""

    def __init__(self, owner: "LightD", db=None):
        super().__init__(db)
        self._owner = owner

    def save(self, lb) -> None:
        from .client import _LB_PREFIX

        # re-saves don't count (the client persists the sync target both
        # via its pending buffer and as the verified head)
        if not self.db.has(_LB_PREFIX + lb.height.to_bytes(8, "big")):
            self._owner.stats["hops_verified"] += 1
        super().save(lb)


class LightD(Service):
    """The light-client serving daemon (module docstring). Owns one
    embedded LightClient whose trusted store is the verified-hop cache;
    every public entry point is async and safe to call concurrently.
    `device` is resolved here and handed to the client, so every hop it
    verifies runs there."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: list[Provider] | None = None,
        *,
        config=None,
        store_db=None,
        logger_: logging.Logger | None = None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__("lightd", logger_ or logger)
        from ..config import LightDConfig

        cfg = config or LightDConfig()
        self.device = resolve(device)
        self.max_sessions = max(1, cfg.max_sessions)
        self.proof_cache_size = max(0, cfg.proof_cache)
        self.aggregate_hops = cfg.aggregate_hops
        self.chain_id = chain_id
        self.store = _CountingStore(self, store_db)
        self.client = LightClient(
            chain_id,
            trust_options,
            _HopProvider(primary, self),
            witnesses,
            store=self.store,
            sequential=cfg.sequential,
            logger=self.logger,
            device=self.device,
        )
        self.active_sessions = 0
        #: height -> future of an in-flight verification: concurrent
        #: same-height syncs coalesce onto one session
        self._inflight: dict[int, asyncio.Future] = {}
        #: height -> HopProof with its encoding memoized (bounded,
        #: insertion-evicted)
        self._proofs: dict[int, HopProof] = {}
        self.sync_latency = Histogram(
            "lightd_sync_latency_seconds",
            "request-to-verified-verdict latency per sync",
            buckets=SYNC_BUCKETS,
        )
        self.stats = {
            "syncs": 0.0,            # sync requests received (incl. shed)
            "sheds": 0.0,            # rejected-with-busy at the session bound
            "coalesced": 0.0,        # joined an in-flight same-height session
            "hop_cache_hits": 0.0,   # store gets answered without verification
            "hop_cache_misses": 0.0,
            "hops_verified": 0.0,    # checkpoints verified + persisted by LightD
            "agg_hops": 0.0,         # hops folded to the BLS aggregate form
            "per_sig_hops": 0.0,     # hops served per-sig (fallback)
            "proofs_served": 0.0,
            "proof_cache_hits": 0.0,
            "divergences": 0.0,      # witness cross-check caught an attack
        }
        _lightds.add(self)

    async def on_start(self) -> None:
        pass

    async def on_stop(self) -> None:
        for fut in self._inflight.values():
            if not fut.done():
                fut.cancel()
        self._inflight.clear()

    # -- serving surface -------------------------------------------------

    async def sync(self, height: int = 0, now_ns: int | None = None) -> LightBlock:
        """Verified light block at `height` (0 = primary tip): the hop
        cache answers warm heights with zero verification; a cold height
        coalesces onto any in-flight same-height session or claims a
        bounded session slot (busy-shed beyond `max_sessions`)."""
        self.stats["syncs"] += 1
        t0 = time.monotonic()
        with trace.span("light", "sync", height=height) as sp:
            if height:
                hit = self.store.get(height)
                if hit is not None:
                    self.stats["hop_cache_hits"] += 1
                    sp.set(outcome="cache_hit")
                    self.sync_latency.observe(time.monotonic() - t0)
                    return hit
            fut = self._inflight.get(height)
            if fut is not None:
                self.stats["coalesced"] += 1
                sp.set(outcome="coalesced")
                lb = await asyncio.shield(fut)
                self.sync_latency.observe(time.monotonic() - t0)
                return lb
            if self.active_sessions >= self.max_sessions:
                self.stats["sheds"] += 1
                sp.set(outcome="shed")
                raise LightDBusyError(
                    f"lightd busy: {self.active_sessions} sessions in flight "
                    f"(max {self.max_sessions}); back off and resubmit"
                )
            # a miss is a request that actually entered a verification
            # session — sheds are counted separately, so the hit rate
            # reflects what was SERVED, not load that bounced
            self.stats["hop_cache_misses"] += 1
            fut = asyncio.get_running_loop().create_future()
            self._inflight[height] = fut
            self.active_sessions += 1
            try:
                lb = await self.client.verify_light_block_at_height(
                    height, now_ns
                )
            except BaseException as e:
                if isinstance(e, Divergence):
                    self.stats["divergences"] += 1
                    sp.set(outcome="divergence")
                if not fut.done():
                    # coalesced waiters share the failure; shield() above
                    # keeps a cancelled WAITER from killing the session
                    fut.set_exception(
                        e if not isinstance(e, asyncio.CancelledError)
                        else LightDBusyError("lightd sync cancelled")
                    )
                fut.exception()  # consumed here; never "never retrieved"
                raise
            else:
                if not fut.done():
                    fut.set_result(lb)
            finally:
                self.active_sessions -= 1
                if self._inflight.get(height) is fut:
                    del self._inflight[height]
            sp.set(outcome="verified", verified_height=lb.height)
            self.sync_latency.observe(time.monotonic() - t0)
            return lb

    async def light_block(self, height: int = 0) -> LightBlock:
        """Provider-shaped alias: every served block is verified."""
        return await self.sync(height)

    async def hop_proof(self, height: int) -> HopProof:
        """The aggregate hop proof for `height`: the verified light
        block (through `sync`, so hop cache + coalescing + busy-shed all
        apply) folded to the committee's best wire form and cached."""
        if height:
            proof = self._proofs.get(height)
            if proof is not None:
                self.stats["proof_cache_hits"] += 1
                self.stats["proofs_served"] += 1
                return proof
        lb = await self.sync(height)
        proof = make_hop_proof(lb, aggregate_hops=self.aggregate_hops)
        if self.proof_cache_size:
            while len(self._proofs) >= self.proof_cache_size:
                self._proofs.pop(next(iter(self._proofs)))
            # keyed by the VERIFIED height — a tip request (height 0)
            # caches under the height it resolved to, never under 0
            self._proofs[lb.height] = proof
        self.stats["proofs_served"] += 1
        return proof

    # -- introspection ---------------------------------------------------

    def latency_snapshot(self) -> tuple[list[int], float, int]:
        h = self.sync_latency
        return list(h._counts), h._sum, h._count

    def hop_cache_hit_rate(self) -> float:
        hits = self.stats["hop_cache_hits"]
        total = hits + self.stats["hop_cache_misses"]
        return hits / total if total else 0.0
