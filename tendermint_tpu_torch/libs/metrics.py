"""Metrics registry with Prometheus text exposition (the analog of the
reference's go-kit/prometheus metrics — one Metrics struct per subsystem
with a nop fallback, reference internal/consensus/metrics.go:19 etc.).

Counters, gauges, and histograms are process-local and lock-free (the
event loop serializes updates); `render()` emits the text format that
Prometheus scrapes, served by the node's /metrics endpoint (with RPC).

The port's copy of tendermint_tpu/libs/metrics.py. `NodeMetrics` renders
the reference's families with the same names, HELP and TYPE lines, and
folds the same process-wide stores at render time (hub, verifyd, ingest,
mempool, LightD, BootD, consensus steps, backend, HashHub, BLS), with
these differences by design (`NOT_RENDERED`, `PORT_ONLY`, `HELP_CHANGED`):

  * the port has no breaker, no degrade and no fallback that re-verifies
    on the host: a device error propagates to the caller. The families
    that count those events are not rendered; what the port counts
    instead is the errors themselves (`RESILIENCE`, rendered as
    ``crypto_device_error_batches`` / ``crypto_device_error_sigs``);
  * the backend fold reads only what crypto/backend_telemetry.py keeps
    (attach attempts and failures, kernel-library cache hits and
    misses, the active device kind "cuda" / "cpu" / "none"); the
    reference's attach-latency list, XLA compile times and mesh stores
    have no counterpart;
  * a HELP line that names the JAX path says what the port's counts.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Counter:
    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] += value

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for labels, v in self._values.items():
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt(v)}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class Gauge:
    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] = value

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for labels, v in self._values.items():
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt(v)}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class Histogram:
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count", "const_labels")

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str = "", buckets=None, const_labels=()):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        # constant labels stamped on every series (a HistogramFamily
        # child carries e.g. ("step", "propose"))
        self.const_labels = tuple(const_labels)

    def observe(self, value: float) -> None:
        self._sum += value
        self._count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def _series(self) -> list[str]:
        base = self.const_labels
        out = []
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self._counts[i]
            out.append(
                f"{self.name}_bucket{_fmt_labels(base + (('le', _fmt(b)),))} {cum}"
            )
        cum += self._counts[-1]
        out.append(f"{self.name}_bucket{_fmt_labels(base + (('le', '+Inf'),))} {cum}")
        out.append(f"{self.name}_sum{_fmt_labels(base)} {_fmt(self._sum)}")
        out.append(f"{self.name}_count{_fmt_labels(base)} {self._count}")
        return out

    def render(self) -> list[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
            *self._series(),
        ]


class HistogramFamily:
    """One histogram name split by a single label (e.g.
    consensus_step_duration_seconds{step=}): children share buckets and
    render under one HELP/TYPE header."""

    __slots__ = ("name", "help", "label", "buckets", "_hists")

    def __init__(self, name: str, label: str, help_: str = "", buckets=None):
        self.name = name
        self.help = help_
        self.label = label
        self.buckets = tuple(buckets or Histogram.DEFAULT_BUCKETS)
        self._hists: dict[str, Histogram] = {}

    def labeled(self, value: str) -> Histogram:
        h = self._hists.get(value)
        if h is None:
            h = self._hists[value] = Histogram(
                self.name, self.help, self.buckets,
                const_labels=((self.label, value),),
            )
        return h

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for value in sorted(self._hists):
            out.extend(self._hists[value]._series())
        return out


# -- process-wide resilience events -----------------------------------------
#
# Crypto backends (crypto/batch.py) are process-wide singletons, not per-node
# objects, so their device errors land in this module-level store;
# NodeMetrics folds them into its Prometheus output at render time.

RESILIENCE: dict[str, float] = {
    "device_error_batches": 0.0,  # device batches that raised (and propagated)
    "device_error_sigs": 0.0,  # signatures in those batches
}


def record_resilience(name: str, value: float = 1.0) -> None:
    RESILIENCE[name] = RESILIENCE.get(name, 0.0) + value


# -- storage-layer events ----------------------------------------------------
#
# WAL objects are created before (and sometimes without) a NodeMetrics, so
# corruption/repair events land here, module-level, exactly like RESILIENCE;
# NodeMetrics folds them in at render time.

STORAGE: dict[str, float] = {
    "wal_corrupt_records": 0.0,  # corrupt/torn records hit during replay
    "wal_repairs": 0.0,  # WAL files truncated to the last whole record
    "wal_truncated_bytes": 0.0,  # damaged bytes rotated aside by repair
}


def record_storage(name: str, value: float = 1.0) -> None:
    STORAGE[name] = STORAGE.get(name, 0.0) + value


#: the package this module belongs to (the lazy folds look their modules
#: up in sys.modules by name)
_PKG = __name__.rsplit(".", 2)[0]

#: the reference's families that the port does not render, by design:
#: breaker, degrade and fallback counts (the port has none) and backend
#: stores its telemetry does not keep
NOT_RENDERED = (
    "crypto_tpu_fallback_batches",
    "crypto_tpu_fallback_sigs",
    "crypto_tpu_breaker_opens",
    "crypto_tpu_breaker_probes",
    "hashhub_fallbacks",
    "hashhub_breaker_skips",
    "backend_fallbacks",
    "backend_breaker_transitions",
    "backend_attach_latency_seconds",
    "backend_compile_seconds",
    "backend_mesh_devices",
    "backend_mesh_degrades",
    "backend_shard_sigs",
)
#: the port's own families: the device errors that propagated
PORT_ONLY = ("crypto_device_error_batches", "crypto_device_error_sigs")
#: families whose HELP line says what the port counts
HELP_CHANGED = (
    "hashhub_device_batches",
    "verifyhub_remote_fallbacks",
    "backend_compile_cache_hits",
    "backend_compile_cache_misses",
)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Registry:
    def __init__(self, namespace: str = "tendermint_tpu"):
        self.namespace = namespace
        self._metrics: list = []

    def counter(self, subsystem: str, name: str, help_: str = "") -> Counter:
        m = Counter(f"{self.namespace}_{subsystem}_{name}", help_)
        self._metrics.append(m)
        return m

    def gauge(self, subsystem: str, name: str, help_: str = "") -> Gauge:
        m = Gauge(f"{self.namespace}_{subsystem}_{name}", help_)
        self._metrics.append(m)
        return m

    def histogram(self, subsystem: str, name: str, help_: str = "", buckets=None) -> Histogram:
        m = Histogram(f"{self.namespace}_{subsystem}_{name}", help_, buckets)
        self._metrics.append(m)
        return m

    def histogram_family(
        self, subsystem: str, name: str, label: str, help_: str = "", buckets=None
    ) -> HistogramFamily:
        m = HistogramFamily(
            f"{self.namespace}_{subsystem}_{name}", label, help_, buckets
        )
        self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: list[str] = []
        for m in self._metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class NodeMetrics:
    """Per-subsystem metric sets (reference */metrics.go)."""

    def __init__(self, registry: Registry | None = None):
        r = self.registry = registry or Registry()
        # consensus (reference internal/consensus/metrics.go:19-60)
        self.consensus_height = r.gauge("consensus", "height", "current height")
        self.consensus_rounds = r.gauge("consensus", "rounds", "round of the current height")
        self.consensus_validators = r.gauge("consensus", "validators", "validator-set size")
        self.consensus_block_interval = r.histogram(
            "consensus", "block_interval_seconds", "time between blocks",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
        )
        self.consensus_txs = r.gauge("consensus", "num_txs", "txs in the last block")
        self.consensus_byzantine = r.counter(
            "consensus", "byzantine_validators", "equivocations seen"
        )
        # mempool + tx ingress (mempool/pool.py, mempool/ingress.py —
        # live pools/ingresses registered process-wide, folded in at
        # render time like the verifyhub families: a tx flood is
        # diagnosable from one /metrics scrape alone)
        self.mempool_size = r.gauge("mempool", "size", "resident txs")
        self.mempool_failed = r.counter("mempool", "failed_txs", "rejected txs")
        self.mempool_bytes = r.gauge("mempool", "bytes", "resident tx bytes")
        self.mempool_tx_admitted = r.counter(
            "mempool", "tx_admitted", "txs inserted into the resident set"
        )
        self.mempool_tx_rejected = r.counter(
            "mempool", "tx_rejected",
            "txs rejected (size/malformed/bad-sig/stale-nonce/CheckTx/full)",
        )
        self.mempool_tx_evicted = r.counter(
            "mempool", "tx_evicted", "residents displaced by higher priority"
        )
        self.mempool_tx_shed = r.counter(
            "mempool", "tx_shed",
            "txs rejected-with-busy at the ingress intake (backpressure)",
        )
        self.mempool_tx_recheck_failed = r.counter(
            "mempool", "tx_recheck_failed",
            "residents dropped by the post-commit batched recheck",
        )
        from ..mempool.ingress import ADMIT_BUCKETS

        self.ingress_submitted = r.counter(
            "ingress", "submitted", "txs accepted into the admission pipeline"
        )
        self.ingress_dedup_drops = r.counter(
            "ingress", "dedup_drops",
            "duplicate submissions dropped before any verify/CheckTx work",
        )
        self.ingress_sig_failed = r.counter(
            "ingress", "sig_failed", "envelope signature pre-verify failures"
        )
        self.ingress_parked = r.counter(
            "ingress", "parked", "nonce-gap arrivals parked in a sender lane"
        )
        self.ingress_park_expired = r.counter(
            "ingress", "park_expired", "parked txs evicted on nonce-gap timeout"
        )
        self.ingress_park_adopted = r.counter(
            "ingress", "park_adopted",
            "fresh-lane parked txs adopted as the lane start on timeout",
        )
        self.ingress_stale_nonce = r.counter(
            "ingress", "stale_nonce", "txs below their sender lane watermark"
        )
        self.ingress_lane_full = r.counter(
            "ingress", "lane_full", "txs rejected busy at a full nonce lane"
        )
        self.ingress_depth = r.gauge(
            "ingress", "depth", "txs currently inside the bounded pipeline"
        )
        self.ingress_parked_now = r.gauge(
            "ingress", "parked_now", "txs currently parked across nonce lanes"
        )
        self.ingress_admit_latency = r.histogram(
            "ingress",
            "admit_latency_seconds",
            "submit-to-insert latency per admitted tx",
            buckets=ADMIT_BUCKETS,
        )
        self.ingress_verify_latency = r.histogram(
            "ingress",
            "verify_latency_seconds",
            "stage-A parse + signature pre-verify latency per tx",
            buckets=ADMIT_BUCKETS,
        )
        # LightD — the light-client serving layer (light/fleet.py; live
        # instances registered process-wide, folded at render time like
        # the ingress family)
        from ..light.fleet import SYNC_BUCKETS

        self.lightd_syncs = r.counter(
            "lightd", "syncs", "sync requests received (incl. shed)"
        )
        self.lightd_sheds = r.counter(
            "lightd", "sheds",
            "syncs rejected-with-busy at the session bound (backpressure)",
        )
        self.lightd_coalesced = r.counter(
            "lightd", "coalesced", "syncs joined onto an in-flight session"
        )
        self.lightd_hop_cache_hits = r.counter(
            "lightd", "hop_cache_hits",
            "syncs answered from the verified-hop cache (zero verification)",
        )
        self.lightd_hops_verified = r.counter(
            "lightd", "hops_verified",
            "skipping-verification checkpoints verified once and cached",
        )
        self.lightd_hop_scheme = r.counter(
            "lightd", "hops_by_scheme",
            "hops served per wire scheme (bls-aggregate vs per-sig)",
        )
        self.lightd_proofs_served = r.counter(
            "lightd", "proofs_served", "aggregate hop proofs served"
        )
        self.lightd_divergences = r.counter(
            "lightd", "divergences",
            "witness cross-checks that detected a light-client attack",
        )
        self.lightd_sessions = r.gauge(
            "lightd", "sessions", "verification sessions in flight right now"
        )
        self.lightd_hop_cache_hit_rate = r.gauge(
            "lightd", "hop_cache_hit_rate", "hits / (hits + misses)"
        )
        self.lightd_sync_latency = r.histogram(
            "lightd",
            "sync_latency_seconds",
            "request-to-verified-verdict latency per sync",
            buckets=SYNC_BUCKETS,
        )
        # BootD — the statesync snapshot-serving layer (statesync/
        # fleet.py; live instances registered process-wide, folded at
        # render time like the lightd family)
        from ..statesync.fleet import BOOT_BUCKETS

        self.bootd_chunk_requests = r.counter(
            "bootd", "chunk_requests", "chunk requests received (incl. shed)"
        )
        self.bootd_chunks_served = r.counter(
            "bootd", "chunks_served", "chunk payloads served"
        )
        self.bootd_chunk_bytes = r.counter(
            "bootd", "chunk_bytes", "chunk payload bytes served"
        )
        self.bootd_sheds = r.counter(
            "bootd", "sheds",
            "chunk requests shed-with-busy at the session bound (backpressure)",
        )
        self.bootd_coalesced = r.counter(
            "bootd", "coalesced", "chunk requests joined onto an in-flight load"
        )
        self.bootd_cache_hits = r.counter(
            "bootd", "cache_hits", "chunks served from the shared snapshot cache"
        )
        self.bootd_store_reads = r.counter(
            "bootd", "store_reads",
            "app store reads (cache misses that actually hit the app)",
        )
        self.bootd_snapshots_served = r.counter(
            "bootd", "snapshots_served", "snapshot manifests served to joiners"
        )
        self.bootd_backfill_heights = r.counter(
            "bootd", "backfill_heights",
            "backfilled heights whose commits passed hub verification",
        )
        self.bootd_backfill_sigs = r.counter(
            "bootd", "backfill_sigs",
            "per-signature commit verifications batched onto the backfill lane",
        )
        self.bootd_backfill_scheme = r.counter(
            "bootd", "backfill_by_scheme",
            "backfilled heights per commit scheme (bls-aggregate vs per-sig)",
        )
        self.bootd_poisoned_rejects = r.counter(
            "bootd", "poisoned_rejects",
            "snapshot restores rejected for poisoned bytes (peer punished)",
        )
        self.bootd_synced = r.counter(
            "bootd", "synced", "state syncs completed by this node"
        )
        self.bootd_sessions = r.gauge(
            "bootd", "sessions", "chunk-serving sessions in flight right now"
        )
        self.bootd_cache_hit_rate = r.gauge(
            "bootd", "cache_hit_rate", "hits / (hits + misses)"
        )
        self.bootd_time_to_synced = r.histogram(
            "bootd",
            "time_to_synced_seconds",
            "discovery-to-restored-state latency per completed sync",
            buckets=BOOT_BUCKETS,
        )
        # event fan-out (libs/pubsub.py drop_on_full subscriptions —
        # the websocket path; folded from pubsub.DROPPED at render)
        self.pubsub_dropped_events = r.counter(
            "pubsub", "dropped_events",
            "events dropped for slow drop-on-full subscribers (websocket fan-out)",
        )
        # p2p
        self.p2p_peers = r.gauge("p2p", "peers", "connected peers")
        self.p2p_msg_recv = r.counter("p2p", "message_receive_bytes_total", "inbound bytes")
        self.p2p_msg_send = r.counter("p2p", "message_send_bytes_total", "outbound bytes")
        # blocksync
        self.blocksync_applied = r.counter("blocksync", "blocks_applied", "blocks applied")
        self.blocksync_sigs = r.counter(
            "blocksync", "sigs_verified", "signatures batch-verified"
        )
        self.blocksync_bans = r.counter(
            "blocksync", "peer_bans", "peers banned for repeated request timeouts"
        )
        # device errors (crypto/batch.py, process-wide; no fallback)
        self.crypto_device_errors = r.counter(
            "crypto", "device_error_batches",
            "device batches that raised (the error propagated; nothing re-verified)",
        )
        self.crypto_device_error_sigs = r.counter(
            "crypto", "device_error_sigs", "signatures in device batches that raised"
        )
        # storage / WAL crash-consistency (consensus/wal.py, folded from
        # the module-level STORAGE events at render time)
        self.wal_corrupt_records = r.counter(
            "wal", "corrupt_records",
            "corrupt or torn WAL records hit during replay (truncation point logged)",
        )
        self.wal_repairs = r.counter(
            "wal", "repairs", "WAL files truncated to the last whole record on open"
        )
        self.wal_truncated_bytes = r.counter(
            "wal", "truncated_bytes", "damaged WAL bytes rotated aside by repair"
        )
        # verify hub (crypto/verify_hub.py — process-wide scheduler,
        # folded in at render time like the resilience events)
        self.verifyhub_dispatches = r.counter(
            "verifyhub", "dispatches", "micro-batches sent to a verifier"
        )
        self.verifyhub_sigs = r.counter(
            "verifyhub", "sigs_dispatched", "signatures verified via the hub"
        )
        self.verifyhub_cache_hits = r.counter(
            "verifyhub", "cache_hits", "verdicts served from the dedup LRU"
        )
        self.verifyhub_coalesced = r.counter(
            "verifyhub", "coalesced", "requests joined onto an in-flight verify"
        )
        self.verifyhub_occupancy = r.gauge(
            "verifyhub", "batch_occupancy", "mean signatures per dispatch"
        )
        self.verifyhub_dispatch_rate = r.gauge(
            "verifyhub", "dispatch_rate", "dispatches per second since hub start"
        )
        self.verifyhub_cache_hit_rate = r.gauge(
            "verifyhub", "cache_hit_rate", "fraction of requests served from cache"
        )
        # two-lane scheduler (live consensus packed ahead of catch-up
        # backfill in every micro-batch); series carry a lane label
        self.verifyhub_lane_submitted = r.counter(
            "verifyhub", "lane_submitted", "unique triples enqueued per lane"
        )
        self.verifyhub_lane_sigs = r.counter(
            "verifyhub", "lane_sigs_dispatched", "signatures dispatched per lane"
        )
        self.verifyhub_lane_queued = r.gauge(
            "verifyhub", "lane_queued", "triples currently queued per lane"
        )
        self.verifyhub_lane_promotions = r.counter(
            "verifyhub",
            "lane_promotions",
            "queued backfill entries pulled into the live lane by a live coalesce",
        )
        # scheme-partitioned dispatch (ed25519/sr25519 share the Edwards
        # kernel; bls12381 runs the pairing path — never one dispatch)
        self.verifyhub_scheme_sigs = r.counter(
            "verifyhub",
            "scheme_sigs",
            "signatures dispatched per signature scheme partition",
        )
        # hash hub (crypto/hash_hub.py — the SHA-256 chokepoint; folded
        # from the module STATS at render time like bls/resilience)
        self.hashhub_batches = r.counter(
            "hashhub", "batches", "sha256_many calls (one per merkle tree level)"
        )
        self.hashhub_messages = r.counter(
            "hashhub", "messages", "messages hashed through batch calls"
        )
        self.hashhub_singles = r.counter(
            "hashhub", "singles", "sha256_one calls (tx keys, leaf-hash cache fills)"
        )
        self.hashhub_occupancy = r.gauge(
            "hashhub", "batch_occupancy", "mean messages per sha256_many call"
        )
        self.hashhub_max_batch = r.gauge(
            "hashhub", "max_batch", "widest batch seen (bucket-ladder headroom)"
        )
        self.hashhub_device_batches = r.counter(
            "hashhub", "device_batches", "batches served by the SHA-256 kernel (B8)"
        )
        self.hashhub_device_messages = r.counter(
            "hashhub", "device_messages", "messages hashed on the device route"
        )
        self.hashhub_lane_batches = r.counter(
            "hashhub", "lane_batches", "sha256_many calls per lane"
        )
        self.hashhub_lane_messages = r.counter(
            "hashhub", "lane_messages", "messages hashed per lane (singles included)"
        )
        # remote verification sidecar, client side (crypto/verifyd.py —
        # module-level stores like RESILIENCE: the remote route is
        # process-wide, shared by every in-process hub)
        self.verifyhub_remote_dispatches = r.counter(
            "verifyhub", "remote_dispatches",
            "micro-batches answered by the verifyd sidecar over the socket",
        )
        self.verifyhub_remote_fallbacks = r.counter(
            "verifyhub", "remote_fallbacks",
            "micro-batches verified on the hub's own device because the "
            "sidecar was unreachable, busy, or scheme-incompatible",
        )
        from ..crypto.verifyd import REMOTE_RTT

        self.verifyhub_remote_rtt = r.histogram(
            "verifyhub",
            "remote_rtt_seconds",
            "verifyd socket round-trip per remote batch",
            buckets=REMOTE_RTT.buckets,
        )
        # verifyd daemon side (folded from in-process daemons; a
        # standalone daemon serves the same numbers over its protocol
        # `stats` request / `cli verifyd --stats`)
        self.verifyd_clients = r.gauge(
            "verifyd", "clients", "client connections currently open"
        )
        self.verifyd_requests = r.counter(
            "verifyd", "requests", "verify_batch requests served"
        )
        self.verifyd_occupancy = r.gauge(
            "verifyd", "batch_occupancy",
            "mean signatures per daemon-hub dispatch (cross-client packed)",
        )
        self.verifyd_cross_client_packs = r.counter(
            "verifyd", "cross_client_packs",
            "device dispatches that mixed signatures from >1 client process",
        )
        self.verifyd_shed = r.counter(
            "verifyd", "shed",
            "requests answered busy at the bounded in-flight cap",
        )
        # BLS aggregate-commit path (crypto/bls.STATS, folded at render)
        self.bls_verifies = r.counter(
            "bls", "verifies", "single BLS signature verifications (memo misses)"
        )
        self.bls_verify_failures = r.counter(
            "bls", "verify_failures", "failed single BLS verifications"
        )
        self.bls_aggregate_verifies = r.counter(
            "bls", "aggregate_verifies", "aggregate-commit pairing-product checks"
        )
        self.bls_aggregate_failures = r.counter(
            "bls", "aggregate_failures", "rejected aggregate-commit checks"
        )
        self.bls_aggregate_signers = r.counter(
            "bls", "aggregate_signers", "signers covered by aggregate checks"
        )
        self.bls_pop_checks = r.counter(
            "bls", "pop_checks", "proof-of-possession verifications (genesis)"
        )
        # bucket layout shared with the hub's live histogram (one source
        # of truth — _fold_verify_hub copies counts index-for-index)
        from ..crypto.verify_hub import LATENCY_BUCKETS

        self.verifyhub_queue_latency = r.histogram(
            "verifyhub",
            "queue_latency_seconds",
            "submit-to-dispatch wait per request",
            buckets=LATENCY_BUCKETS,
        )
        # pipelined consensus ingest (consensus/ingest.py — per-CS
        # pipelines registered process-wide, folded in at render time)
        self.consensus_ingest_inflight = r.gauge(
            "consensus_ingest",
            "inflight",
            "messages submitted to the ingest pipeline and not yet applied",
        )
        self.consensus_ingest_submitted = r.counter(
            "consensus_ingest", "submitted", "messages entering stage-1 verify"
        )
        self.consensus_ingest_released = r.counter(
            "consensus_ingest",
            "released",
            "messages released in arrival order to the state machine",
        )
        self.consensus_ingest_dedup_drops = r.counter(
            "consensus_ingest",
            "dedup_drops",
            "gossip duplicates dropped against the vote-set before verification",
        )
        self.consensus_ingest_pre_verified = r.counter(
            "consensus_ingest",
            "pre_verified",
            "messages whose signature was proven in stage 1 (not re-checked at apply)",
        )
        self.consensus_ingest_verify_latency = r.histogram(
            "consensus_ingest",
            "verify_latency_seconds",
            "stage-1 intake-to-verdict wait per message",
            buckets=LATENCY_BUCKETS,
        )
        self.consensus_ingest_reorder_wait = r.histogram(
            "consensus_ingest",
            "reorder_wait_seconds",
            "verdict-to-in-order-release wait per message",
            buckets=LATENCY_BUCKETS,
        )
        # consensus step latency (consensus/state.py per-CS histograms
        # registered process-wide, folded in at render time)
        from ..consensus.state import STEP_BUCKETS, STEP_LABELS

        self.consensus_step_duration = r.histogram_family(
            "consensus",
            "step_duration_seconds",
            "step",
            "time spent per consensus step (propose/prevote/precommit/commit)",
            buckets=STEP_BUCKETS,
        )
        for label in STEP_LABELS:  # every step series present from scrape 1
            self.consensus_step_duration.labeled(label)
        self.consensus_time_to_commit = r.histogram(
            "consensus",
            "time_to_commit_seconds",
            "height start to committed block",
            buckets=STEP_BUCKETS,
        )
        # backend attach telemetry (crypto/backend_telemetry.py —
        # process-wide like the crypto backends themselves)
        self.backend_attach_attempts = r.counter(
            "backend", "attach_attempts", "accelerator backend init attempts"
        )
        self.backend_attach_failures = r.counter(
            "backend", "attach_failures", "init attempts that raised or hung"
        )
        self.backend_active = r.gauge(
            "backend", "active", "1 for the verifier kind currently routing batches"
        )
        self.backend_compile_cache_hits = r.counter(
            "backend", "compile_cache_hits",
            "kernel libraries loaded as built from build/torch_ext/ (no nvcc)",
        )
        self.backend_compile_cache_misses = r.counter(
            "backend", "compile_cache_misses", "kernel libraries nvcc built in this process"
        )
        # abci
        self.abci_latency = r.histogram(
            "abci", "connection_latency_seconds", "app call latency"
        )

    def _fold_verify_hub(self) -> None:
        from ..crypto.verify_hub import running_hub

        hub = running_hub()
        if hub is None:
            return
        s = hub.stats()
        self.verifyhub_dispatches._values[()] = s["dispatches"]
        self.verifyhub_sigs._values[()] = s["dispatched_sigs"]
        self.verifyhub_cache_hits._values[()] = s["cache_hits"]
        self.verifyhub_coalesced._values[()] = s["coalesced"]
        self.verifyhub_occupancy.set(round(s["mean_occupancy"], 3))
        self.verifyhub_dispatch_rate.set(round(s["dispatch_rate"], 3))
        self.verifyhub_cache_hit_rate.set(round(s["cache_hit_rate"], 4))
        for lane in ("live", "backfill"):
            self.verifyhub_lane_submitted._values[(("lane", lane),)] = s[
                f"lane_{lane}_submitted"
            ]
            self.verifyhub_lane_sigs._values[(("lane", lane),)] = s[
                f"lane_{lane}_dispatched"
            ]
            self.verifyhub_lane_queued.set(s[f"lane_{lane}_queued"], lane=lane)
        self.verifyhub_lane_promotions._values[()] = s["lane_promotions"]
        for scheme in ("edwards", "bls"):
            self.verifyhub_scheme_sigs._values[(("scheme", scheme),)] = s[
                f"scheme_{scheme}_sigs"
            ]
        # consistent snapshot taken under the hub lock (a mid-copy
        # dispatch would otherwise skew _count against the bucket sums)
        counts, sum_, count = hub.latency_snapshot()
        dst = self.verifyhub_queue_latency
        if len(counts) == len(dst._counts):  # same LATENCY_BUCKETS layout
            dst._counts = counts
            dst._sum = sum_
            dst._count = count

    def _fold_verifyd(self) -> None:
        from ..crypto import verifyd

        # client side: process-wide module stores (always present)
        cs = verifyd.CLIENT_STATS
        self.verifyhub_remote_dispatches._values[()] = cs["remote_dispatches"]
        self.verifyhub_remote_fallbacks._values[()] = cs["remote_fallbacks"]
        counts, sum_, count = verifyd.remote_rtt_snapshot()
        dst = self.verifyhub_remote_rtt
        if len(counts) == len(dst._counts):
            dst._counts = counts
            dst._sum = sum_
            dst._count = count
        # daemon side: only when a daemon runs in THIS process
        agg = verifyd.aggregate_daemons()
        if agg is None:
            return
        self.verifyd_clients.set(agg["clients"])
        self.verifyd_requests._values[()] = agg["requests"]
        self.verifyd_occupancy.set(round(agg["batch_occupancy"], 3))
        self.verifyd_cross_client_packs._values[()] = agg["cross_client_packs"]
        self.verifyd_shed._values[()] = agg["shed"]

    def _fold_ingest(self) -> None:
        from ..consensus import ingest

        s, verify_hist, reorder_hist = ingest.aggregate()
        if s is None:
            return
        self.consensus_ingest_inflight.set(s["inflight"])
        self.consensus_ingest_submitted._values[()] = s["submitted"]
        self.consensus_ingest_released._values[()] = s["released"]
        self.consensus_ingest_dedup_drops._values[()] = s["dedup_drops"]
        self.consensus_ingest_pre_verified._values[()] = s["pre_verified"]
        for src, dst in (
            (verify_hist, self.consensus_ingest_verify_latency),
            (reorder_hist, self.consensus_ingest_reorder_wait),
        ):
            counts, sum_, count = src
            if len(counts) == len(dst._counts):  # same LATENCY_BUCKETS layout
                dst._counts = counts
                dst._sum = sum_
                dst._count = count

    def _fold_mempool(self) -> None:
        from ..libs import pubsub
        from ..mempool import ingress as mp_ingress
        from ..mempool import pool as mp_pool

        self.pubsub_dropped_events._values[()] = pubsub.DROPPED["events"]
        agg = mp_pool.aggregate_pools()
        ing, admit_hist, verify_hist = mp_ingress.aggregate()
        if agg is not None:
            stats, size, size_bytes = agg
            self.mempool_size.set(size)
            self.mempool_bytes.set(size_bytes)
            self.mempool_tx_admitted._values[()] = stats["admitted"]
            self.mempool_tx_evicted._values[()] = stats["evicted"]
            self.mempool_tx_recheck_failed._values[()] = stats["recheck_failed"]
            # rejections: pool-level (size/CheckTx/full) + ingress-level
            # (malformed/bad-sig/stale-nonce/park-expired) are disjoint —
            # an ingress rejection never reaches the pool
            self.mempool_tx_rejected._values[()] = stats["rejected"] + (
                ing["rejected"] if ing is not None else 0.0
            )
        if ing is None:
            return
        self.mempool_tx_shed._values[()] = ing["shed"]
        self.ingress_submitted._values[()] = ing["submitted"]
        self.ingress_dedup_drops._values[()] = ing["dedup_drops"]
        self.ingress_sig_failed._values[()] = ing["sig_failed"]
        self.ingress_parked._values[()] = ing["parked"]
        self.ingress_park_expired._values[()] = ing["park_expired"]
        self.ingress_park_adopted._values[()] = ing["park_adopted"]
        self.ingress_stale_nonce._values[()] = ing["stale_nonce"]
        self.ingress_lane_full._values[()] = ing["lane_full"]
        self.ingress_depth.set(ing["depth"])
        self.ingress_parked_now.set(ing["parked_now"])
        for src, dst in (
            (admit_hist, self.ingress_admit_latency),
            (verify_hist, self.ingress_verify_latency),
        ):
            counts, sum_, count = src
            if len(counts) == len(dst._counts):  # same ADMIT_BUCKETS layout
                dst._counts = counts
                dst._sum = sum_
                dst._count = count

    def _fold_lightd(self) -> None:
        from ..light import fleet

        s, hist = fleet.aggregate()
        if s is None:
            return
        self.lightd_syncs._values[()] = s["syncs"]
        self.lightd_sheds._values[()] = s["sheds"]
        self.lightd_coalesced._values[()] = s["coalesced"]
        self.lightd_hop_cache_hits._values[()] = s["hop_cache_hits"]
        self.lightd_hops_verified._values[()] = s["hops_verified"]
        self.lightd_hop_scheme._values[(("scheme", "bls-aggregate"),)] = s[
            "agg_hops"
        ]
        self.lightd_hop_scheme._values[(("scheme", "per-sig"),)] = s[
            "per_sig_hops"
        ]
        self.lightd_proofs_served._values[()] = s["proofs_served"]
        self.lightd_divergences._values[()] = s["divergences"]
        self.lightd_sessions.set(s["sessions_now"])
        lookups = s["hop_cache_hits"] + s["hop_cache_misses"]
        self.lightd_hop_cache_hit_rate.set(
            round(s["hop_cache_hits"] / lookups, 4) if lookups else 0.0
        )
        counts, sum_, count = hist
        dst = self.lightd_sync_latency
        if len(counts) == len(dst._counts):  # same SYNC_BUCKETS layout
            dst._counts = counts
            dst._sum = sum_
            dst._count = count

    def _fold_bootd(self) -> None:
        from ..statesync import fleet

        s, hist = fleet.aggregate()
        if s is None:
            return
        self.bootd_chunk_requests._values[()] = s["chunk_requests"]
        self.bootd_chunks_served._values[()] = s["chunks_served"]
        self.bootd_chunk_bytes._values[()] = s["chunk_bytes"]
        self.bootd_sheds._values[()] = s["sheds"]
        self.bootd_coalesced._values[()] = s["coalesced"]
        self.bootd_cache_hits._values[()] = s["cache_hits"]
        self.bootd_store_reads._values[()] = s["store_reads"]
        self.bootd_snapshots_served._values[()] = s["snapshots_served"]
        self.bootd_backfill_heights._values[()] = s["backfill_heights"]
        self.bootd_backfill_sigs._values[()] = s["backfill_sigs"]
        self.bootd_backfill_scheme._values[(("scheme", "bls-aggregate"),)] = s[
            "backfill_agg_heights"
        ]
        self.bootd_backfill_scheme._values[(("scheme", "per-sig"),)] = (
            s["backfill_heights"] - s["backfill_agg_heights"]
        )
        self.bootd_poisoned_rejects._values[()] = s["poisoned_rejects"]
        self.bootd_synced._values[()] = s["synced"]
        self.bootd_sessions.set(s["sessions_now"])
        lookups = s["cache_hits"] + s["cache_misses"]
        self.bootd_cache_hit_rate.set(
            round(s["cache_hits"] / lookups, 4) if lookups else 0.0
        )
        counts, sum_, count = hist
        dst = self.bootd_time_to_synced
        if len(counts) == len(dst._counts):  # same BOOT_BUCKETS layout
            dst._counts = counts
            dst._sum = sum_
            dst._count = count

    def _fold_steps(self) -> None:
        from ..consensus.state import aggregate_step_metrics

        per_step, ttc = aggregate_step_metrics()
        if per_step is None:
            return
        for label, (counts, sum_, count) in per_step.items():
            dst = self.consensus_step_duration.labeled(label)
            if len(counts) == len(dst._counts):
                dst._counts = counts
                dst._sum = sum_
                dst._count = count
        counts, sum_, count = ttc
        dst = self.consensus_time_to_commit
        if len(counts) == len(dst._counts):
            dst._counts = counts
            dst._sum = sum_
            dst._count = count

    def _fold_backend(self) -> None:
        from ..crypto import backend_telemetry as bt

        self.backend_attach_attempts._values[()] = bt.BACKEND["attach_attempts"]
        self.backend_attach_failures._values[()] = bt.BACKEND["attach_failures"]
        self.backend_compile_cache_hits._values[()] = bt.BACKEND[
            "compile_cache_hits"
        ]
        self.backend_compile_cache_misses._values[()] = bt.BACKEND[
            "compile_cache_misses"
        ]
        active = bt.ACTIVE["kind"]
        for kind in ("cuda", "cpu", "none"):
            self.backend_active.set(1.0 if kind == active else 0.0, kind=kind)

    def render(self) -> str:
        # fold the process-wide device-error events in at scrape time
        self.crypto_device_errors._values[()] = RESILIENCE["device_error_batches"]
        self.crypto_device_error_sigs._values[()] = RESILIENCE["device_error_sigs"]
        self.wal_corrupt_records._values[()] = STORAGE["wal_corrupt_records"]
        self.wal_repairs._values[()] = STORAGE["wal_repairs"]
        self.wal_truncated_bytes._values[()] = STORAGE["wal_truncated_bytes"]
        self._fold_verify_hub()
        self._fold_verifyd()
        self._fold_ingest()
        self._fold_mempool()
        self._fold_lightd()
        self._fold_bootd()
        self._fold_steps()
        self._fold_backend()
        self._fold_bls()
        self._fold_hashhub()
        return self.registry.render()

    def _fold_hashhub(self) -> None:
        # same lazy-import contract as _fold_bls: the hub module loads
        # with crypto anyway, but a scrape must never be the importer
        import sys

        hh = sys.modules.get(_PKG + ".crypto.hash_hub")
        if hh is None:
            return
        s = hh.STATS
        self.hashhub_batches._values[()] = s["batches"]
        self.hashhub_messages._values[()] = s["messages"]
        self.hashhub_singles._values[()] = s["singles"]
        self.hashhub_occupancy.set(
            round(s["messages"] / s["batches"], 3) if s["batches"] else 0.0
        )
        self.hashhub_max_batch.set(s["max_batch"])
        self.hashhub_device_batches._values[()] = s["device_batches"]
        self.hashhub_device_messages._values[()] = s["device_messages"]
        for lane, n in s["lane_batches"].items():
            self.hashhub_lane_batches._values[(("lane", lane),)] = n
        for lane, n in s["lane_messages"].items():
            self.hashhub_lane_messages._values[(("lane", lane),)] = n

    def _fold_bls(self) -> None:
        # only fold when the BLS module is already loaded: importing it
        # at scrape time would pay the bls_math derivations on nodes
        # that never touch a BLS key
        import sys

        bls = sys.modules.get(_PKG + ".crypto.bls")
        if bls is None:
            return
        s = bls.STATS
        self.bls_verifies._values[()] = s["verifies"]
        self.bls_verify_failures._values[()] = s["verify_failures"]
        self.bls_aggregate_verifies._values[()] = s["aggregate_verifies"]
        self.bls_aggregate_failures._values[()] = s["aggregate_failures"]
        self.bls_aggregate_signers._values[()] = s["aggregate_signers"]
        self.bls_pop_checks._values[()] = s["pop_checks"]


class _LastBlock:
    time: float | None = None


def observe_block(metrics: NodeMetrics, block, rs=None) -> None:
    """Update consensus metrics on a committed block."""
    metrics.consensus_height.set(block.header.height)
    metrics.consensus_txs.set(len(block.txs))
    now = time.monotonic()
    if _LastBlock.time is not None:
        metrics.consensus_block_interval.observe(now - _LastBlock.time)
    _LastBlock.time = now
    if rs is not None:
        metrics.consensus_rounds.set(rs.round)
        if rs.validators is not None:
            metrics.consensus_validators.set(len(rs.validators))
