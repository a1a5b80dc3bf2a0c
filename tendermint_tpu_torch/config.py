"""Node configuration — the port's copy of the sections of
tendermint_tpu/config.py that it reads so far: `ConsensusConfig`,
`MempoolIngressConfig`, `MempoolConfig`, `EvidenceConfig`,
`ChaosNetConfig`, `ChaosFSConfig`, `VerifyHubConfig`, `LightDConfig`,
`BootDConfig` and `TraceConfig`. The rest (P2P, RPC, state sync, the TOML
loader) waits for the cli port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MS = 1_000_000  # ns per millisecond


@dataclass
class ConsensusConfig:
    """Timeouts in nanoseconds (reference config/config.go:1069-1093).
    Per-round growth: timeout = base + delta * round."""

    timeout_propose_ns: int = 3_000 * MS
    timeout_propose_delta_ns: int = 500 * MS
    timeout_prevote_ns: int = 1_000 * MS
    timeout_prevote_delta_ns: int = 500 * MS
    timeout_precommit_ns: int = 1_000 * MS
    timeout_precommit_delta_ns: int = 500 * MS
    timeout_commit_ns: int = 1_000 * MS
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ns: int = 0
    double_sign_check_height: int = 0
    wal_path: str = "data/cs.wal"
    # two-stage pipelined ingest (consensus/ingest.py): stage 1 verifies
    # incoming vote/proposal signatures CONCURRENTLY through the async
    # VerifyHub API (filling device-sized micro-batches from one node),
    # stage 2 applies in strict arrival order via a reorder buffer.
    # ingest_max_inflight bounds the in-flight verifications per node
    # (backpressure into the reactor beyond it). Env mirrors:
    # TMTPU_INGEST_PIPELINE=0 disables, TMTPU_INGEST_INFLIGHT overrides.
    ingest_pipeline: bool = True
    ingest_max_inflight: int = 64
    # commit wire scheme: "per-sig" stores one signature per validator
    # (any key type, EdDSA-batch verified); "bls-aggregate" folds a
    # BLS validator set's precommits into ONE 96-byte aggregate at
    # commit materialization (O(1) signature bytes per commit, pairing
    # verify). Aggregation silently falls back to per-sig when any
    # participating signer is not bls12381 (mixed sets). Env mirror:
    # TMTPU_COMMIT_SCHEME (wins over TOML).
    commit_scheme: str = "per-sig"

    def propose_timeout_ns(self, round_: int) -> int:
        return self.timeout_propose_ns + self.timeout_propose_delta_ns * round_

    def prevote_timeout_ns(self, round_: int) -> int:
        return self.timeout_prevote_ns + self.timeout_prevote_delta_ns * round_

    def precommit_timeout_ns(self, round_: int) -> int:
        return self.timeout_precommit_ns + self.timeout_precommit_delta_ns * round_

    def commit_time_ns(self, t_ns: int) -> int:
        return t_ns + self.timeout_commit_ns


@dataclass
class MempoolIngressConfig:
    """TxIngress — the staged tx admission pipeline in front of the
    priority mempool (mempool/ingress.py): bounded intake with explicit
    backpressure, envelope signature pre-verification micro-batched
    through the VerifyHub backfill lane, per-sender nonce lanes, and
    deterministic in-order admission. Env mirrors win over these values,
    as the reference reads them: TMTPU_INGRESS_DEPTH,
    TMTPU_INGRESS_WORKERS, TMTPU_INGRESS_LANE_DEPTH,
    TMTPU_INGRESS_PARK_MS, TMTPU_INGRESS_CHECKTX_BATCH (TxIngress reads
    them when built)."""

    enabled: bool = True
    # total occupancy bound from accepted submit to insert/park: a full
    # pipeline rejects-with-busy (shed) instead of buffering unboundedly
    depth: int = 2048
    # concurrent stage-A (parse + signature pre-verify) workers; the
    # reorder buffer restores strict arrival order behind them
    verify_workers: int = 8
    # parked out-of-order txs per sender nonce lane
    nonce_lane_depth: int = 32
    # a nonce gap older than this (injected-clock wall domain) evicts
    # every tx parked behind it
    nonce_park_timeout_ms: float = 3000.0
    # stage-B release slice width: consecutive in-release-order entries
    # whose ABCI CheckTx calls are prefetched concurrently before serial
    # in-order admission consumes them; 1 is the serial path
    checktx_batch: int = 1


@dataclass
class MempoolConfig:
    """Reference config/config.go:800-860."""

    size: int = 5000
    max_txs_bytes: int = 1024 * 1024 * 1024
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1024 * 1024
    recheck: bool = True
    broadcast: bool = True
    ttl_num_blocks: int = 0
    ttl_duration_ns: int = 0
    # post-commit re-CheckTx batch width: the resident set is re-checked
    # in concurrent slices of this many ABCI calls (mempool/pool.py
    # _recheck)
    recheck_batch: int = 64
    # max peers each resident tx is gossiped to (0 = unlimited); the
    # reactor also never echoes a tx back to the peer(s) it arrived from
    gossip_fanout: int = 8
    ingress: MempoolIngressConfig = field(default_factory=MempoolIngressConfig)


@dataclass
class EvidenceConfig:
    """Evidence-related consensus params live in types/params.py; this is
    pool sizing."""

    max_pending: int = 1000


@dataclass
class ChaosNetConfig:
    """Chaos-net fault injection (libs/chaos.py). Off by default; when
    `enabled`, every transport the node constructs is wrapped in the
    seeded fault-injection layer. The same knobs are reachable without a
    config file through TMTPU_CHAOS_* env vars (libs/chaos.py docstring);
    a fixed seed makes a fault schedule reproducible."""

    enabled: bool = False
    seed: int = 0
    drop_rate: float = 0.0  # per-message drop probability
    delay_ms: float = 0.0  # p50 extra latency (exponential tail)
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    corrupt_rate: float = 0.0
    bandwidth_rate: float = 0.0  # per-link cap, bytes/sec (queue buildup)
    gray_delay_ms: float = 0.0  # gray failure: fixed slow-but-alive delay
    clock_skew_ms: float = 0.0  # max |per-validator clock skew|
    clock_drift: float = 0.0  # max |rate error| (timeouts fire early/late)


@dataclass
class ChaosFSConfig:
    """Chaos-fs storage fault injection (libs/chaosfs.py). Off by
    default; when `enabled`, the node's WAL rides the seeded
    fault-injecting FS and the block/state DBs are wrapped in `ChaosDB`.
    Env mirror: TMTPU_CHAOS_FS_* (libs/chaosfs.py docstring)."""

    enabled: bool = False
    seed: int = 0
    torn_write_rate: float = 0.0  # P(crash leaves a partial, mid-record tail)
    torn_offset: int = -1  # fixed tear offset into the un-fsynced tail
    lost_fsync_rate: float = 0.0  # P(fsync acked but not durable)
    enospc_rate: float = 0.0  # P(write fails ENOSPC mid-record)
    enospc_at_byte: int = -1  # arm ENOSPC at an exact cumulative byte
    bitrot_rate: float = 0.0  # P(read returns one flipped byte)


@dataclass
class VerifyHubConfig:
    """VerifyHub — the node-wide micro-batching signature-verification
    scheduler (crypto/verify_hub.py): the defaults of its constructor,
    and the node's `[verify_hub]` section. `enabled=False` (or
    TMTPU_VERIFYHUB_DISABLE=1, which the node reads) starts a node without
    the hub. The reference's TMTPU_VERIFYHUB_* and TMTPU_MESH_SCALE env
    overrides wait for the cli port that reads the rest of the config."""

    enabled: bool = True
    max_batch: int = 512  # per-device dispatch target (sigs queued)
    window_ms: float = 2.0  # micro-batch window ceiling (adaptive below it)
    cache_size: int = 8192  # verified-(pubkey,msg,sig) LRU entries
    # scale batch capacity + adaptive window by the device-mesh size, so
    # a mesh of n devices is fed n× batches; False pins one device's
    # max_batch
    mesh_scale: bool = True
    # verification sidecar (crypto/verifyd.py): path of a running verifyd
    # daemon's Unix socket. When set, the hub ships its packed cold
    # micro-batches there instead of dispatching locally — N node
    # processes on one host share the daemon's card. A daemon crash
    # degrades to the hub's own device route through a circuit breaker.
    # Env mirror: TMTPU_VERIFYD_SOCK (wins over this value).
    verifyd_sock: str = ""


@dataclass
class LightDConfig:
    """LightD — the light-client serving layer (light/fleet.py): one
    verified-hop cache + aggregate hop proofs served to a client fleet.
    The reference's TMTPU_LIGHTD_* env overrides are not read: LightD
    takes its knobs from this config alone."""

    #: concurrent verification sessions before arrivals are rejected
    #: with busy (LightDBusyError — the ingress backpressure contract;
    #: cache hits and coalesced same-height joins never shed)
    max_sessions: int = 64
    #: hop proofs kept per LightD, encodings memoized (insertion-evicted)
    proof_cache: int = 1024
    #: fold BLS committees' hop commits into the 96-byte aggregate wire
    #: variant (verified through verify_hub.verify_aggregate — one
    #: pairing per hop); per-sig fallback applies either way for
    #: non-BLS committees
    aggregate_hops: bool = True
    #: sequential (adjacent-chain) verification instead of skipping —
    #: the audit/archival shape; skipping is the serving default
    sequential: bool = False


@dataclass
class BootDConfig:
    """BootD — the snapshot-serving layer (statesync/fleet.py): bounded
    concurrent chunk sessions and a shared per-snapshot chunk cache in
    front of the app's snapshot store, plus the manifest loop that
    commits and prunes served snapshots on a height interval. The
    reference's TMTPU_BOOTD_* env overrides are not read: BootD takes its
    knobs from this config alone."""

    #: concurrent chunk-loading sessions before arrivals are rejected
    #: with busy (BootDBusyError — shed is backpressure, not failure;
    #: cache hits and coalesced same-chunk joins never shed)
    max_sessions: int = 32
    #: chunk bytes kept in the shared cache (entries, insertion-evicted)
    chunk_cache: int = 256
    #: manifest refresh cadence (seconds)
    refresh_s: float = 2.0
    #: serve only snapshots whose height is a multiple of this interval
    snapshot_interval: int = 1
    #: backfilled commits verified per funnel call (the backfill window)
    backfill_batch: int = 64


@dataclass
class TraceConfig:
    """Flight-recorder tracing (libs/trace.py): structured spans in a
    bounded per-process ring buffer, dumped automatically on a loop
    wedge. Env mirrors win over the section: TMTPU_TRACE=0 disables,
    TMTPU_TRACE_RING sizes the ring, TMTPU_TRACE_DIR points auto-dumps
    at a directory."""

    enabled: bool = True
    ring_size: int = 4096  # spans kept; oldest dropped when full
    dump_dir: str = ""  # where auto-dumps land; empty = in-memory only
