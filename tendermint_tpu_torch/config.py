"""Node configuration — the port's copy of the sections of
tendermint_tpu/config.py that it reads so far: `VerifyHubConfig`,
`LightDConfig` and `BootDConfig`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VerifyHubConfig:
    """VerifyHub — the node-wide micro-batching signature-verification
    scheduler (crypto/verify_hub.py): the defaults of its constructor.
    The reference's TMTPU_VERIFYHUB_* env overrides wait for the node
    config that reads them; its `enabled`, `mesh_scale` and `verifyd_sock`
    wait for the node and the verifyd sidecar, which are not ported (the
    hub always scales its capacity by the mesh size)."""

    max_batch: int = 512  # per-device dispatch target (sigs queued)
    window_ms: float = 2.0  # micro-batch window ceiling (adaptive below it)
    cache_size: int = 8192  # verified-(pubkey,msg,sig) LRU entries


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
