"""Node assembly (reference node/node.go:122 makeNode + node/setup.go).

Wires the full stack: stores → ABCI handshake → mempool/evidence pools →
block executor → consensus SM → reactors (consensus, mempool, evidence,
blocksync) → router over transports. Startup follows the reference's
sync path (node.go:597 OnStart): if block-sync is enabled the node first
replays blocks from peers (range-batched TPU verification) and switches
to live consensus once caught up (blocksync reactor.go:497-504
SwitchToConsensus).

The port's copy of tendermint_tpu/node.py. `Node(..., device=)` resolves
its device once ("cuda" by default, which raises without a card; "cpu"
asks for the host) and hands it to its handshake, `BlockExecutor` (so
`ConsensusState`), `EvidencePool`, block-sync and state-sync reactors,
and to the VerifyHub it acquires (the first acquirer's config wins in a
process, device included). Nothing on the node's path catches a device
error and carries on on the host.

A difference by design, until the RPC slice ports it:
`NodeConfig.rpc_laddr` raises NotImplementedError, and the reference's
`rpc_pprof` is not a field yet.

Chaos-net (`NodeConfig.chaos`, TMTPU_CHAOS_*) wraps every transport in
libs/chaos.py's fault layer and skews the validator's clock; chaos-fs
(`NodeConfig.chaos_fs`, TMTPU_CHAOS_FS_*) runs the WAL on libs/chaosfs.py's
fault-injecting FS and wraps the block and state DBs, as in the reference.
The node reads TMTPU_VERIFYHUB_DISABLE, TMTPU_INGRESS_DISABLE and
TMTPU_CATCHUP_RATE as the reference does."""

from __future__ import annotations

import asyncio
import logging
import os
import random
from dataclasses import dataclass, field

from .abci.application import Application
from .blocksync import BLOCKSYNC_CHANNEL
from .blocksync import messages as bs_msgs
from .blocksync.reactor import BlockSyncReactor
from .config import ConsensusConfig, MempoolConfig, TraceConfig, VerifyHubConfig
from .consensus import messages as cs_msgs
from .consensus.reactor import (
    DATA_CHANNEL,
    STATE_CHANNEL,
    VOTE_CHANNEL,
    VOTE_SET_BITS_CHANNEL,
    ConsensusReactor,
)
from .consensus.replay import Handshaker
from .consensus.state import ConsensusState
from .consensus.wal import WAL
from .crypto import ed25519
from .device import DEFAULT_DEVICE, resolve
from .evidence import EVIDENCE_CHANNEL
from .evidence.pool import EvidencePool
from .evidence.reactor import EvidenceReactor
from .libs.service import Service
from .mempool import MEMPOOL_CHANNEL
from .mempool.ingress import TxIngress
from .mempool.pool import PriorityMempool
from .mempool.reactor import MempoolReactor, decode_txs, encode_txs
from .p2p.peermanager import PeerManager
from .p2p.pex import PEX_CHANNEL, PexReactor
from .p2p.pex import decode_message as pex_decode
from .p2p.pex import encode_message as pex_encode
from .p2p.router import Router
from .p2p.transport import Transport
from .p2p.types import NodeInfo, node_id_from_pubkey
from .privval import PrivValidator
from .proxy import AppConns
from .statesync import (
    CHUNK_CHANNEL,
    LIGHT_BLOCK_CHANNEL,
    PARAMS_CHANNEL,
    SNAPSHOT_CHANNEL,
)
from .statesync import messages as ss_msgs
from .statesync.reactor import StateSyncReactor, SyncConfig
from .state.execution import BlockExecutor
from .state.state import state_from_genesis
from .state.store import StateStore
from .store.blockstore import BlockStore
from .store.db import DB, MemDB
from .types.events import EventBus
from .types.evidence import decode_evidence
from .types.genesis import GenesisDoc


@dataclass
class NodeConfig:
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    block_sync: bool = True
    # when set and the node is at genesis, restore from an app snapshot
    # before block-syncing (reference config statesync.enable)
    state_sync: SyncConfig | None = None
    moniker: str = ""
    wal_dir: str = ""
    # RPC listen address, e.g. "127.0.0.1:26657"; empty disables RPC.
    # Waits for the RPC port: a non-empty address raises
    rpc_laddr: str = ""
    tx_index: bool = True
    # seed mode (reference node/node.go:490 makeSeedNode): run ONLY the
    # p2p layer + PEX crawler, serving addresses and hanging up — no app,
    # no consensus, no stores beyond the address book
    seed_mode: bool = False
    # persistent address book path; empty keeps addresses in memory only
    addr_book_path: str = ""
    # event-loop liveness watchdog (libs/watchdog.py — the asyncio analog
    # of the reference's deadlock-detecting mutexes, internal/libs/sync/
    # deadlock.go): dump all stacks to this dir when the loop wedges
    # longer than watchdog_threshold_s. Empty disables.
    watchdog_dir: str = ""
    watchdog_threshold_s: float = 5.0
    # chaos-net fault injection (libs/chaos.py): a ChaosConfig (or a
    # shared ChaosNetwork for multi-node in-process tests that need
    # partitions) threaded under every transport. None also consults the
    # TMTPU_CHAOS_* env vars so any node can run under fault load without
    # code changes.
    chaos: object | None = None
    # chaos-fs storage fault injection (libs/chaosfs.py): a ChaosFSConfig
    # (TOML section or libs dataclass) or a shared ChaosFS controller;
    # when active the WAL rides the fault-injecting FS and the block/
    # state DBs are wrapped in ChaosDB. None consults TMTPU_CHAOS_FS_*.
    chaos_fs: object | None = None
    # injectable consensus time source (libs/clock.py). None = system
    # clock; when chaos-net carries a clock_skew_ms fault class the node
    # derives its (deterministically skewed) validator clock from it.
    clock: object | None = None
    # VerifyHub (crypto/verify_hub.py): the node acquires the process
    # hub on start and releases it on stop; every vote/proposal/commit
    # signature then routes through the micro-batching scheduler. Live
    # consensus submits on the "live" lane and is packed ahead of
    # block-sync/state-sync "backfill" in every micro-batch; the
    # consensus receive path feeds it through the pipelined ingest
    # (consensus/ingest.py, ConsensusConfig.ingest_*) so many
    # verifications overlap per node.
    verify_hub: VerifyHubConfig = field(default_factory=VerifyHubConfig)
    # flight-recorder tracing (libs/trace.py): the process recorder is
    # configured from the FIRST node's config (env mirrors win); spans
    # are auto-dumped on a loop wedge
    trace: TraceConfig = field(default_factory=TraceConfig)


class Node(Service):
    """A full node: everything between the wire and the ABCI app."""

    def __init__(
        self,
        config: NodeConfig,
        genesis: GenesisDoc,
        app: Application,
        node_key: ed25519.Ed25519PrivKey,
        transports: list[Transport],
        *,
        priv_validator: PrivValidator | None = None,
        block_db: DB | None = None,
        state_db: DB | None = None,
        evidence_db: DB | None = None,
        index_db: DB | None = None,
        logger: logging.Logger | None = None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__("node", logger)
        self.device = resolve(device)
        self.config = config
        _refuse_unported(config)
        self.genesis = genesis
        # `app` may be an in-process Application or a pre-built AppConns
        # (socket/gRPC attachment — reference proxy_app tcp://…, grpc://…)
        self.app_conns = app if isinstance(app, AppConns) else AppConns.local(app)
        self.node_key = node_key
        self.node_id = node_id_from_pubkey(node_key.pub_key())
        self.priv_validator = priv_validator

        self.chaos_fs = self._resolve_chaos_fs()
        block_db = block_db or MemDB()
        state_db = state_db or MemDB()
        if self.chaos_fs is not None:
            block_db = self.chaos_fs.wrap_db(block_db)
            state_db = self.chaos_fs.wrap_db(state_db)
        self.block_store = BlockStore(block_db)
        self.state_store = StateStore(state_db)
        self.evidence_db = evidence_db or MemDB()
        self.index_db = index_db or MemDB()
        self.event_bus = EventBus()

        self.node_info = NodeInfo(
            node_id=self.node_id,
            network=genesis.chain_id,
            moniker=config.moniker or self.node_id[:8],
        )
        addr_book = None
        if config.addr_book_path:
            from .p2p.addrbook import AddressBook

            addr_book = AddressBook(config.addr_book_path)
        self.peer_manager = PeerManager(self.node_id, addr_book=addr_book)
        transports = self._maybe_wrap_chaos(transports)
        self.router = Router(
            self.node_info, self.node_key, self.peer_manager, transports
        )
        self._open_channels()

        # wired in on_start (needs the ABCI handshake first)
        self.consensus: ConsensusState | None = None
        self.cs_reactor: ConsensusReactor | None = None
        self.mempool: PriorityMempool | None = None
        self.ingress: TxIngress | None = None
        self.mempool_reactor: MempoolReactor | None = None
        self.evidence_pool: EvidencePool | None = None
        self.evidence_reactor: EvidenceReactor | None = None
        self.blocksync_reactor: BlockSyncReactor | None = None
        self.statesync_reactor: StateSyncReactor | None = None
        self.pex_reactor: PexReactor | None = None
        self.indexer = None
        self.sink = None
        self.state = None

    def _maybe_wrap_chaos(self, transports: list[Transport]) -> list[Transport]:
        """Thread the chaos-net fault layer under the router when
        configured (NodeConfig.chaos or TMTPU_CHAOS_* env)."""
        from .config import ChaosNetConfig
        from .libs.chaos import ChaosConfig, ChaosNetwork

        self.chaos_net = None
        cfg = self.config.chaos
        if isinstance(cfg, ChaosNetConfig):  # the TOML config section
            if not cfg.enabled:
                # an EXPLICIT disable in the config file wins over any
                # TMTPU_CHAOS_* env vars inherited from the environment
                return transports
            cfg = ChaosConfig(
                seed=cfg.seed,
                drop_rate=cfg.drop_rate,
                delay_ms=cfg.delay_ms,
                duplicate_rate=cfg.duplicate_rate,
                reorder_rate=cfg.reorder_rate,
                corrupt_rate=cfg.corrupt_rate,
                bandwidth_rate=cfg.bandwidth_rate,
                gray_delay_ms=cfg.gray_delay_ms,
                clock_skew_ms=cfg.clock_skew_ms,
                clock_drift=cfg.clock_drift,
            )
        if isinstance(cfg, ChaosNetwork):  # shared controller (test nets)
            self.chaos_net = cfg
        elif isinstance(cfg, ChaosConfig):
            if cfg.enabled():
                self.chaos_net = ChaosNetwork(cfg)
        elif cfg is None:
            env = ChaosConfig.from_env()
            if env.enabled():
                self.chaos_net = ChaosNetwork(env)
        if self.chaos_net is None:
            return transports
        self.logger.warning("chaos-net fault injection ENABLED: %s", self.chaos_net.config)
        return [self.chaos_net.wrap(t, self.node_id) for t in transports]

    def _resolve_chaos_fs(self):
        """Resolve NodeConfig.chaos_fs (TOML section, libs dataclass,
        shared controller, or TMTPU_CHAOS_FS_* env) into a ChaosFS — or
        None for the real filesystem."""
        from .config import ChaosFSConfig as TomlChaosFSConfig
        from .libs.chaosfs import ChaosFS, ChaosFSConfig

        cfg = self.config.chaos_fs
        explicit_enable = False
        if isinstance(cfg, TomlChaosFSConfig):  # the TOML config section
            if not cfg.enabled:
                return None  # explicit disable beats inherited env vars
            explicit_enable = True
            cfg = ChaosFSConfig(
                seed=cfg.seed,
                torn_write_rate=cfg.torn_write_rate,
                torn_offset=cfg.torn_offset,
                lost_fsync_rate=cfg.lost_fsync_rate,
                enospc_rate=cfg.enospc_rate,
                enospc_at_byte=cfg.enospc_at_byte,
                bitrot_rate=cfg.bitrot_rate,
            )
            if not cfg.enabled():
                # enabled=true with every rate zero: the operator opted in
                # but left the rates to the TMTPU_CHAOS_FS_* env vars
                cfg = ChaosFSConfig.from_env()
        if isinstance(cfg, ChaosFS):  # shared controller (test harnesses)
            chaos_fs = cfg
        elif isinstance(cfg, ChaosFSConfig):
            chaos_fs = ChaosFS(cfg) if cfg.enabled() else None
        elif cfg is None:
            env = ChaosFSConfig.from_env()
            chaos_fs = ChaosFS(env) if env.enabled() else None
        else:
            chaos_fs = None
        if chaos_fs is not None:
            self.logger.warning(
                "chaos-fs storage fault injection ENABLED: %s", chaos_fs.config
            )
        elif explicit_enable:
            self.logger.warning(
                "chaos_fs enabled in config but NO fault class armed "
                "(all rates zero and no TMTPU_CHAOS_FS_* env) — running "
                "on the real filesystem"
            )
        return chaos_fs

    # -- channels --------------------------------------------------------

    def _open_channels(self) -> None:
        r = self.router
        self.state_ch = r.open_channel(
            STATE_CHANNEL, name="cs-state", priority=6,
            encode=cs_msgs.encode_message, decode=cs_msgs.decode_message,
        )
        self.data_ch = r.open_channel(
            DATA_CHANNEL, name="cs-data", priority=10,
            encode=cs_msgs.encode_message, decode=cs_msgs.decode_message,
        )
        self.vote_ch = r.open_channel(
            VOTE_CHANNEL, name="cs-vote", priority=7,
            encode=cs_msgs.encode_message, decode=cs_msgs.decode_message,
        )
        self.bits_ch = r.open_channel(
            VOTE_SET_BITS_CHANNEL, name="cs-bits", priority=1,
            encode=cs_msgs.encode_message, decode=cs_msgs.decode_message,
        )
        self.mempool_ch = r.open_channel(
            MEMPOOL_CHANNEL, name="mempool", priority=5,
            encode=encode_txs, decode=decode_txs,
        )
        self.evidence_ch = r.open_channel(
            EVIDENCE_CHANNEL, name="evidence", priority=6,
            encode=lambda ev: ev.encode(), decode=decode_evidence,
        )
        self.blocksync_ch = r.open_channel(
            BLOCKSYNC_CHANNEL, name="blocksync", priority=5,
            encode=bs_msgs.encode_message, decode=bs_msgs.decode_message,
        )
        self.pex_ch = r.open_channel(
            PEX_CHANNEL, name="pex", priority=1,
            encode=pex_encode, decode=pex_decode,
        )
        for cid, name in (
            (SNAPSHOT_CHANNEL, "ss-snapshot"),
            (CHUNK_CHANNEL, "ss-chunk"),
            (LIGHT_BLOCK_CHANNEL, "ss-lb"),
            (PARAMS_CHANNEL, "ss-params"),
        ):
            setattr(
                self,
                name.replace("-", "_") + "_ch",
                r.open_channel(
                    cid, name=name, priority=3,
                    encode=ss_msgs.encode_message, decode=ss_msgs.decode_message,
                ),
            )

    # -- lifecycle -------------------------------------------------------

    async def on_start(self) -> None:
        import os

        from .libs import trace as _trace

        _trace.configure_once(
            enabled=self.config.trace.enabled,
            ring_size=self.config.trace.ring_size,
            out_dir=self.config.trace.dump_dir,
        )
        self.verify_hub = None
        hub_disabled = os.environ.get("TMTPU_VERIFYHUB_DISABLE", "").lower() not in (
            "", "0", "false",
        )
        if (
            self.config.verify_hub.enabled
            and not self.config.seed_mode  # seed nodes verify nothing
            and not hub_disabled
        ):
            from .crypto import verify_hub as vh

            self.verify_hub = vh.acquire_hub(
                device=self.device,
                max_batch=self.config.verify_hub.max_batch,
                window_ms=self.config.verify_hub.window_ms,
                cache_size=self.config.verify_hub.cache_size,
                mesh_scale=self.config.verify_hub.mesh_scale,
                verifyd_sock=self.config.verify_hub.verifyd_sock,
            )
            if self.verify_hub.verifyd_sock:
                self.logger.info(
                    "verification sidecar route enabled: %s",
                    self.verify_hub.verifyd_sock,
                )
        if self.config.watchdog_dir:
            from .libs.watchdog import LoopWatchdog

            self.watchdog = LoopWatchdog(
                self.config.watchdog_dir,
                threshold_s=self.config.watchdog_threshold_s,
            )
            self.watchdog.start()
        if self.config.seed_mode:
            # seed nodes never touch the app or stores: router + PEX only
            self.pex_reactor = PexReactor(
                self.peer_manager,
                self.pex_ch,
                self.peer_manager.subscribe(),
                seed_mode=True,
                rng=random.Random(self.node_id),
            )
            await self.router.start()
            await self.pex_reactor.start()
            return
        await self.app_conns.start()
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(self.genesis)
        handshaker = Handshaker(
            self.state_store, state, self.block_store, self.genesis,
            logger=self.logger.getChild("handshake"),
            device=self.device,
        )
        self.state = await handshaker.handshake(self.app_conns)
        self.state_store.save(self.state)

        self.mempool = PriorityMempool(
            self.config.mempool,
            self.app_conns.mempool,
            height=self.state.last_block_height,
        )
        self.evidence_pool = EvidencePool(
            self.evidence_db, self.state_store, self.block_store,
            device=self.device,
        )
        block_exec = BlockExecutor(
            self.state_store,
            self.app_conns.consensus,
            mempool=self.mempool,
            evidence_pool=self.evidence_pool,
            block_store=self.block_store,
            event_bus=self.event_bus,
            device=self.device,
        )
        import tempfile

        wal = WAL(
            self.config.wal_dir or tempfile.mkdtemp(prefix="cswal-"),
            fs=self.chaos_fs,
            logger=self.logger.getChild("wal"),
        )
        from .consensus.replay import report_wal_repair

        report_wal_repair(wal, self.logger.getChild("replay"))
        clock = self.config.clock
        if self.chaos_net is not None:
            # clock-skew fault class: the validator's own wall clock is
            # deterministically wrong (seeded per node id)
            clock = self.chaos_net.clock_for(self.node_id, base=clock)
        ingress_disabled = os.environ.get(
            "TMTPU_INGRESS_DISABLE", ""
        ).lower() not in ("", "0", "false")
        if self.config.mempool.ingress.enabled and not ingress_disabled:
            # the production front door: RPC broadcast_tx_* and p2p
            # gossip both admit through the staged pipeline (bounded
            # intake, batched signature pre-verify on the hub's backfill
            # lane, per-sender nonce lanes)
            self.ingress = TxIngress(
                self.config.mempool.ingress,
                self.mempool,
                clock=clock,
                logger=self.logger.getChild("ingress"),
            )
            self.logger.info(
                "tx ingress enabled (depth=%d, workers=%d, hub=%s)",
                self.ingress.depth,
                self.ingress.verify_workers,
                "on" if self.verify_hub is not None else "off",
            )
        self.consensus = ConsensusState(
            self.config.consensus,
            self.state,
            block_exec,
            self.block_store,
            priv_validator=self.priv_validator,
            evidence_pool=self.evidence_pool,
            wal=wal,
            event_bus=self.event_bus,
            mempool=self.mempool,
            clock=clock,
        )
        if self.consensus.ingest is not None:
            # two-stage pipelined ingest (consensus/ingest.py): only pays
            # off when the async hub API has a hub to feed — without one
            # stage 1 degrades to an ordered pass-through
            self.logger.info(
                "consensus ingest pipeline enabled (max_inflight=%d, hub=%s)",
                self.consensus.ingest.max_inflight,
                "on" if self.verify_hub is not None else "off",
            )
        # per-peer catch-up pacing (reactor token bucket): bounds the
        # loop share a single lagging (or lying — see the byzantine
        # lying_frames strategy) peer can draw as catch-up service.
        # Unset = unlimited, the historical behavior.
        catchup_rate_env = os.environ.get("TMTPU_CATCHUP_RATE", "")
        self.cs_reactor = ConsensusReactor(
            self.consensus,
            self.state_ch,
            self.data_ch,
            self.vote_ch,
            self.bits_ch,
            self.peer_manager.subscribe(),
            catchup_rate=float(catchup_rate_env) if catchup_rate_env else None,
        )
        self.mempool_reactor = MempoolReactor(
            self.mempool,
            self.mempool_ch,
            self.peer_manager.subscribe(),
            ingress=self.ingress,
        )
        self.evidence_reactor = EvidenceReactor(
            self.evidence_pool, self.evidence_ch, self.peer_manager.subscribe()
        )
        self.blocksync_reactor = BlockSyncReactor(
            self.state,
            block_exec,
            self.block_store,
            self.blocksync_ch,
            self.peer_manager.subscribe(),
            active=self.config.block_sync,
            clock=clock,
            device=self.device,
        )

        self.statesync_reactor = StateSyncReactor(
            self.genesis.chain_id,
            self.app_conns,
            self.state_store,
            self.block_store,
            self.ss_snapshot_ch,
            self.ss_chunk_ch,
            self.ss_lb_ch,
            self.ss_params_ch,
            self.peer_manager.subscribe(),
            initial_height=self.genesis.initial_height,
            device=self.device,
        )

        from .libs.metrics import NodeMetrics, observe_block
        from .types.events import query_for_event

        self.metrics = NodeMetrics()
        blk_sub = self.event_bus.subscribe(
            "metrics", query_for_event("NewBlock"), buffer=64
        )

        async def _metrics_loop():
            while True:
                try:
                    msg = await blk_sub.next()
                    observe_block(
                        self.metrics,
                        msg.data.block,
                        self.consensus.rs if self.consensus else None,
                    )
                    self.metrics.p2p_peers.set(self.peer_manager.num_connected())
                    if self.mempool is not None:
                        self.metrics.mempool_size.set(self.mempool.size())
                    if self.blocksync_reactor is not None:
                        m = self.blocksync_reactor.metrics
                        self.metrics.blocksync_applied._values[()] = m["blocks_applied"]
                        self.metrics.blocksync_sigs._values[()] = m["sigs_verified"]
                        self.metrics.blocksync_bans._values[()] = m["peer_bans"]
                except Exception as e:
                    # metrics must never kill the node, but a silent drop
                    # hides real folding bugs — leave a trace
                    self.logger.debug("metrics fold failed: %r", e)

        self.spawn(_metrics_loop(), name="node.metrics")

        if self.config.tx_index:
            from .state.indexer import IndexerService, KVSink

            self.sink = KVSink(self.index_db)
            self.indexer = IndexerService(self.sink, self.event_bus)
            await self.indexer.start()

        self.pex_reactor = PexReactor(
            self.peer_manager,
            self.pex_ch,
            self.peer_manager.subscribe(),
            # deterministic per node id: same-seed chaos runs replay the
            # same PEX gossip targets
            rng=random.Random(self.node_id),
        )

        await self.router.start()
        await self.pex_reactor.start()
        if self.ingress is not None:
            await self.ingress.start()
        await self.mempool_reactor.start()
        await self.evidence_reactor.start()
        await self.statesync_reactor.start()

        if (
            self.config.state_sync is not None
            and self.state.last_block_height == 0
        ):
            self.spawn(self._run_state_sync(), name="node.statesync")
        else:
            await self.blocksync_reactor.start()
            if self.config.block_sync:
                self.spawn(self._wait_for_sync(), name="node.syncwait")
            else:
                await self._start_consensus()

    async def _run_state_sync(self) -> None:
        """Snapshot restore, then block-sync the gap, then consensus
        (reference OnStart stateSync branch node.go:597)."""
        state = await self.statesync_reactor.sync(self.config.state_sync)
        self.state = state
        # blocksync reactor was constructed against the genesis state;
        # re-point it at the restored one
        self.blocksync_reactor.state = state
        self.blocksync_reactor.pool.height = state.last_block_height + 1
        await self.blocksync_reactor.start()
        self.spawn(self._wait_for_sync(), name="node.syncwait")

    # consensus falling this far behind the best peer triggers a switch
    # back to block-sync (vote gossip can't close unbounded gaps)
    LAG_SWITCH_THRESHOLD = 64

    async def _wait_for_sync(self) -> None:
        """Block-sync until caught up, then switch to consensus
        (reference SwitchToConsensus)."""
        await self.blocksync_reactor.synced.wait()
        # adopt the synced state
        synced_state = self.blocksync_reactor.state
        if synced_state.last_block_height > self.state.last_block_height:
            self.state = synced_state
        self.logger.info(
            "block-sync caught up at height %d; switching to consensus",
            self.state.last_block_height,
        )
        await self._start_consensus()
        self.spawn(self._lag_monitor(), name="node.lag")

    async def _lag_monitor(self) -> None:
        """If live consensus falls far behind the best peer, pause it and
        re-run the block-sync pipeline (reference 0.37+ switch-back)."""
        while True:
            await asyncio.sleep(2.0)
            bs = self.blocksync_reactor
            if bs is None or self.consensus is None or not bs.synced.is_set():
                continue
            lag = bs.pool.max_peer_height() - self.block_store.height()
            if lag <= self.LAG_SWITCH_THRESHOLD:
                continue
            self.logger.info(
                "consensus fell %d blocks behind; switching back to block-sync", lag
            )
            self.consensus.pause()
            state = self.state_store.load() or self.state
            bs.resume(state)
            await bs.synced.wait()
            self.state = bs.state
            self.logger.info(
                "re-synced to height %d; resuming consensus",
                self.state.last_block_height,
            )
            self.consensus.resume_with_state(self.state)

    async def _start_consensus(self) -> None:
        latest = self.state_store.load()
        if latest is not None and latest.last_block_height > self.consensus.rs.height - 1:
            self.consensus.update_to_state(latest)
        await self.cs_reactor.start()
        await self.consensus.start()

    async def on_stop(self) -> None:
        if getattr(self, "watchdog", None) is not None:
            self.watchdog.stop()
        for svc in (
            self.cs_reactor,
            self.consensus,
            self.blocksync_reactor,
            self.statesync_reactor,
            self.evidence_reactor,
            self.mempool_reactor,
            self.ingress,
            self.pex_reactor,
            self.indexer,
            self.router,
        ):
            if svc is not None:
                try:
                    await svc.stop()
                except Exception as e:
                    # best-effort teardown: keep stopping the remaining
                    # services, but say which one failed
                    self.logger.warning("error stopping %s: %r", svc.name, e)
        if self.mempool is not None:
            # out of the process-wide /metrics fold: a stopped node's
            # residents must not haunt the surviving nodes' scrape
            self.mempool.close()
        try:
            self.peer_manager.save_addr_book()
            if not self.config.seed_mode:
                await self.app_conns.stop()
        finally:
            # refcounted: the hub drains (in-flight verdicts resolve)
            # and stops only when the LAST in-process node releases it.
            # In a finally so a teardown error above can't leak the ref
            # (and with it the dispatcher/runner threads) for the rest
            # of the process lifetime.
            if getattr(self, "verify_hub", None) is not None:
                from .crypto import verify_hub as vh

                vh.release_hub()
                self.verify_hub = None

    # -- convenience -----------------------------------------------------

    async def wait_for_height(self, height: int, timeout: float = 60.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while self.block_store.height() < height:
            # a device error ended consensus or block-sync: raise it
            # rather than time out
            for svc in (self.consensus, self.blocksync_reactor):
                err = getattr(svc, "device_error", None)
                if err is not None:
                    raise err
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"node {self.node_id[:8]} stuck at {self.block_store.height()}"
                )
            await asyncio.sleep(0.05)


def _refuse_unported(config: NodeConfig) -> None:
    """Raise on a setting whose subsystem is not ported yet, rather than
    run without it: RPC (the RPC slice)."""
    if config.rpc_laddr:
        raise NotImplementedError(
            "NodeConfig.rpc_laddr: the RPC server waits for the RPC port "
            "(ROADMAP item 17)"
        )
