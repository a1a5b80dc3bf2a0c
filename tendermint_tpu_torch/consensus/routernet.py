"""RouterNet — router-backed chaos consensus harness (the port's copy of
tendermint_tpu/consensus/routernet.py, with `device=`).

`LocalNetwork` (harness.py) wires ConsensusStates together through their
typed broadcast hooks: fast, but it cannot model byte-stream faults
(corruption, bandwidth shaping) and its catch-up relay stands in for the
consensus reactor's real gossip. RouterNet closes that gap — the
credibility gate in ROADMAP's live-chaos item: N full consensus nodes,
each with its own `p2p.Router` over a `ChaosTransport`-wrapped in-memory
transport and a real `ConsensusReactor`, so

  * every fault class in `libs/chaos.py` applies to the live byte path
    (a corrupt frame really hits the codec; a shaped link really queues
    encoded bytes), and
  * catch-up goes through `_send_catchup_commit_vote` /
    `_send_catchup_part` / the catch-up `VoteSetMaj23` exchange — the
    reactor's own gossip, with NO harness relay anywhere.

Topology: full mesh up to `degree`+1 nodes, else a ring plus seeded
random chords (deterministic in `topo_seed`), so 50-150 validator nets
run thousands — not tens of thousands — of peer links and vote gossip
crosses a few relay hops, like a real committee deployment.

Determinism: with a frozen `ManualClock` base (parked at/behind genesis)
the vote-time floor makes every vote/block timestamp a pure function of
(height, genesis_time); with 3 equal-power validators a commit needs ALL
precommits, pinning the commit signer set — two same-seed runs then
produce bit-identical block bytes even while the network is lying (see
tests/test_routernet.py).

The process-wide VerifyHub is acquired for the net's lifetime (like
node.py does): all in-process nodes share its verdict cache, so each
gossip-duplicated signature costs the committee one verification, which
is what makes 150-validator soaks feasible on a CPU image.

`RouterNet(..., device=)` takes the port's device ("cuda" by default,
which raises without a card; "cpu" asks for the host): the net acquires
the process-wide hub on that device, and every node's executor, evidence
pool and state-sync reactor verifies on it. A device error raises: it
ends the consensus task it hit (`ConsensusState.device_error`), and
`wait_for_height` raises it.
"""

from __future__ import annotations

import asyncio
import random

from ..device import DEFAULT_DEVICE, resolve
from ..evidence import EVIDENCE_CHANNEL
from ..evidence.reactor import EvidenceReactor
from ..p2p.memory import MemoryNetwork
from ..p2p.testing import RouterShell
from ..statesync import (
    CHUNK_CHANNEL,
    LIGHT_BLOCK_CHANNEL,
    PARAMS_CHANNEL,
    SNAPSHOT_CHANNEL,
)
from ..statesync import messages as ss_msgs
from ..statesync.reactor import StateSyncReactor, SyncConfig
from ..types.evidence import decode_evidence
from . import messages as m
from .harness import MS, Node, fast_config, make_genesis
from .reactor import (
    DATA_CHANNEL,
    STATE_CHANNEL,
    VOTE_CHANNEL,
    VOTE_SET_BITS_CHANNEL,
    ConsensusReactor,
)


def committee_config(n: int):
    """Consensus timeouts sized for an N-validator in-process committee:
    commit-time gossip storms at 50-150 validators take tens of seconds
    of event-loop time, and a propose/prevote timeout inside that window
    turns into round churn (nil prevotes -> new round -> MORE traffic).
    Generous timers cost nothing on the happy path — steps advance on
    quorum, not timers — so big nets run storm-sized timeouts."""
    from ..config import ConsensusConfig

    scale = max(1, n // 10)
    return ConsensusConfig(
        timeout_propose_ns=(2000 + 2000 * scale) * MS,
        timeout_propose_delta_ns=1000 * MS,
        timeout_prevote_ns=(1500 + 1500 * scale) * MS,
        timeout_prevote_delta_ns=1000 * MS,
        timeout_precommit_ns=(1500 + 1500 * scale) * MS,
        timeout_precommit_delta_ns=1000 * MS,
        timeout_commit_ns=200 * MS,
        skip_timeout_commit=False,
    )


def topology_edges(
    n: int, degree: int, seed: int = 0
) -> list[tuple[int, int]]:
    """Connected, deterministic topology: full mesh while n <= degree+1,
    else a ring (connectivity floor) plus seeded random chords until the
    average degree reaches `degree`. Edges are (i, j) with i < j; the
    lower index dials."""
    if n < 2:
        return []
    if n <= degree + 1:
        return [(i, j) for i in range(n) for j in range(i + 1, n)]
    edges = {(i, (i + 1) % n) for i in range(n)}
    edges = {(min(a, b), max(a, b)) for a, b in edges}
    rng = random.Random(f"routernet-topo:{seed}:{n}:{degree}")
    target = n * degree // 2
    # bounded draw loop: dense-enough graphs could make rejection
    # sampling spin, so cap attempts defensively
    attempts = 0
    while len(edges) < target and attempts < 50 * target:
        attempts += 1
        a = rng.randrange(n)
        b = rng.randrange(n)
        if a == b:
            continue
        edges.add((min(a, b), max(a, b)))
    return sorted(edges)


class RouterNode:
    """One validator (or full node): RouterShell (router + chaos-wrapped
    transport) + harness.Node (app, stores, WAL, consensus SM) + a real
    ConsensusReactor on the four consensus wire channels."""

    def __init__(
        self,
        net: "RouterNet",
        index: int,
        priv_key,
        *,
        fs=None,
        app=None,
        block_store=None,
        state_store=None,
        wal_dir=None,
    ):
        self.net = net
        self.index = index
        self.fs = fs
        self.shell = RouterShell(
            net.memory,
            index,
            net.genesis.chain_id,
            chaos=net.chaos,
            key_seed="routernet",
            moniker=f"rn{index}",
            max_connected=max(64, net.degree * 4),
            peer_queue_size=net.queue_size * 2,
            # routernet_xl: a per-node TCP/UDS transport for cross-process
            # links (chaos-wrapped by the shell like the memory transport)
            extra_transports=net._extra_transports_for(index),
            device=net.device,
        )
        self.node_id = self.shell.node_id
        clock = net._clock_for(self.node_id)
        self.inner = Node(
            net.genesis,
            priv_key,
            config=net.config,
            app=app,
            fs=fs,
            clock=clock,
            block_store=block_store,
            state_store=state_store,
            wal_dir=wal_dir,
            device=net.device,
        )
        r = self.shell.router
        qs = net.queue_size
        self.state_ch = r.open_channel(
            STATE_CHANNEL, name="cs-state", priority=6,
            encode=m.encode_message, decode=m.decode_message, queue_size=qs,
        )
        self.data_ch = r.open_channel(
            DATA_CHANNEL, name="cs-data", priority=10,
            encode=m.encode_message, decode=m.decode_message, queue_size=qs,
        )
        self.vote_ch = r.open_channel(
            VOTE_CHANNEL, name="cs-vote", priority=7,
            encode=m.encode_message, decode=m.decode_message, queue_size=qs,
        )
        self.bits_ch = r.open_channel(
            VOTE_SET_BITS_CHANNEL, name="cs-bits", priority=1,
            encode=m.encode_message, decode=m.decode_message, queue_size=qs,
        )
        # evidence (0x38): priority 6 — same tier as cs-state (node.py's
        # choice): accountability traffic must not starve behind block
        # parts, but never outranks them either. Queue sized like the
        # consensus channels: evidence is rare, but a committee-scale
        # commit storm shares the router's send loop, and a dropped
        # evidence frame costs a whole BROADCAST_SLEEP re-offer cycle.
        self.ev_ch = r.open_channel(
            EVIDENCE_CHANNEL, name="evidence", priority=6,
            encode=lambda ev: ev.encode(), decode=decode_evidence,
            queue_size=qs,
        )
        self.reactor: ConsensusReactor | None = None
        self.ev_reactor: EvidenceReactor | None = None
        # statesync serving (BootFleet): channels + reactor exist only
        # when the net opts in — a plain consensus soak carries zero
        # extra tasks
        self.ss_reactor: StateSyncReactor | None = None
        if net.statesync:
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
                        encode=ss_msgs.encode_message,
                        decode=ss_msgs.decode_message,
                        queue_size=qs,
                    ),
                )

    # convenience mirrors of the inner harness node
    @property
    def cs(self):
        return self.inner.cs

    @property
    def block_store(self):
        return self.inner.block_store

    async def prepare(self) -> None:
        """Build the full stack and bring the ROUTER + REACTORS up, but
        do not start the consensus SM yet — node.py's ordering, so the
        first proposal isn't broadcast into a hook-less void. The net's
        `prepare_hook` (the Byzantine injection seam — see
        consensus/byzantine.py) runs LAST, after the reactor exists and
        before any vote is signed."""
        await self.inner.start(start_consensus=False)
        self.reactor = ConsensusReactor(
            self.inner.cs,
            self.state_ch,
            self.data_ch,
            self.vote_ch,
            self.bits_ch,
            self.shell.peer_manager.subscribe(),
            gossip_sleep=self.net.gossip_sleep,
            stall_refresh_s=self.net.stall_refresh_s,
            catchup_rate=self.net.catchup_rate,
            catchup_burst=self.net.catchup_burst,
        )
        # the evidence reactor rides the same peer-update feed: pending
        # DuplicateVoteEvidence gossips over the real (chaos-wrapped)
        # byte path instead of moving only inside proposed blocks
        self.ev_reactor = EvidenceReactor(
            self.inner.evidence_pool,
            self.ev_ch,
            self.shell.peer_manager.subscribe(),
        )
        if self.net.statesync:
            self.ss_reactor = StateSyncReactor(
                self.net.genesis.chain_id,
                self.inner.app_conns,
                self.inner.state_store,
                self.inner.block_store,
                self.ss_snapshot_ch,
                self.ss_chunk_ch,
                self.ss_lb_ch,
                self.ss_params_ch,
                self.shell.peer_manager.subscribe(),
                initial_height=self.net.genesis.initial_height,
                bootd_config=self.net.bootd_config,
                device=self.net.device,
            )
        await self.shell.router.start()
        await self.reactor.start()
        await self.ev_reactor.start()
        if self.ss_reactor is not None:
            await self.ss_reactor.start()
        if self.net.prepare_hook is not None:
            self.net.prepare_hook(self)

    async def go(self) -> None:
        await self.inner.cs.start()

    async def start(self) -> None:
        await self.prepare()
        await self.go()

    async def stop(self) -> None:
        if self.ss_reactor is not None:
            await self.ss_reactor.stop()
        if self.ev_reactor is not None:
            await self.ev_reactor.stop()
        if self.reactor is not None:
            await self.reactor.stop()
        await self.inner.stop()
        await self.shell.router.stop()

    async def statesync_join(self, sync_config: SyncConfig) -> None:
        """Cold-join the running committee: statesync a snapshot (chunks
        from donors' BootDs, backfill sigs batched onto the hub backfill
        lane), point the consensus SM at the restored state, then start
        it — the reactor's own catch-up gossip closes the snapshot->tip
        gap, exactly like a restarted node."""
        if self.ss_reactor is None:
            raise RuntimeError("statesync_join requires RouterNet(statesync=True)")
        state = await self.ss_reactor.sync(sync_config)
        self.inner.cs.update_to_state(state)
        await self.go()


class RouterNet:
    """N consensus nodes over real routers under one seeded
    ChaosNetwork. First `n_vals` nodes are validators; `n_full` extra
    nodes follow consensus without voting (and exercise the catch-up
    gossip as perpetual non-signers)."""

    def __init__(
        self,
        n_vals: int,
        *,
        n_full: int = 0,
        config=None,
        chaos=None,  # libs/chaos.ChaosNetwork (shared controller)
        base_clock=None,  # frozen ManualClock => bit-reproducible stamps
        key_type: str = "ed25519",
        degree: int = 8,
        topo_seed: int = 0,
        gossip_sleep: float | None = None,
        stall_refresh_s: float | None = None,
        use_hub: bool = True,
        fs_factory=None,  # index -> libs/chaosfs.ChaosFS | None (per node)
        app_factory=None,  # index -> ABCI app | None (default KVStore)
        # called with each RouterNode at the end of prepare() — after
        # router+reactors are up, before the SM signs anything. The
        # Byzantine injection seam (consensus/byzantine.byz_prepare_hook)
        # and the only way a traitor enters a net: RouterNet itself
        # never imports the strategy layer (byz-containment).
        prepare_hook=None,
        # per-peer catch-up pacing (reactor token bucket): None = auto
        # (unlimited on small nets, bounded at committee scale — a byz
        # lag-storm must not let laggards eat the donors' loop share)
        catchup_rate: float | None = None,
        catchup_burst: int | None = None,
        # BootFleet: every node opens the statesync channels and runs a
        # StateSyncReactor (serving through its BootD); joiners built via
        # make_joiner() use the same reactor to cold-join the committee
        statesync: bool = False,
        bootd_config=None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.genesis, self.keys = make_genesis(n_vals, key_type=key_type)
        self.config = config or fast_config()
        self.chaos = chaos
        self.base_clock = base_clock
        self.memory = MemoryNetwork()
        self.degree = degree
        self.n = n_vals + n_full
        # big nets: slower per-peer gossip polls (tasks scale with edges)
        if gossip_sleep is None:
            gossip_sleep = 0.05 if self.n <= 16 else 0.3
        self.gossip_sleep = gossip_sleep
        if stall_refresh_s is None and self.n > 16:
            # committee-scale rounds legitimately idle for many seconds
            # (storm-sized timeouts); a 1s refresh would resend-storm
            self.stall_refresh_s = 4.0 + self.n / 25.0
        else:
            self.stall_refresh_s = stall_refresh_s
        # commit-time storms at committee scale overflow the default
        # 1024-slot channel buffers; a dropped NewRoundStep/HasVote is
        # recoverable (stall-refresh) but costs seconds each time
        self.queue_size = 1024 if self.n <= 16 else 16384
        self.use_hub = use_hub
        self.statesync = statesync
        self.bootd_config = bootd_config
        self._joiners = 0
        self._hub = None
        self._fs_factory = fs_factory
        self._app_factory = app_factory
        self.prepare_hook = prepare_hook
        # catch-up pacing auto-sizing: small nets stay unlimited (every
        # existing smoke keeps its latency); committees bound each
        # lagging peer to a vote budget so N stragglers (or N liars
        # claiming to lag) cost the donor O(N * rate), not O(N * chain)
        if catchup_rate is None and self.n > 16:
            catchup_rate = 64.0 * self.n  # votes/s per lagging peer
        self.catchup_rate = catchup_rate
        self.catchup_burst = catchup_burst
        self._fs: dict[int, object] = {}
        self.edges = topology_edges(self.n, degree, topo_seed)
        # construction hook: routernet_xl's worker slice overrides this
        # to build only the node indices its process hosts
        self.nodes: list[RouterNode] = self._build_nodes()
        # cold nodes built by make_joiner(): stopped with the net but
        # deliberately NOT in self.nodes — heights()/wait_for_height
        # measure the committee, and a joiner mid-statesync has no height
        self.joiners: list[RouterNode] = []

    # -- construction ----------------------------------------------------

    def _clock_for(self, node_id: str):
        if self.chaos is not None:
            # per-validator skew/drift drawn from (seed, node_id): node
            # ids are derived from (key_seed, index), so clocks are
            # identical across same-seed runs
            return self.chaos.clock_for(node_id, base=self.base_clock)
        return self.base_clock

    def _node_fs(self, i: int):
        if i not in self._fs:
            self._fs[i] = (
                self._fs_factory(i) if self._fs_factory is not None else None
            )
        return self._fs[i]

    def _build_nodes(self) -> list[RouterNode]:
        return [self._build_node(i) for i in range(self.n)]

    def _extra_transports_for(self, index: int) -> list:
        """Additional (socket) transports for node `index` — the
        routernet_xl worker-slice seam; in-process nets run none."""
        return []

    def _build_node(
        self, i: int, *, app=None, block_store=None, state_store=None,
        wal_dir=None,
    ) -> RouterNode:
        key = self.keys[i] if i < len(self.keys) else None
        if app is None and self._app_factory is not None:
            app = self._app_factory(i)
        return RouterNode(
            self,
            i,
            key,
            fs=self._node_fs(i),
            app=app,
            block_store=block_store,
            state_store=state_store,
            wal_dir=wal_dir,
        )

    def make_joiner(self, *, app=None, donors: int = 3) -> RouterNode:
        """Build a cold full node (no validator key, empty stores) wired
        to `donors` committee members' addresses. Caller drives the join:
        `await j.prepare(); await j.statesync_join(cfg)`. Requires
        statesync=True (the joiner needs donors serving snapshots)."""
        if not self.statesync:
            raise RuntimeError("make_joiner requires RouterNet(statesync=True)")
        idx = self.n + self._joiners
        self._joiners += 1
        if app is None and self._app_factory is not None:
            app = self._app_factory(idx)
        node = RouterNode(self, idx, None, app=app)
        self.joiners.append(node)
        # deterministic donor choice: spread joiners across the
        # committee so N joiners don't all dogpile node 0
        for k in range(min(donors, self.n)):
            donor = self.nodes[(idx + k) % self.n]
            node.shell.peer_manager.add_address(donor.shell.address())
        return node

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        if self.use_hub:
            from ..crypto import verify_hub as vh

            self._hub = vh.acquire_hub(device=self.device)
        # bring every router+reactor up first, then connect, then start
        # every SM together: node i must not burn rounds alone while
        # node i+1..N-1 are still constructing
        for node in self.nodes:
            await node.prepare()
        self._connect()
        await asyncio.gather(*(node.go() for node in self.nodes))

    def _connect(self) -> None:
        for i, j in self.edges:
            self.nodes[i].shell.peer_manager.add_address(
                self.nodes[j].shell.address()
            )

    async def stop(self) -> None:
        results = await asyncio.gather(
            *(node.stop() for node in self.nodes + self.joiners),
            return_exceptions=True,
        )
        for r in results:
            if isinstance(r, Exception):
                # teardown best-effort; surface in debug logs only
                import logging

                logging.getLogger("routernet").debug("node stop: %r", r)
        if self._hub is not None:
            from ..crypto import verify_hub as vh

            vh.release_hub()
            self._hub = None

    # -- chaos-fs crash model -------------------------------------------

    async def crash(self, i: int) -> None:
        """Kill node i mid-consensus. With a per-node ChaosFS the crash
        model applies: `halt()` first so the clean in-process teardown's
        WAL flush/fsync can't launder durability, then
        `simulate_crash()` drops every un-fsynced byte (possibly tearing
        a record) exactly as if the process had died."""
        node = self.nodes[i]
        fs = node.fs
        if fs is not None:
            fs.halt()
        await node.stop()
        if fs is not None:
            fs.simulate_crash()

    async def restart(self, i: int) -> RouterNode:
        """Bring node i back on the SAME stores/app/WAL dir (and node
        key): WAL open-time repair + ABCI handshake + reactor catch-up
        gossip do the recovery — no harness assistance."""
        old = self.nodes[i]
        node = self._build_node(
            i,
            app=old.inner.app,  # harness.Node wraps it in fresh AppConns
            block_store=old.inner.block_store,
            state_store=old.inner.state_store,
            wal_dir=old.inner.wal_dir,
        )
        self.nodes[i] = node
        await node.start()
        # re-advertise addresses in both directions: the restarted side
        # redials its topology neighbors and they redial it
        for a, b in self.edges:
            if a == i or b == i:
                other = self.nodes[b if a == i else a]
                node.shell.peer_manager.add_address(other.shell.address())
                other.shell.peer_manager.add_address(node.shell.address())
        return node

    # -- observation -----------------------------------------------------

    def heights(self) -> list[int]:
        return [n.block_store.height() for n in self.nodes]

    def min_height(self) -> int:
        return min(self.heights())

    async def wait_for_height(self, height: int, timeout: float = 60.0) -> None:
        await asyncio.gather(
            *(n.cs.wait_for_height(height, timeout) for n in self.nodes)
        )

    def block_fingerprints(self, upto: int, node: int = 0) -> list[bytes]:
        """Encoded block bytes for heights 1..upto from one node — the
        bit-reproducibility fingerprint (header + data + last commit,
        everything on the wire)."""
        store = self.nodes[node].block_store
        out = []
        for h in range(1, upto + 1):
            blk = store.load_block(h)
            out.append(blk.encode() if blk is not None else b"")
        return out

    def app_hash_chain(self, upto: int, node: int = 0) -> list[bytes]:
        store = self.nodes[node].block_store
        out = []
        for h in range(1, upto + 1):
            blk = store.load_block(h)
            out.append(blk.header.app_hash if blk is not None else b"")
        return out

    def hashes_agree(self, upto: int) -> bool:
        """Every node that holds height h agrees on its hash, for all
        h <= upto (a node may legitimately still be catching up)."""
        for h in range(1, upto + 1):
            seen = set()
            for n in self.nodes:
                blk = n.block_store.load_block(h)
                if blk is not None:
                    seen.add(blk.hash())
            if len(seen) > 1:
                return False
        return True
