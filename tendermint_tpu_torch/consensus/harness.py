"""In-process consensus test network (the analog of the reference's
internal/consensus/common_test.go fixtures; the port's copy of
tendermint_tpu/consensus/harness.py): N ConsensusStates wired directly to
each other's input queues through their broadcast hooks — no sockets,
whole consensus protocol exercised in one event loop. The real p2p
reactor replaces the hook wiring in production.

`Node(..., device=)` and `LocalNetwork(..., device=)` default to "cuda"
and raise without a card; "cpu" runs every block's LastCommit check (and
the evidence pool's and the handshake's) on the host. Vote and proposal
signatures go through the running VerifyHub when one is acquired, and
through the host otherwise, as in the reference."""

from __future__ import annotations

import asyncio
import logging
import tempfile

from ..abci.kvstore import KVStoreApp
from ..config import ConsensusConfig, MempoolConfig
from ..consensus import messages as m
from ..consensus.replay import Handshaker
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL
from ..device import DEFAULT_DEVICE, resolve
from ..evidence.pool import EvidencePool
from ..mempool.pool import PriorityMempool
from ..privval import MockPV
from ..proxy import AppConns
from ..state.execution import BlockExecutor
from ..state.state import state_from_genesis
from ..state.store import StateStore
from ..store.blockstore import BlockStore
from ..store.db import MemDB
from ..testing import det_priv_keys
from ..types.events import EventBus
from ..types.genesis import GenesisDoc, GenesisValidator

MS = 1_000_000

# every harness genesis is stamped here; chaos runs park a frozen
# ManualClock at/behind it so the vote-time floor pins all timestamps
GENESIS_TIME_NS = 1_700_000_000_000_000_000


async def _deliver_after(delay: float, coro) -> None:
    try:
        await asyncio.sleep(delay)
    except asyncio.CancelledError:
        coro.close()  # net.stop() mid-delay: don't leak an un-awaited coro
        raise
    await coro


def fast_config() -> ConsensusConfig:
    """Short timeouts so multi-round tests finish quickly."""
    return ConsensusConfig(
        timeout_propose_ns=400 * MS,
        timeout_propose_delta_ns=200 * MS,
        timeout_prevote_ns=200 * MS,
        timeout_prevote_delta_ns=200 * MS,
        timeout_precommit_ns=200 * MS,
        timeout_precommit_delta_ns=200 * MS,
        timeout_commit_ns=80 * MS,
        skip_timeout_commit=True,
    )


def make_genesis(
    n_vals: int, chain_id: str = "test-chain", key_type: str = "ed25519"
) -> tuple[GenesisDoc, list]:
    if key_type == "ed25519":
        keys = det_priv_keys(n_vals)
    elif key_type == "bls12381":
        import hashlib

        from ..crypto.bls import BLSPrivKey

        keys = [
            BLSPrivKey(
                hashlib.sha256(
                    b"tmtpu-test" + key_type.encode() + i.to_bytes(4, "big")
                ).digest()
            )
            for i in range(n_vals)
        ]
    else:
        raise ValueError(f"unsupported harness key type {key_type}")
    gvals = [
        GenesisValidator(
            k.pub_key(),
            10,
            f"val{i}",
            pop=k.pop_prove() if key_type == "bls12381" else b"",
        )
        for i, k in enumerate(keys)
    ]
    doc = GenesisDoc(
        chain_id=chain_id,
        initial_height=1,
        genesis_time_ns=GENESIS_TIME_NS,
        validators=gvals,
    )
    return doc, keys


class Node:
    """One in-process validator: app + stores + executor + consensus SM."""

    def __init__(
        self,
        genesis: GenesisDoc,
        priv_key,
        *,
        config: ConsensusConfig | None = None,
        wal_dir: str | None = None,
        app=None,
        fs=None,  # libs/chaosfs.FS — storage fault injection for the WAL
        clock=None,  # libs/clock.Clock — injectable consensus time
        block_store=None,  # reuse across crash/restart cycles (RouterNet)
        state_store=None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve(device)
        self.genesis = genesis
        self.config = config or fast_config()
        self.app = app or KVStoreApp()
        self.app_conns = AppConns.local(self.app)
        self.block_store = block_store or BlockStore(MemDB())
        self.state_store = state_store or StateStore(MemDB())
        self.event_bus = EventBus()
        self.priv_val = MockPV(priv_key) if priv_key is not None else None
        self.clock = clock
        self.fs = fs
        self.wal_dir = wal_dir or tempfile.mkdtemp(prefix="cswal-")
        self.wal = WAL(self.wal_dir, fs=fs)
        self.mempool: PriorityMempool | None = None
        self.evidence_pool: EvidencePool | None = None
        self.cs: ConsensusState | None = None

    async def start(self, *, start_consensus: bool = True) -> None:
        """Build the stack and (by default) start the consensus SM.
        `start_consensus=False` leaves `self.cs` built but not running —
        RouterNet attaches the ConsensusReactor's hooks first, exactly
        like node.py starts the reactor before the SM, so the first
        proposal broadcast is not lost."""
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(self.genesis)
        handshaker = Handshaker(
            self.state_store, state, self.block_store, self.genesis,
            device=self.device,
        )
        state = await handshaker.handshake(self.app_conns)
        self.state_store.save(state)
        self.mempool = PriorityMempool(
            MempoolConfig(), self.app_conns.mempool, height=state.last_block_height
        )
        self.evidence_pool = EvidencePool(
            MemDB(), self.state_store, self.block_store, device=self.device
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
        self.cs = ConsensusState(
            self.config,
            state,
            block_exec,
            self.block_store,
            priv_validator=self.priv_val,
            evidence_pool=self.evidence_pool,
            wal=self.wal,
            event_bus=self.event_bus,
            mempool=self.mempool,
            clock=self.clock,
        )
        if start_consensus:
            await self.cs.start()

    async def stop(self) -> None:
        if self.cs is not None:
            await self.cs.stop()
        if self.mempool is not None:
            self.mempool.close()  # out of the process-wide metrics fold
        await self.app_conns.stop()


class LocalNetwork:
    """N validator nodes with broadcast hooks delivering every outbound
    consensus message to every other node's peer queue.

    `chaos` (libs/chaos.ChaosNetwork) threads the fault plan under the
    hook wiring — drops, asymmetric partitions, delays, reorders, and
    duplicates apply per (sender→receiver) link; node ids are
    "node0".."nodeN-1". Corruption and bandwidth shaping are
    byte-stream faults the typed-message hooks cannot model — the
    constructor REJECTS configs that set their rates (the fault
    counters would report injections the hook never performed); run
    those classes over consensus.routernet.RouterNet, which speaks the
    real router + ChaosTransport byte path. When the chaos config carries
    `clock_skew_ms`, each validator runs on its own deterministically
    skewed clock (over `base_clock` if given — a frozen `ManualClock`
    base makes the whole run's vote/block timestamps
    bit-reproducible)."""

    def __init__(
        self,
        n_vals: int,
        *,
        config: ConsensusConfig | None = None,
        chaos=None,
        base_clock=None,
        catchup: bool = True,
        key_type: str = "ed25519",
        device=DEFAULT_DEVICE,
    ):
        if chaos is not None:
            # byte-stream fault classes the typed hooks can NEVER inject:
            # accepting them here would still bump the `corrupt`/`shaped`
            # fault counters in ChaosNetwork.plan while no corruption or
            # shaping ever happens — a chaos matrix that silently lies
            # about its own coverage. Fail loud; RouterNet
            # (consensus/routernet.py) runs those classes over the real
            # router + ChaosTransport byte path.
            cfgs = [chaos.config, *chaos.config.per_channel.values()]
            bad = sorted(
                {
                    name
                    for cfg in cfgs
                    for name in ("corrupt_rate", "bandwidth_rate")
                    if getattr(cfg, name)
                }
            )
            if bad:
                raise ValueError(
                    f"LocalNetwork cannot model byte-stream faults {bad}: "
                    "the typed broadcast hooks never serialize messages, so "
                    "those injections would be counted but never performed. "
                    "Use consensus.routernet.RouterNet (real p2p.Router + "
                    "ChaosTransport) for corruption/bandwidth chaos."
                )
        self.device = resolve(device)
        self.genesis, self.keys = make_genesis(n_vals, key_type=key_type)
        self.chaos = chaos
        self.catchup = catchup
        self.catchup_rescues = 0
        clocks = [base_clock] * n_vals
        if chaos is not None:
            clocks = [
                chaos.clock_for(f"node{i}", base=base_clock)
                for i in range(n_vals)
            ]
        self.nodes = [
            Node(
                self.genesis, k, config=config, clock=clocks[i],
                device=self.device,
            )
            for i, k in enumerate(self.keys)
        ]
        self._tasks: list[asyncio.Task] = []

    async def start(self) -> None:
        for node in self.nodes:
            await node.start()
        for i, node in enumerate(self.nodes):
            node.cs.broadcast_hook = self._make_hook(i)
        if self.catchup:
            self._tasks.append(
                asyncio.get_running_loop().create_task(
                    self._catchup_relay(), name="harness.catchup"
                )
            )

    def _make_hook(self, sender: int):
        def hook(msg):
            for j, other in enumerate(self.nodes):
                if j == sender or other.cs is None:
                    continue
                mi = self._to_input(msg)
                if mi is None:
                    continue
                kind, args = mi
                delay, copies = 0.0, 1
                if self.chaos is not None:
                    plan = self.chaos.plan(f"node{sender}", f"node{j}", 0)
                    if plan.drop:
                        continue
                    # reorder = extra delay pushing past successors, as
                    # in ChaosConnection.send_message
                    delay = plan.delay_s + (0.05 if plan.reorder else 0.0)
                    copies = 2 if plan.duplicate else 1
                for _ in range(copies):
                    coro = getattr(other.cs, kind)(*args, f"node{sender}")
                    if delay > 0:
                        coro = _deliver_after(delay, coro)
                    self._tasks.append(
                        asyncio.get_running_loop().create_task(coro)
                    )

        return hook

    @staticmethod
    def _to_input(msg):
        if isinstance(msg, m.ProposalMessage):
            return "add_proposal", (msg.proposal,)
        if isinstance(msg, m.BlockPartMessage):
            return "add_block_part", (msg.height, msg.round, msg.part)
        if isinstance(msg, m.VoteMessage):
            return "add_vote", (msg.vote,)
        return None  # HasVote / NewValidBlock are gossip hints; no-op here

    async def _catchup_relay(self) -> None:
        """Minimal stand-in for the consensus reactor's catch-up gossip /
        block-sync rescue (ROADMAP gap): a receiver that missed a
        decided height's proposal — e.g. the victim of a one-way
        partition whose only proposer view was the cut link — gets the
        stored commit's precommits and the block parts replayed from any
        node that already committed that height. Production nodes get
        this from `_send_catchup_commit_vote` + part gossip over real
        routers; without it the direct-hook harness can wedge forever.
        The relay deliberately ignores the chaos fault plan: it models
        the out-of-band block-sync path, not the vote-gossip links the
        chaos layer is partitioning."""
        from ..types.keys import SignedMsgType
        from ..types.vote import Vote

        while True:
            await asyncio.sleep(0.25)
            for node in self.nodes:
                cs = node.cs
                if cs is None or not cs.is_running:
                    continue
                h = cs.rs.height
                donor = next(
                    (
                        d
                        for d in self.nodes
                        if d is not node
                        and d.cs is not None
                        and d.block_store.height() >= h
                    ),
                    None,
                )
                if donor is None:
                    continue  # nobody has committed this height yet
                # canonical commit (from block h+1) when the chain moved
                # on, else the donor's own seen commit for its tip
                commit = donor.block_store.load_block_commit(
                    h
                ) or donor.block_store.load_seen_commit(h)
                meta = donor.block_store.load_block_meta(h)
                if commit is None or meta is None:
                    continue
                self.catchup_rescues += 1
                # open the commit round (the real VoteSetMaj23 exchange
                # does this) so precommits beyond round+1 are admitted
                if cs.rs.height == h and cs.rs.votes is not None:
                    cs.rs.votes.set_peer_maj23(
                        commit.round,
                        SignedMsgType.PRECOMMIT,
                        "catchup-relay",
                        commit.block_id,
                    )
                # precommits first: +2/3 moves the receiver to COMMIT and
                # arms a PartSet for the decided block id …
                for idx, cs_sig in enumerate(commit.signatures):
                    if cs_sig.is_absent():
                        continue
                    vote = Vote(
                        type=SignedMsgType.PRECOMMIT,
                        height=commit.height,
                        round=commit.round,
                        block_id=cs_sig.block_id(commit.block_id),
                        timestamp_ns=cs_sig.timestamp_ns,
                        validator_address=cs_sig.validator_address,
                        validator_index=idx,
                        signature=cs_sig.signature,
                    )
                    await cs.add_vote(vote, "catchup-relay")
                # … then the parts complete the block and finalize fires
                for idx in range(meta.block_id.part_set_header.total):
                    part = donor.block_store.load_block_part(h, idx)
                    if part is not None:
                        await cs.add_block_part(
                            h, commit.round, part, "catchup-relay"
                        )

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for node in self.nodes:
            await node.stop()

    async def wait_for_height(self, height: int, timeout: float = 30.0) -> None:
        await asyncio.gather(
            *(n.cs.wait_for_height(height, timeout) for n in self.nodes)
        )
