"""Declarative chaos scenario sweep over RouterNet (the port's copy of
tendermint_tpu/consensus/scenarios.py, with `device=`).

A `Scenario` names one fault shape — steady per-link rates
(`ChaosConfig`), a storage fault plan (`ChaosFSConfig`), and a timed
`Event` script (partitions forming and healing, a peer going gray, a
node crashing mid-consensus and restarting) — independent of committee
size and seed, so the SAME scenario runs as a 4-validator tier-1 smoke,
a 50-validator sweep, and a 150-validator soak (tests/test_routernet.py)
and as the `bench.py chaos_soak` config.

`run_scenario` drives it: build a RouterNet over real routers +
ChaosTransport, play the event script, and watch liveness — every node
must keep committing. The watchdog asserts all-nodes-progress (min
committed height advances and reaches the target); on a wedge it dumps
the flight recorder (libs/trace) plus the per-class chaos fault
counters, per-node heights and round states to disk, then reports a
structured outcome instead of hanging — the bench contract (bounded,
structured outcomes; the multichip discipline).

Node references in events are indices into the net (resolved modulo n,
so `node=-1` is "the last node"); partition groups may use the string
"rest" for "every node not named elsewhere in the event".

The registry's summaries are prose and may word a scenario differently
from the reference's; names, fault configs, events and Byzantine plans
are the reference's. Every entry point (`run_scenario`, `run_sweep`,
`run_light_attack`, `run_boot_wave`) takes `device=`: "cuda" by default,
which raises without a card; "cpu" asks for the host. The net's hub, every node's executor,
evidence pool and state-sync reactor, and LightD verify there. A device
error is never an outcome: a `crypto.batch.DeviceError` raised anywhere
in a run — in a node's consensus task, an event, a join, LightD, or a
catch-all that absorbed it (`crypto.batch.device_errors()` counts every
one) — propagates out of the runner after the net is stopped, where a
wedge or a failure would have been reported."""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
from dataclasses import dataclass, field, replace

from ..crypto.batch import DeviceError, device_errors
from ..device import DEFAULT_DEVICE, resolve
from ..libs.chaos import ChaosConfig, ChaosNetwork
from ..libs.chaosfs import ChaosFS, ChaosFSConfig
from .byzantine import (
    ByzConfig,
    audit_net,
    byz_prepare_hook,
    committed_light_client_attack_evidence,
)
from .harness import GENESIS_TIME_NS, MS, fast_config
from .routernet import RouterNet, committee_config


class _DeviceWatch:
    """Raise the last DeviceError raised in the process since the watch
    began, wherever it was caught (a node's consensus task ends with it; a
    catch-all may have absorbed it on its way up)."""

    def __init__(self):
        self._base = device_errors()[0]

    def check(self) -> None:
        count, last = device_errors()
        if count != self._base:
            raise last


@dataclass(frozen=True)
class Event:
    """One timed fault transition. `at_s` is scenario time (scaled by
    the runner's `time_scale` so the same script fits 4-validator and
    150-validator block cadences)."""

    at_s: float
    # partition | oneway | heal | gray | ungray | crash | restart |
    # churn_join | churn_leave | churn_power | churn_rogue_join
    action: str
    groups: tuple = ()  # partition: tuple of groups (indices or "rest")
    src: tuple = ()  # oneway: sender group (indices or "rest")
    dst: tuple = ()  # oneway: receiver group
    node: int = 0  # gray/ungray/crash/restart/churn target (index mod n;
    # for churn_join/churn_rogue_join it seeds the PHANTOM key instead)
    delay_ms: float = 0.0  # gray: fixed per-message delay
    power: int = 1  # churn_join/churn_power: requested voting power


@dataclass(frozen=True)
class Scenario:
    name: str
    summary: str
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    events: tuple[Event, ...] = ()
    fs: ChaosFSConfig | None = None  # per-node storage faults (crash model)
    # -- the Byzantine axis (consensus/byzantine.py), composable with
    # every fault class above: (validator index, plan) pairs — indices
    # resolve mod n_vals at run time, like event node references
    byz: tuple[tuple[int, ByzConfig], ...] = ()
    # plan applied to the LAST f = ⌊(n_vals−1)⁄3⌋ validators — the
    # protocol's full fault budget at any committee size (keeps the
    # early proposer slots honest so runs make progress from height 1)
    byz_f_max: ByzConfig | None = None
    # False for strategies whose detection is probabilistic by design
    # (split-camp equivocation on a small fast net: the conflicting
    # pair must cross camps via relay gossip before the height moves
    # on). Safety and evidence PROMPTNESS always bind; only complete
    # escape stops being an audit failure.
    audit_require_evidence: bool = True
    # storm-sized timeouts at EVERY committee size (committee_config),
    # not just n>16: f-max traitors + lossy links split round-0 locks,
    # and re-assembling the POL polka across the committee takes the
    # gossip-heal latency (stall-refresh cadence ≥1s) — fast_config's
    # sub-second rounds then churn faster than the polka can converge.
    # Timers only bound the unhappy path, so clean heights stay fast.
    storm_timeouts: bool = False


# -- the named taxonomy ----------------------------------------------------

SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            "baseline",
            "no faults — the control run every other scenario is read against",
        ),
        Scenario(
            "lossy_links",
            "drops + exponential delay + duplication + reordering on every link",
            chaos=ChaosConfig(
                drop_rate=0.05, delay_ms=5.0, duplicate_rate=0.02,
                reorder_rate=0.02,
            ),
        ),
        Scenario(
            "corrupt_wire",
            "seeded byte corruption on the live gossip byte-stream "
            "(malformed frames cost the sender its connection; redial heals)",
            chaos=ChaosConfig(corrupt_rate=0.02, delay_ms=2.0),
        ),
        Scenario(
            "asym_partition",
            "half-open link: node 0 stops RECEIVING while its own votes "
            "still flow out; heals mid-run — recovery must ride the "
            "reactor's catch-up gossip",
            events=(
                Event(0.8, "oneway", src=("rest",), dst=(0,)),
                Event(2.4, "heal"),
            ),
        ),
        Scenario(
            "gray_failure",
            "one peer goes slow-but-alive (fixed delay tuned near the "
            "gossip cadence), then recovers",
            events=(
                Event(0.5, "gray", node=1, delay_ms=120.0),
                Event(2.5, "ungray", node=1),
            ),
        ),
        Scenario(
            "bandwidth_crunch",
            "per-link leaky-bucket shaping: block parts queue behind "
            "votes and backlog becomes delivery delay",
            chaos=ChaosConfig(bandwidth_rate=192.0 * 1024),
        ),
        Scenario(
            "clock_skew",
            "per-validator wall-clock skew + oscillator drift (timeouts "
            "fire early/late); the vote-time floor keeps output deterministic",
            chaos=ChaosConfig(clock_skew_ms=80.0, clock_drift=0.02),
        ),
        Scenario(
            "crash_fs",
            "chaos-fs crash mid-consensus: a node dies with a torn WAL "
            "tail, restarts on the same stores, repairs, and catches up "
            "through catch-up gossip",
            fs=ChaosFSConfig(torn_write_rate=1.0),
            events=(
                Event(1.2, "crash", node=-1),
                Event(2.0, "restart", node=-1),
            ),
        ),
        Scenario(
            "validator_churn",
            "live validator-set churn under lossy links: a phantom key "
            "joins via a val-tx, a sitting validator's power shifts, "
            "the last validator leaves (power 0), and a rogue bls12381 "
            "join WITHOUT proof of possession bounces off every mempool "
            "(the proof-of-possession-on-update defense, exercised live)",
            chaos=ChaosConfig(drop_rate=0.02, delay_ms=3.0),
            events=(
                Event(0.6, "churn_join", node=100, power=1),
                Event(1.2, "churn_rogue_join", node=101, power=1),
                Event(1.8, "churn_power", node=1, power=3),
                Event(2.4, "churn_leave", node=-1),
            ),
        ),
        # -- the Byzantine axis: validators that LIE, composed with the
        # network/storage/clock fault classes above. Every run is
        # audited (consensus/byzantine.audit_net): honest commit + app
        # hash agreement, DuplicateVoteEvidence accountability within K
        # heights for every equivocator, peer cost for invalid-sig
        # gossip.
        Scenario(
            "byz_equivocation",
            "one traitor double-signs prevotes+precommits at every "
            "height (both votes to every peer): every honest node must "
            "detect, pool, gossip and COMMIT the DuplicateVoteEvidence",
            byz=((-1, ByzConfig(("equivocate",))),),
        ),
        Scenario(
            "byz_equivocation_partition",
            "split-mode equivocation under an asymmetric partition: "
            "conflicting votes go to disjoint camps, so detection must "
            "happen where honest relay gossip intersects — while node 0 "
            "is half-deaf",
            byz=((-1, ByzConfig(("equivocate",), equiv_split=True)),),
            events=(
                Event(0.8, "oneway", src=("rest",), dst=(0,)),
                Event(2.4, "heal"),
            ),
            audit_require_evidence=False,
        ),
        Scenario(
            "byz_amnesia_skew",
            "a traitor that forgets its lock (amnesia prevotes) on a "
            "committee with skewed/drifting clocks — the lock rules "
            "must hold safety on honest nodes alone",
            chaos=ChaosConfig(clock_skew_ms=80.0, clock_drift=0.02),
            byz=((-1, ByzConfig(("amnesia", "equivocate"))),),
        ),
        Scenario(
            "byz_withhold",
            "selective vote/part withholding per peer over lossy links: "
            "starved peers must heal through honest relay gossip and "
            "catch-up (paced — the donors' loop share stays bounded)",
            chaos=ChaosConfig(drop_rate=0.02, delay_ms=3.0),
            byz=(
                (
                    -1,
                    ByzConfig(
                        ("withhold_votes", "withhold_parts"),
                        withhold_frac=0.5,
                    ),
                ),
            ),
        ),
        Scenario(
            "byz_invalid_sig",
            "invalid-signature gossip: stage-1 ingest disproves the "
            "forgery and the traitor pays (PeerError → score/ban, "
            "audited on every honest peer manager)",
            byz=((-1, ByzConfig(("invalid_sig", "equivocate"))),),
        ),
        Scenario(
            "byz_flood_lies",
            "future-round vote floods plus lying NewRoundStep/HasVote "
            "frames: the unwanted-round guard sheds the flood without "
            "verify spend; VoteSetBits reconciliation + stall-refresh "
            "heal the poisoned gossip marks; catch-up pacing bounds the "
            "lag-bait service",
            byz=((-1, ByzConfig(("future_round_flood", "lying_frames"))),),
        ),
        Scenario(
            "byz_full_taxonomy",
            "f = ⌊(n−1)/3⌋ traitors equivocating, forgetting locks, "
            "withholding and forging signatures under network chaos — "
            "the protocol's entire fault budget, demonstrated live. "
            "(lying_frames/future_round_flood stay out of the f-max "
            "mix by design: a traitor lying about its own height makes "
            "its voting power vanish from every later round, and at "
            "f-max that parks the committee at EXACTLY the honest "
            "quorum — Tendermint is still safe but round alignment "
            "under chaos stops being wall-clock-feasible; those "
            "strategies run at f=1 in byz_flood_lies instead)",
            chaos=ChaosConfig(
                drop_rate=0.02, delay_ms=3.0, duplicate_rate=0.01,
                reorder_rate=0.01, corrupt_rate=0.008,
                clock_skew_ms=60.0, clock_drift=0.01,
            ),
            byz_f_max=ByzConfig(
                (
                    "equivocate",
                    "amnesia",
                    "withhold_votes",
                    "invalid_sig",
                )
            ),
            events=(
                Event(0.8, "oneway", src=("rest",), dst=(0,)),
                Event(2.4, "heal"),
            ),
            storm_timeouts=True,
        ),
        Scenario(
            "full_taxonomy",
            "everything at once: lossy + corrupt + shaped links, clock "
            "skew/drift, a gray peer, an asymmetric partition cycle, and "
            "a chaos-fs crash/restart mid-consensus",
            chaos=ChaosConfig(
                drop_rate=0.02, delay_ms=3.0, duplicate_rate=0.01,
                reorder_rate=0.01, corrupt_rate=0.008,
                bandwidth_rate=512.0 * 1024, clock_skew_ms=60.0,
                clock_drift=0.01,
            ),
            fs=ChaosFSConfig(torn_write_rate=1.0),
            events=(
                Event(0.5, "gray", node=1, delay_ms=100.0),
                Event(0.8, "oneway", src=("rest",), dst=(0,)),
                Event(1.2, "crash", node=-1),
                Event(2.0, "restart", node=-1),
                Event(2.4, "heal"),
                Event(2.6, "ungray", node=1),
            ),
        ),
    )
}


@dataclass
class ScenarioResult:
    scenario: str
    seed: int
    n_vals: int
    n_full: int
    target_height: int
    ok: bool
    wedged: bool
    events_applied: list[str]
    heights: list[int]
    elapsed_s: float
    blocks_per_s: float
    recover_s: float | None  # last fault event -> all nodes past target
    faults: dict
    fs_faults: dict
    error: str = ""
    dump_path: str = ""
    # cross-node safety auditor verdict (byzantine.audit_net) — present
    # for EVERY scenario (agreement checks are byz-independent); the
    # evidence/penalty checks only bind when traitors were installed
    audit: dict | None = None
    byz_indices: list = field(default_factory=list)
    byz_actions: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "n_vals": self.n_vals,
            "n_full": self.n_full,
            "target_height": self.target_height,
            "outcome": "ok" if self.ok else ("wedged" if self.wedged else "error"),
            "events_applied": self.events_applied,
            "heights": self.heights,
            "elapsed_s": round(self.elapsed_s, 3),
            "blocks_per_s": round(self.blocks_per_s, 4),
            "recover_s": (
                round(self.recover_s, 3) if self.recover_s is not None else None
            ),
            "faults": self.faults,
            "fs_faults": self.fs_faults,
            "error": self.error,
            "dump_path": self.dump_path,
            "audit": self.audit,
            "byz_indices": self.byz_indices,
            "byz_actions": self.byz_actions,
        }


def _resolve_group(group, n: int, named: set[int]) -> set[int]:
    out: set[int] = set()
    for g in group:
        if g == "rest":
            out |= set(range(n)) - named
        else:
            out.add(g % n)
    return out


def _event_indices(ev: Event, n: int) -> set[int]:
    named: set[int] = set()
    for group in (*ev.groups, ev.src, ev.dst):
        for g in group:
            if g != "rest":
                named.add(g % n)
    return named


def churn_join_key(seed: int, index: int):
    """The deterministic phantom validator key a `churn_join` event
    introduces — a pure function of (run seed, event node index) so
    every process in a multi-worker run derives the same key."""
    import hashlib

    from ..crypto import ed25519 as _ed

    return _ed.Ed25519PrivKey(
        hashlib.sha256(f"tmtpu:churn:{seed}:{index}".encode()).digest()
    )


async def _inject_tx(net: RouterNet, tx: bytes, *, expect_reject: bool) -> None:
    """Broadcast one tx into every live node's mempool (RouterNet wires
    no mempool gossip channel, so whichever validator proposes next must
    already hold the tx). `expect_reject` inverts the contract: the tx
    MUST bounce off CheckTx on every node — the live PoP-on-update
    defense — and acceptance anywhere is the failure."""
    from ..mempool.pool import TxInCacheError, TxRejectedError

    accepted = rejected = 0
    for node in net.nodes:
        inner = node.inner
        if inner is None or inner.mempool is None:
            continue  # crashed mid-scenario; survivors carry the churn
        try:
            await inner.mempool.check_tx(tx)
            accepted += 1
        except TxRejectedError:
            rejected += 1
        except TxInCacheError:
            accepted += 1
    if expect_reject:
        if accepted:
            raise AssertionError(
                f"rogue churn tx accepted by {accepted} mempools"
            )
    elif not accepted:
        raise AssertionError(f"churn tx rejected by all {rejected} mempools")


def _churn_tx(ev: Event, net: RouterNet, seed: int) -> tuple[bytes, bool]:
    """Build the validator-tx for a churn event; returns (tx,
    expect_reject)."""
    from ..abci.kvstore import VALIDATOR_TX_PREFIX

    if ev.action == "churn_join":
        pub = churn_join_key(seed, ev.node).pub_key()
        body = f"{pub.bytes().hex()}!{ev.power}"
        return VALIDATOR_TX_PREFIX + body.encode(), False
    if ev.action == "churn_rogue_join":
        # a bls12381 join WITHOUT proof of possession: the rogue-key
        # shape the genesis checks refuse, now arriving through the only
        # post-genesis entry point — every mempool must bounce it
        from ..crypto import bls
        import hashlib

        priv = bls.BLSPrivKey(
            hashlib.sha256(f"tmtpu:rogue:{seed}:{ev.node}".encode()).digest()
        )
        body = f"bls12381:{priv.pub_key().bytes().hex()}!{ev.power}"
        return VALIDATOR_TX_PREFIX + body.encode(), True
    # churn_leave / churn_power target a SITTING validator by index
    pub = net.keys[ev.node % net.n].pub_key()
    power = 0 if ev.action == "churn_leave" else ev.power
    if pub.TYPE == "ed25519":
        body = f"{pub.bytes().hex()}!{power}"
    else:
        body = f"{pub.TYPE}:{pub.bytes().hex()}!{power}"
    return VALIDATOR_TX_PREFIX + body.encode(), False


async def _apply_event(
    ev: Event, net: RouterNet, chaos: ChaosNetwork, seed: int = 0
) -> None:
    n = net.n
    named = _event_indices(ev, n)
    ids = lambda idxs: {net.nodes[i].node_id for i in idxs}  # noqa: E731
    if ev.action.startswith("churn_"):
        tx, expect_reject = _churn_tx(ev, net, seed)
        await _inject_tx(net, tx, expect_reject=expect_reject)
    elif ev.action == "partition":
        chaos.partition(
            *(ids(_resolve_group(g, n, named)) for g in ev.groups)
        )
    elif ev.action == "oneway":
        chaos.partition_oneway(
            ids(_resolve_group(ev.src, n, named)),
            ids(_resolve_group(ev.dst, n, named)),
        )
    elif ev.action == "heal":
        chaos.heal()
    elif ev.action == "gray":
        chaos.set_gray(net.nodes[ev.node % n].node_id, ev.delay_ms)
    elif ev.action == "ungray":
        chaos.set_peer_config(net.nodes[ev.node % n].node_id, chaos.config)
    elif ev.action == "crash":
        await net.crash(ev.node % n)
    elif ev.action == "restart":
        await net.restart(ev.node % n)
    else:
        raise ValueError(f"unknown scenario event action {ev.action!r}")


def _round_states(net: RouterNet) -> list[dict]:
    out = []
    for node in net.nodes:
        cs = node.cs
        if cs is None:
            out.append({"index": node.index, "state": "down"})
            continue
        out.append(
            {
                "index": node.index,
                "height": cs.rs.height,
                "round": cs.rs.round,
                "step": int(cs.rs.step),
                "committed": node.block_store.height(),
                "running": bool(cs.is_running),
            }
        )
    return out


def _snapshot_wedge(
    scenario: Scenario,
    net: RouterNet,
    chaos: ChaosNetwork | None,
    detail: dict,
) -> dict:
    """Build the wedge post-mortem payload ON THE LOOP: the routers are
    still live here (run_scenario stops them after the dump so round
    state is readable), so fault counters and round states must be
    copied in one loop step — iterating them from a worker thread races
    their writers (dict-changed-size mid-dump). The flight ring is
    dumped here too (its own small file; the recorder's state is
    loop-mutated)."""
    from ..libs import trace

    flight = trace.auto_dump(f"chaos-wedge-{scenario.name}")
    return {
        "scenario": scenario.name,
        "summary": scenario.summary,
        "faults": dict(chaos.faults) if chaos is not None else {},
        "fs_faults": {
            i: dict(fs.faults)
            for i, fs in net._fs.items()
            if fs is not None
        },
        "nodes": _round_states(net),
        "flight_dump": flight or "",
        **detail,
    }


def _write_wedge(dump_dir: str, name: str, payload: dict) -> str:
    """Write the (already-snapshotted) payload — the blocking half,
    pushed off the loop via asyncio.to_thread so a slow disk cannot
    stall the routers the dump describes (acceptance: any wedge is
    diagnosable from disk)."""
    os.makedirs(dump_dir, exist_ok=True)
    path = os.path.join(dump_dir, f"chaos-wedge-{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


async def run_scenario(
    scenario: Scenario | str,
    *,
    n_vals: int = 4,
    n_full: int = 0,
    target_height: int = 3,
    seed: int = 1,
    config=None,
    degree: int = 8,
    timeout_s: float = 60.0,
    stall_s: float = 20.0,
    time_scale: float = 1.0,
    gossip_sleep: float | None = None,
    use_hub: bool = True,
    dump_dir: str | None = None,
    base_clock=None,
    audit_k: int = 3,  # heights an equivocator's evidence may take to commit
    device=DEFAULT_DEVICE,
) -> ScenarioResult:
    """One seeded scenario run. Returns a structured result — it does
    NOT raise on a wedge (`result.ok` / `result.wedged`); the hard
    `timeout_s` bound means a caller can sweep the whole taxonomy and
    still terminate. A DeviceError raises (module docstring)."""
    device = resolve(device)
    watch = _DeviceWatch()
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    if dump_dir is None:
        dump_dir = os.environ.get("TMTPU_CHAOS_DUMP_DIR") or tempfile.mkdtemp(
            prefix="chaos-dumps-"
        )
    chaos_cfg = replace(scenario.chaos, seed=seed)
    # events (partitions/gray) need the controller even when every steady
    # rate is zero
    chaos = (
        ChaosNetwork(chaos_cfg)
        if (chaos_cfg.enabled() or scenario.events)
        else None
    )
    fs_factory = None
    if scenario.fs is not None:
        fs_cfg = scenario.fs

        def fs_factory(i: int, _cfg=fs_cfg, _seed=seed):
            # one ChaosFS per node: a crash must only tear ITS WAL
            return ChaosFS(replace(_cfg, seed=_seed * 1009 + i))

    if base_clock is None:
        from ..libs.clock import ManualClock

        # frozen behind genesis: the vote-time floor pins every stamp
        base_clock = ManualClock(GENESIS_TIME_NS - 500 * MS)
    if config is None:
        # small nets: fast multi-round timeouts; committees (and
        # scenarios that declare storm_timeouts — f-max byz runs):
        # storm-sized timers (see routernet.committee_config — timers
        # only bound the unhappy path, quorum drives the happy one)
        config = (
            fast_config()
            if n_vals <= 16 and not scenario.storm_timeouts
            else committee_config(n_vals)
        )
    # -- the Byzantine plan: explicit (index, config) pairs plus the
    # f-max budget; per-traitor seeds derive from the RUN seed so two
    # same-seed runs produce bit-identical byzantine behavior
    byz_registry: list = []
    byz_plan: dict[int, ByzConfig] = {}
    for idx, bcfg in scenario.byz:
        i = idx % n_vals
        byz_plan[i] = replace(bcfg, seed=seed * 1013 + i)
    if scenario.byz_f_max is not None:
        f = max(0, (n_vals - 1) // 3)
        for i in range(n_vals - f, n_vals):
            byz_plan.setdefault(
                i, replace(scenario.byz_f_max, seed=seed * 1013 + i)
            )
    net = RouterNet(
        n_vals,
        n_full=n_full,
        config=config,
        chaos=chaos,
        base_clock=base_clock,
        degree=degree,
        topo_seed=seed,
        gossip_sleep=gossip_sleep,
        use_hub=use_hub,
        fs_factory=fs_factory,
        prepare_hook=(
            byz_prepare_hook(byz_plan, byz_registry) if byz_plan else None
        ),
        device=device,
    )
    loop = asyncio.get_running_loop()
    heights: list[int] = []
    faults: dict = {}
    fs_faults: dict = {}
    ok = wedged = False
    error = dump_path = ""
    recover_s: float | None = None
    t0 = loop.time()
    t_done = t0
    try:
        await net.start()
    except DeviceError:
        await net.stop()
        raise
    except Exception as e:  # noqa: BLE001 — structured outcome contract
        # best-effort teardown of the partially-started net: the hub
        # refcount and any already-running routers/reactors must not
        # leak into the caller's loop (run_sweep runs more scenarios)
        await net.stop()
        return ScenarioResult(
            scenario=scenario.name, seed=seed, n_vals=n_vals, n_full=n_full,
            target_height=target_height, ok=False, wedged=False,
            events_applied=[], heights=net.heights(), elapsed_s=0.0,
            blocks_per_s=0.0, recover_s=None,
            faults=dict(chaos.faults) if chaos is not None else {},
            fs_faults={}, error=f"start failed: {e!r}",
        )
    event_err: list[str] = []
    events_applied: list[str] = []
    last_event_t = [t0]
    # liveness is a guarantee for CORRECT nodes: a traitor can always
    # wedge itself (e.g. lying_frames under-reports its own height and
    # starves its own catch-up), so the all-nodes-progress gate and the
    # throughput figure read the minimum over HONEST nodes only
    honest_idx = [i for i in range(net.n) if i not in byz_plan] or list(
        range(net.n)
    )

    def honest_min() -> int:
        return min(net.heights()[i] for i in honest_idx)

    async def drive_events() -> None:
        for ev in sorted(scenario.events, key=lambda e: e.at_s):
            await asyncio.sleep(
                max(0.0, ev.at_s * time_scale - (loop.time() - t0))
            )
            try:
                await _apply_event(ev, net, chaos, seed)
                events_applied.append(ev.action)
            except DeviceError:
                raise  # not an event error: the watch below raises it
            except Exception as e:  # noqa: BLE001 — recorded, run continues
                event_err.append(f"{ev.action}@{ev.at_s}: {e!r}")
            last_event_t[0] = loop.time()

    events_task = loop.create_task(drive_events(), name="scenario.events")
    try:
        # -- liveness watchdog: all nodes must progress ----------------
        # Completion is gated on the WHOLE event script having fired
        # plus at least one height of post-event progress: a fast
        # committee must not "pass" a crash scenario by reaching the
        # target before the crash happens.
        deadline = t0 + timeout_s
        last_min = -1
        last_progress = loop.time()
        post_event_target: int | None = (
            target_height if not scenario.events else None
        )
        while True:
            await asyncio.sleep(0.2)
            watch.check()
            mh = honest_min()
            now = loop.time()
            if mh > last_min:
                last_min = mh
                last_progress = now
            if post_event_target is None and events_task.done():
                post_event_target = max(target_height, mh + 1)
            if post_event_target is not None and mh >= post_event_target:
                ok = True
                t_done = now
                break
            if now > deadline or (now - last_progress) > stall_s * time_scale:
                # a stall a failed card caused is not a wedge
                watch.check()
                wedged = True
                t_done = now
                break
        watch.check()
    except DeviceError:
        raise  # the finally below stops the net first
    except Exception as e:  # noqa: BLE001 — structured outcome, not a raise
        error = repr(e)
        t_done = loop.time()
    finally:
        events_task.cancel()
        # reap without absorbing our own cancellation
        await asyncio.gather(events_task, return_exceptions=True)
        heights = net.heights()
        faults = dict(chaos.faults) if chaos is not None else {}
        fs_faults = {
            str(i): dict(fs.faults)
            for i, fs in net._fs.items()
            if fs is not None
        }
        byz_actions = [b.log_summary() for b in byz_registry]
        # the cross-node safety auditor runs on EVERY scenario outcome —
        # a wedged net must still never have double-committed
        try:
            audit = audit_net(
                net,
                byz_registry,
                k_heights=audit_k,
                require_evidence=scenario.audit_require_evidence,
            ).as_dict()
        except Exception as e:  # noqa: BLE001 — observation must not mask
            audit = {"ok": False, "notes": [f"audit failed: {e!r}"]}
        if wedged or error:
            # snapshot on the loop (atomic view of live state), write
            # off the loop (a slow disk can't stall the routers the
            # dump describes)
            payload = _snapshot_wedge(
                scenario,
                net,
                chaos,
                {
                    "seed": seed,
                    "n_vals": n_vals,
                    "target_height": target_height,
                    "elapsed_s": round(t_done - t0, 3),
                    "event_errors": event_err,
                    "error": error,
                    "byz": byz_actions,
                    "audit": audit,
                },
            )
            dump_path = await asyncio.to_thread(
                _write_wedge, dump_dir, scenario.name, payload
            )
        await net.stop()
    if event_err and not error:
        error = "; ".join(event_err)
    elapsed = max(t_done - t0, 1e-9)
    if ok and scenario.events:
        recover_s = max(0.0, t_done - last_event_t[0])
    # throughput from what was actually COMMITTED net-wide (the min
    # HONEST height), not the requested target: an event-gated run can
    # outrun target_height, and chaos_soak compares these numbers
    # across rounds; a self-wedged traitor does not zero the figure
    committed = min((heights[i] for i in honest_idx), default=0) if heights else 0
    return ScenarioResult(
        scenario=scenario.name,
        seed=seed,
        n_vals=n_vals,
        n_full=n_full,
        target_height=target_height,
        ok=ok,
        wedged=wedged,
        events_applied=events_applied,
        heights=heights,
        elapsed_s=elapsed,
        blocks_per_s=(committed / elapsed) if ok else 0.0,
        recover_s=recover_s,
        faults=faults,
        fs_faults=fs_faults,
        error=error,
        dump_path=dump_path,
        audit=audit,
        byz_indices=sorted(byz_plan),
        byz_actions=byz_actions,
    )


async def run_light_attack(
    *,
    n_vals: int = 3,
    seed: int = 1,
    trust_height: int = 1,
    attack_offset: int = 2,
    k_heights: int = 3,
    timeout_s: float = 90.0,
    commit_window_s: float = 2.5,
    chaos_cfg: ChaosConfig | None = None,
    app_factory=None,
    use_hub: bool = True,
    degree: int = 8,
    config=None,
    device=DEFAULT_DEVICE,
) -> dict:
    """The live lunatic light-client attack over RouterNet — the
    LightFleet Byzantine axis (light/byzantine.py), end to end:

      honest committee commits over real routers (chaos-wrapped when
      `chaos_cfg` is set) → a LightD (light/fleet.py) syncs through a
      traitor primary (`LunaticProvider`: a forged header signed out of
      band by a seeded >1/3-power subset reusing their REAL keys) with
      honest witnesses → the witness cross-check detects the divergence
      → `LightClientAttackEvidence` forms and lands in every honest
      pool → evidence-channel gossip → on-chain commitment →
      BeginBlock misbehavior — audited by `audit_net` (agreement + LCA
      accountability within `k_heights` of the forged height).

    Determinism construction (the bit-identity contract at n_vals=3):
    frozen clock + 3 equal-power validators pin every commit signer
    set and timestamp; the colluders behave HONESTLY in consensus (the
    forgery is an offline key reuse), so the chain itself is the
    deterministic baseline; a `commit_window_s` timeout_commit opens a
    pause after the attack height inside which detection + direct
    evidence reporting to every witness pool completes, pinning the
    evidence's commit height. Two same-seed runs then produce
    bit-identical block AND evidence bytes.

    Attack heights sit `attack_offset >= 2` above the trust anchor:
    adjacent hops pin the exact next validator set by hash and reject
    the forgery before the witness cross-check — a negative test, not
    an attack.

    Returns a structured outcome dict (never raises on wedge/timeout —
    the chaos_soak contract; a DeviceError raises, module docstring)."""
    from ..libs.clock import ManualClock
    from ..light.byzantine import LunaticConfig, LunaticProvider
    from ..light.client import Divergence, TrustOptions
    from ..light.fleet import LightD
    from ..light.provider import BlockStoreProvider
    from ..state.state import state_from_genesis

    device = resolve(device)
    watch = _DeviceWatch()
    attack_height = trust_height + attack_offset
    if attack_offset < 2:
        raise ValueError("lunatic attack heights must be non-adjacent")
    if config is None:
        base = fast_config() if n_vals <= 16 else committee_config(n_vals)
        config = replace(
            base,
            timeout_commit_ns=int(commit_window_s * 1e9),
            skip_timeout_commit=False,
        )
    chaos = (
        ChaosNetwork(replace(chaos_cfg, seed=seed))
        if chaos_cfg is not None and chaos_cfg.enabled()
        else None
    )
    net = RouterNet(
        n_vals,
        config=config,
        chaos=chaos,
        base_clock=ManualClock(GENESIS_TIME_NS - 500 * MS),
        degree=degree,
        topo_seed=seed,
        use_hub=use_hub,
        app_factory=app_factory,
        device=device,
    )
    chain_id = net.genesis.chain_id
    out: dict = {
        "outcome": "error",
        "n_vals": n_vals,
        "seed": seed,
        "attack_height": attack_height,
        "divergence_detected": False,
        "served_forged": 0,
        "traitors": [],
        "lca_committed_at": None,
        "time_to_lca_commit_heights": None,
        "audit": None,
        "blocks_hex": [],
        "lca_evidence_hex": "",
        "heights": [],
        "elapsed_s": 0.0,
        "error": "",
    }
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    lightd = None
    try:
        await asyncio.wait_for(net.start(), timeout_s)
        await asyncio.wait_for(
            net.wait_for_height(attack_height, timeout_s), timeout_s
        )
        genesis_vals = state_from_genesis(net.genesis).validators
        keys_by_addr = {k.pub_key().address(): k for k in net.keys}
        providers = [
            BlockStoreProvider(
                chain_id,
                n.block_store,
                n.inner.state_store,
                evidence_pool=n.inner.evidence_pool,
            )
            for n in net.nodes
        ]
        lunatic = LunaticProvider(
            providers[0],
            LunaticConfig(
                (attack_height,), seed=seed, n_traitors=n_vals // 3 + 1
            ),
            genesis_vals,
            keys_by_addr,
        )
        out["traitors"] = [a.hex() for a in lunatic.traitor_addresses()]
        anchor_meta = net.nodes[0].block_store.load_block_meta(trust_height)
        trust = TrustOptions(
            period_ns=10 * 365 * 24 * 3600 * 10**9,
            height=trust_height,
            hash=anchor_meta.header.hash(),
        )
        lightd = LightD(
            chain_id, trust, lunatic, witnesses=providers, device=device
        )
        await lightd.start()
        tip_time = net.nodes[0].block_store.load_block_meta(
            attack_height
        ).header.time_ns
        try:
            await asyncio.wait_for(
                lightd.sync(attack_height, now_ns=tip_time + 10**9), 60.0
            )
        except Divergence:
            out["divergence_detected"] = True
        out["served_forged"] = len(lunatic.served_forged)
        out["lightd_stats"] = dict(lightd.stats)
        # wait (bounded by K heights) for the evidence to reach a block
        expect = lunatic.traitor_addresses()
        target = attack_height + 1
        for _ in range(k_heights + 1):
            await asyncio.wait_for(
                net.wait_for_height(target, timeout_s), timeout_s
            )
            lca = committed_light_client_attack_evidence(net.nodes[0])
            if all(a in lca for a in expect):
                commit_h, ev = lca[expect[0]]
                out["lca_committed_at"] = commit_h
                out["time_to_lca_commit_heights"] = (
                    commit_h - ev.conflicting_height
                )
                out["lca_evidence_hex"] = ev.encode().hex()
                break
            target += 1
        audit = audit_net(
            net, [], k_heights=k_heights, expect_lca=expect
        )
        out["audit"] = audit.as_dict()
        out["blocks_hex"] = [
            b.hex() for b in net.block_fingerprints(target, node=0)
        ]
        out["outcome"] = (
            "ok"
            if out["divergence_detected"]
            and out["lca_committed_at"] is not None
            and audit.ok
            else "failed"
        )
        watch.check()
    except DeviceError:
        raise  # the finally below stops LightD and the net first
    except Exception as e:  # noqa: BLE001 — structured outcome contract
        out["error"] = repr(e)
    finally:
        if lightd is not None:
            await lightd.stop()
        out["heights"] = net.heights()
        out["elapsed_s"] = round(loop.time() - t0, 3)
        await net.stop()
    watch.check()
    return out


async def run_boot_wave(
    *,
    n_vals: int = 4,
    n_joiners: int = 2,
    seed: int = 1,
    snapshot_height: int = 12,
    timeout_s: float = 120.0,
    join_timeout_s: float = 90.0,
    chaos_cfg: ChaosConfig | None = None,
    donor_crash: bool = False,
    poison_donors: tuple[int, ...] = (),
    use_hub: bool = True,
    degree: int = 8,
    config=None,
    bootd_config=None,
    donors_per_joiner: int = 3,
    snapshot_interval: int = 10,
    commit_window_s: float | None = None,
    gossip_sleep: float | None = None,
    device=DEFAULT_DEVICE,
) -> dict:
    """The BootFleet mass-onboarding scenario: a wave of `n_joiners`
    cold nodes statesyncs into a live `n_vals`-validator RouterNet
    committee — chunks served by the donors' BootDs, backfill commit
    signatures batched onto the VerifyHub backfill lane — while the
    committee keeps committing (optionally under link chaos).

    Fault variants, composable:

      * `donor_crash`: one donor is killed mid-wave (real `net.crash`);
        joiners must re-fetch from survivors (chunk-timeout → breaker →
        rotation), and the committee must keep quorum (n_vals >= 4).
      * `poison_donors`: those validator indices serve poisoned chunk
        bytes (`statesync/byzantine.PoisonedSnapshotApp`, seeded): the
        restore's whole-blob hash check must reject the state, cost the
        serving peer a `PeerError(ban=True)`, and move on to the next
        candidate — a joiner may land on an older snapshot but NEVER on
        the poisoned state.

    Success: every joiner syncs within `join_timeout_s` AND every
    header it holds matches the committee's chain (the honest app-hash
    chain), and `audit_net` passes over the committee. Returns a
    structured outcome dict; never raises (the chaos_soak contract) but
    on a DeviceError (module docstring)."""
    from ..libs.clock import ManualClock
    from ..statesync.byzantine import PoisonedSnapshotApp
    from ..statesync.reactor import SyncConfig

    device = resolve(device)
    watch = _DeviceWatch()
    if config is None:
        if n_vals <= 16:
            config = fast_config()
        else:
            # committee scale: a wide commit window is the catch-up
            # lever — every height gives laggards a quiet gossip window
            # (run_light_attack's construction; 200 ms churns at 150)
            config = replace(
                committee_config(n_vals),
                timeout_commit_ns=int((commit_window_s or 30.0) * 1e9),
                skip_timeout_commit=False,
            )
    chaos = (
        ChaosNetwork(replace(chaos_cfg, seed=seed))
        if chaos_cfg is not None and chaos_cfg.enabled()
        else None
    )
    poison_idx = {p % n_vals for p in poison_donors}

    def _app(i):
        # `snapshot_height` must be a cadence height: committee-scale
        # soaks shrink the interval so the wave starts heights earlier
        if i in poison_idx:
            return PoisonedSnapshotApp(
                seed=seed, snapshot_interval=snapshot_interval
            )
        if snapshot_interval != 10:
            from ..abci.kvstore import KVStoreApp

            return KVStoreApp(snapshot_interval=snapshot_interval)
        return None

    app_factory = _app if (poison_idx or snapshot_interval != 10) else None
    net = RouterNet(
        n_vals,
        config=config,
        chaos=chaos,
        base_clock=ManualClock(GENESIS_TIME_NS - 500 * MS),
        degree=degree,
        topo_seed=seed,
        use_hub=use_hub,
        app_factory=app_factory,
        statesync=True,
        bootd_config=bootd_config,
        **({"gossip_sleep": gossip_sleep} if gossip_sleep is not None else {}),
        device=device,
    )
    out: dict = {
        "outcome": "error",
        "n_vals": n_vals,
        "n_joiners": n_joiners,
        "seed": seed,
        "donor_crash": donor_crash,
        "poison_donors": sorted(poison_idx),
        "joined": 0,
        "join_errors": [],
        "time_to_synced_s": [],
        "joiner_heights": [],
        "honest_chain_ok": None,
        "poisoned_rejects": 0,
        "busy_sheds": 0,
        "chunks_served": 0,
        "cache_hits": 0,
        "backfill_sigs": 0,
        "backfill_agg_heights": 0,
        "audit": None,
        "heights": [],
        "elapsed_s": 0.0,
        "error": "",
    }
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    try:
        await asyncio.wait_for(net.start(), timeout_s)
        # snapshots at the interval height + the h+2 headers light
        # verification pins against must exist before the wave starts —
        # on the ANCHOR node and the DONORS only, not the whole
        # committee: at 150 validators the slowest laggard trails the
        # quorum by heights (it catches up inside commit windows)
        donor_idx = {0} | {
            (n_vals + j + k) % n_vals
            for j in range(n_joiners)
            for k in range(min(donors_per_joiner, n_vals))
        }
        await asyncio.wait_for(
            asyncio.gather(
                *(
                    net.nodes[i].cs.wait_for_height(
                        snapshot_height + 2, timeout_s
                    )
                    for i in sorted(donor_idx)
                )
            ),
            timeout_s,
        )
        anchor = net.nodes[0].block_store.load_block_meta(snapshot_height)
        cfg = SyncConfig(
            trust_height=snapshot_height,
            trust_hash=anchor.header.hash(),
            trust_period_ns=10 * 365 * 24 * 3600 * 10**9,
        )
        joiners = [
            net.make_joiner(donors=donors_per_joiner) for _ in range(n_joiners)
        ]
        for j in joiners:
            await j.prepare()

        async def join_one(j):
            jt0 = loop.time()
            await asyncio.wait_for(j.statesync_join(cfg), join_timeout_s)
            return loop.time() - jt0

        tasks = [asyncio.create_task(join_one(j)) for j in joiners]
        if donor_crash:
            # kill a donor while the wave is in flight: every joiner
            # dials donors starting at a distinct offset, so (joiner 0's
            # first donor) is in some joiner's rotation
            await asyncio.sleep(0.3)
            await net.crash(n_vals - 1)
        results = await asyncio.gather(*tasks, return_exceptions=True)
        for r in results:
            if isinstance(r, DeviceError):
                raise r  # a failed card, not a failed join
        for r in results:
            if isinstance(r, BaseException):
                out["join_errors"].append(repr(r))
            else:
                out["joined"] += 1
                out["time_to_synced_s"].append(round(r, 3))

        # honest-chain check: every header a joiner holds must be the
        # committee's block at that height (a poisoned restore that
        # slipped through would fork the app-hash chain here)
        ref = net.nodes[0].block_store
        honest = True
        for j in joiners:
            jh = j.block_store.height()
            out["joiner_heights"].append(jh)
            base = j.block_store.base()
            for h in range(max(1, base), jh + 1):
                meta = j.block_store.load_block_meta(h)
                ref_meta = ref.load_block_meta(h)
                if meta is None or ref_meta is None:
                    continue
                if meta.header.hash() != ref_meta.header.hash():
                    honest = False
        out["honest_chain_ok"] = honest

        for node in net.nodes + net.joiners:
            if node.ss_reactor is None:
                continue
            st = node.ss_reactor.bootd.stats
            out["poisoned_rejects"] += st["poisoned_rejects"]
            out["busy_sheds"] += st["sheds"]
            out["chunks_served"] += st["chunks_served"]
            out["cache_hits"] += st["cache_hits"]
            out["backfill_sigs"] += st["backfill_sigs"]
            out["backfill_agg_heights"] += st["backfill_agg_heights"]

        crashed = {n_vals - 1} if donor_crash else set()
        audit = audit_net(
            net,
            [],
            k_heights=3,
            require_evidence=False,
        )
        # a crashed donor legitimately stops committing; agreement over
        # what it DID commit still binds (audit_net only compares
        # heights both sides hold)
        out["audit"] = audit.as_dict()
        ok = out["joined"] == n_joiners and honest and audit.ok
        out["outcome"] = "ok" if ok else "failed"
        out["crashed"] = sorted(crashed)
        watch.check()
    except DeviceError:
        raise  # the finally below stops the net first
    except Exception as e:  # noqa: BLE001 — structured outcome contract
        out["error"] = repr(e)
    finally:
        out["heights"] = net.heights()
        out["elapsed_s"] = round(loop.time() - t0, 3)
        await net.stop()
    watch.check()
    return out


async def run_sweep(
    names: list[str] | None = None,
    **kwargs,
) -> list[ScenarioResult]:
    """Run a list of named scenarios sequentially (the full registry by
    default) with shared runner kwargs (`device=` among them); returns one
    structured result per scenario, or raises the first DeviceError."""
    out = []
    for name in names or list(SCENARIOS):
        out.append(await run_scenario(name, **kwargs))
    return out
