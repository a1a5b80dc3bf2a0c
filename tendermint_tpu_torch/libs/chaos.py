"""Chaos-net: seeded, deterministic network fault injection (the port's
copy of tendermint_tpu/libs/chaos.py; the fault plan draws from its seeded
streams in the reference's order, so same-seed runs of either package take
the same faults on the same message sequence).

`libs/fail.py` injects process *crashes*; this module injects *network*
faults — the other half of the fault model committee-based consensus is
judged against (drops, delays, reordering, duplication, corruption,
partitions). A `ChaosNetwork` is the shared, seeded controller; wrapping
any p2p `Transport` in `ChaosTransport` threads the fault plan under
every reactor's send/recv path with zero changes to the reactors
themselves — the wrapper speaks the plain Transport/Connection interface
(p2p/transport.py).

Determinism: all randomness flows from ONE `random.Random(seed)` owned
by the controller, so a fault schedule is reproducible given the same
seed and the same message sequence per link. (Asyncio scheduling still
varies across runs; what is bit-reproducible is protocol OUTPUT — e.g.
synced block hashes — not packet timings.)

Config surface (env mirrors `config.ChaosConfig`):

  TMTPU_CHAOS_SEED       int     master seed (default 0)
  TMTPU_CHAOS_DROP       float   per-message drop probability
  TMTPU_CHAOS_DELAY_MS   float   p50 extra latency (exponential tail)
  TMTPU_CHAOS_DUP        float   duplication probability
  TMTPU_CHAOS_REORDER    float   reorder probability (delays one msg past
                                 its successor)
  TMTPU_CHAOS_CORRUPT    float   payload bit-flip probability
  TMTPU_CHAOS_BW         float   per-link bandwidth cap, bytes/sec — a
                                 leaky-bucket queue whose backlog turns
                                 into delivery delay (queue buildup)
  TMTPU_CHAOS_GRAY_MS    float   gray failure: fixed per-message delay
                                 (slow-but-alive, tuned to sit just under
                                 timeout thresholds)
  TMTPU_CHAOS_SKEW_MS    float   max |clock skew| per validator; each
                                 node's offset is drawn deterministically
                                 from (seed, node_id) — see `clock_for`
  TMTPU_CHAOS_DRIFT      float   max |oscillator rate error| per
                                 validator (0.05 = up to 5% fast/slow;
                                 consensus timeouts fire early/late)

Beyond the symmetric `partition()`, `partition_oneway(src, dst)` models
asymmetric reachability: src→dst traffic drops while dst→src flows (the
half-open links real WAN partitions produce)."""

from __future__ import annotations

import asyncio
import os
import random
from dataclasses import dataclass, field, replace

from ..p2p.transport import Connection, Transport


@dataclass(frozen=True)
class ChaosConfig:
    """Per-link fault rates. All probabilities are per message."""

    seed: int = 0
    drop_rate: float = 0.0
    delay_ms: float = 0.0  # p50 of an exponential extra-latency distribution
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    corrupt_rate: float = 0.0
    # per-link bandwidth cap in BYTES/sec (0 = unlimited): messages queue
    # behind each other on the link and backlog becomes delivery delay
    bandwidth_rate: float = 0.0
    # gray failure: a fixed delay on EVERY message (slow-but-alive; pick a
    # value just under the consumer's timeout to model the worst kind of
    # sick peer — one that never looks dead)
    gray_delay_ms: float = 0.0
    # max |per-validator clock skew| handed out by `ChaosNetwork.clock_for`
    clock_skew_ms: float = 0.0
    # max |per-validator oscillator drift| (rate error): 0.05 means each
    # validator's clock runs up to 5% fast/slow, so its consensus
    # timeouts fire early/late through the ticker's duration scaling
    clock_drift: float = 0.0
    # channel_id -> rate overrides, e.g. {0x40: ChaosConfig(drop_rate=0.5)}
    per_channel: dict = field(default_factory=dict)
    # per-link RNG streams instead of the one shared stream: every
    # (src, dst) link draws from random.Random(f"{seed}:{src}:{dst}"),
    # so a link's fault schedule depends only on ITS OWN message
    # sequence — the cross-process determinism contract RouterNet-XL
    # needs (K worker processes each own the send side of their links;
    # no shared RNG can span them). In-process harnesses keep the
    # shared stream by default: existing seeds pin existing schedules.
    link_seeded: bool = False

    @classmethod
    def from_env(cls) -> "ChaosConfig":
        def f(name: str, default: float = 0.0) -> float:
            raw = os.environ.get(name, "")
            return float(raw) if raw else default

        return cls(
            seed=int(os.environ.get("TMTPU_CHAOS_SEED", "0") or 0),
            drop_rate=f("TMTPU_CHAOS_DROP"),
            delay_ms=f("TMTPU_CHAOS_DELAY_MS"),
            duplicate_rate=f("TMTPU_CHAOS_DUP"),
            reorder_rate=f("TMTPU_CHAOS_REORDER"),
            corrupt_rate=f("TMTPU_CHAOS_CORRUPT"),
            bandwidth_rate=f("TMTPU_CHAOS_BW"),
            gray_delay_ms=f("TMTPU_CHAOS_GRAY_MS"),
            clock_skew_ms=f("TMTPU_CHAOS_SKEW_MS"),
            clock_drift=f("TMTPU_CHAOS_DRIFT"),
        )

    def enabled(self) -> bool:
        return any(
            (
                self.drop_rate,
                self.delay_ms,
                self.duplicate_rate,
                self.reorder_rate,
                self.corrupt_rate,
                self.bandwidth_rate,
                self.gray_delay_ms,
                self.clock_skew_ms,
                self.clock_drift,
                self.per_channel,
            )
        )

    def for_channel(self, channel_id: int) -> "ChaosConfig":
        override = self.per_channel.get(channel_id)
        if override is None:
            return self
        # overrides inherit the parent seed (one RNG per network anyway)
        return replace(override, seed=self.seed)


class ChaosNetwork:
    """Shared fault controller: one seeded RNG, one partition map, and
    fault counters for every link that threads through it.

    Partitions are sets of node-id groups: traffic BETWEEN groups is
    dropped, traffic within a group flows (subject to the rate faults).
    `heal()` clears them. Per-peer rate overrides target a specific
    node id in either direction."""

    def __init__(self, config: ChaosConfig | None = None):
        self.config = config or ChaosConfig()
        self.rng = random.Random(self.config.seed)
        # link_seeded mode: lazily-built per-link RNGs (see ChaosConfig)
        self._link_rngs: dict[tuple[str, str], random.Random] = {}
        self._groups: list[set[str]] = []
        self._oneway: list[tuple[set[str], set[str]]] = []  # (src, dst) blocked
        self._per_peer: dict[str, ChaosConfig] = {}
        # per-link leaky bucket for bandwidth shaping: (local, remote) ->
        # loop time at which the link's queue drains
        self._link_busy: dict[tuple[str, str], float] = {}
        # observability: fault class -> injected count (mirrored into
        # libs/metrics by whoever owns a NodeMetrics)
        self.faults: dict[str, int] = {
            "drop": 0, "delay": 0, "duplicate": 0, "reorder": 0,
            "corrupt": 0, "partition_drop": 0, "asym_drop": 0,
            "shaped": 0, "gray_delay": 0, "clock_skew": 0,
        }

    # -- topology faults -------------------------------------------------

    def partition(self, *groups: set[str] | list[str] | tuple[str, ...]) -> None:
        """Split the net: nodes in different groups cannot talk. Nodes in
        no group keep full connectivity to everyone (they are treated as
        a member of every group)."""
        self._groups = [set(g) for g in groups]

    def partition_oneway(
        self,
        src: str | set[str] | list[str] | tuple[str, ...],
        dst: str | set[str] | list[str] | tuple[str, ...],
    ) -> None:
        """Asymmetric partition: src→dst traffic is dropped while dst→src
        flows — the half-open link state symmetric partitions can't model
        (A believes B is down; B keeps answering into the void)."""
        to_set = lambda x: {x} if isinstance(x, str) else set(x)  # noqa: E731
        self._oneway.append((to_set(src), to_set(dst)))

    def heal(self) -> None:
        self._groups = []
        self._oneway = []

    def set_peer_config(self, node_id: str, config: ChaosConfig) -> None:
        """Rate override for any link whose far end is `node_id`."""
        self._per_peer[node_id] = config

    def set_gray(self, node_id: str, delay_ms: float) -> None:
        """Mark a peer gray: every message to it crawls by a fixed
        `delay_ms` (inheriting the network's other rates) — slow-but-alive
        rather than dead."""
        self._per_peer[node_id] = replace(self.config, gray_delay_ms=delay_ms)

    def clock_for(self, node_id: str, base=None):
        """A per-validator clock under the clock fault classes: a fixed
        offset (`clock_skew_ms`) and/or an oscillator rate error
        (`clock_drift` — the ticker scales timeout durations by it, so a
        fast validator fires consensus timeouts early). Both are drawn
        from an RNG keyed on (seed, node_id) — NOT the shared stream —
        so they are identical across runs regardless of the order clocks
        are handed out. Returns `base` (or the system clock) untouched
        when both fault classes are off."""
        from .clock import SYSTEM, SkewedClock

        skew_ms = self.config.clock_skew_ms
        drift = self.config.clock_drift
        if skew_ms <= 0 and drift <= 0:
            return base or SYSTEM
        r = random.Random(f"{self.config.seed}:clock:{node_id}")
        offset_ns = int(r.uniform(-skew_ms, skew_ms) * 1e6) if skew_ms > 0 else 0
        rate = 1.0 + (r.uniform(-drift, drift) if drift > 0 else 0.0)
        self.faults["clock_skew"] += 1
        return SkewedClock(base, offset_ns, rate=rate)

    def partitioned(self, a: str, b: str) -> bool:
        if not self._groups:
            return False
        ga = [i for i, g in enumerate(self._groups) if a in g]
        gb = [i for i, g in enumerate(self._groups) if b in g]
        if not ga or not gb:
            return False  # ungrouped nodes see everyone
        return not set(ga) & set(gb)

    def partitioned_oneway(self, src: str, dst: str) -> bool:
        return any(src in s and dst in d for s, d in self._oneway)

    # -- per-message fault plan -----------------------------------------

    def plan(
        self,
        local: str,
        remote: str,
        channel_id: int,
        nbytes: int = 0,
        now: float = 0.0,
    ) -> "_Faults":
        """Roll the dice for ONE message on the (local→remote, channel)
        link. Called under the event loop, so RNG use is serialized and
        the draw sequence is deterministic per seed. `nbytes`/`now` (loop
        time) feed bandwidth shaping; callers that don't shape may omit
        them."""
        cfg = self._per_peer.get(remote, self.config).for_channel(channel_id)
        if self.partitioned(local, remote):
            self.faults["partition_drop"] += 1
            return _Faults(drop=True)
        if self.partitioned_oneway(local, remote):
            self.faults["asym_drop"] += 1
            return _Faults(drop=True)
        if self.config.link_seeded:
            rng = self._link_rngs.get((local, remote))
            if rng is None:
                rng = random.Random(
                    f"{self.config.seed}:{local}:{remote}"
                )
                self._link_rngs[(local, remote)] = rng
        else:
            rng = self.rng
        drop = cfg.drop_rate > 0 and rng.random() < cfg.drop_rate
        if drop:
            self.faults["drop"] += 1
            return _Faults(drop=True)
        delay_s = 0.0
        if cfg.gray_delay_ms > 0:
            delay_s += cfg.gray_delay_ms / 1e3
            self.faults["gray_delay"] += 1
        if cfg.bandwidth_rate > 0 and nbytes > 0:
            # leaky bucket: the message transmits after everything already
            # queued on this link; backlog IS the delay (queue buildup)
            link = (local, remote)
            start = max(now, self._link_busy.get(link, 0.0))
            done = start + nbytes / cfg.bandwidth_rate
            self._link_busy[link] = done
            if done > now:
                delay_s += done - now
                if start > now:
                    self.faults["shaped"] += 1
        if cfg.delay_ms > 0:
            # exponential with median delay_ms: tail models queueing
            delay_s += rng.expovariate(0.6931471805599453 / (cfg.delay_ms / 1e3))
            self.faults["delay"] += 1
        duplicate = cfg.duplicate_rate > 0 and rng.random() < cfg.duplicate_rate
        if duplicate:
            self.faults["duplicate"] += 1
        reorder = cfg.reorder_rate > 0 and rng.random() < cfg.reorder_rate
        if reorder:
            self.faults["reorder"] += 1
        corrupt_at = -1
        if cfg.corrupt_rate > 0 and rng.random() < cfg.corrupt_rate:
            corrupt_at = rng.getrandbits(30)
            self.faults["corrupt"] += 1
        return _Faults(
            delay_s=delay_s,
            duplicate=duplicate,
            reorder=reorder,
            corrupt_at=corrupt_at,
        )

    def wrap(self, transport: Transport, node_id: str) -> "ChaosTransport":
        return ChaosTransport(self, transport, node_id)


@dataclass(frozen=True)
class _Faults:
    drop: bool = False
    delay_s: float = 0.0
    duplicate: bool = False
    reorder: bool = False
    corrupt_at: int = -1  # byte offset seed; -1 = no corruption


def _corrupt(data: bytes, at: int) -> bytes:
    if not data:
        return data
    i = at % len(data)
    return data[:i] + bytes([data[i] ^ (1 + (at >> 8) % 255)]) + data[i + 1 :]


class ChaosConnection(Connection):
    """Send-side fault injection over any Connection. Faults ride the
    send path (one side of each link is enough to model a lossy link;
    wrapping both sides compounds rates)."""

    def __init__(self, net: ChaosNetwork, inner: Connection, local: str):
        self.net = net
        self.inner = inner
        self.local = local
        self.remote = ""  # learned at handshake
        self._inflight: set[asyncio.Task] = set()

    async def handshake(self, node_info, priv_key):
        peer_info = await self.inner.handshake(node_info, priv_key)
        self.remote = peer_info.node_id
        return peer_info

    async def send_message(self, channel_id: int, data: bytes) -> None:
        remote = self.remote or self.inner.remote_addr
        plan = self.net.plan(
            self.local, remote, channel_id,
            nbytes=len(data), now=asyncio.get_running_loop().time(),
        )
        if plan.drop:
            return
        if plan.corrupt_at >= 0:
            data = _corrupt(bytes(data), plan.corrupt_at)
        copies = 2 if plan.duplicate else 1
        if plan.delay_s <= 0 and not plan.reorder:
            for _ in range(copies):
                await self.inner.send_message(channel_id, data)
            return
        # delayed / reordered: deliver from a task so the sender never
        # blocks on injected latency. Reorder = extra delay that pushes
        # the message past its successors.
        delay = plan.delay_s + (0.05 if plan.reorder else 0.0)
        t = asyncio.get_running_loop().create_task(
            self._deliver_later(channel_id, data, delay, copies)
        )
        self._inflight.add(t)
        t.add_done_callback(self._inflight.discard)

    async def _deliver_later(
        self, channel_id: int, data: bytes, delay: float, copies: int
    ) -> None:
        await asyncio.sleep(delay)
        try:
            for _ in range(copies):
                await self.inner.send_message(channel_id, data)
        except ConnectionError:
            pass  # link died while the message was in flight
        except asyncio.CancelledError:
            raise  # teardown cancels in-flight deliveries; don't absorb it

    async def receive_message(self) -> tuple[int, bytes]:
        return await self.inner.receive_message()

    @property
    def remote_addr(self) -> str:
        return self.inner.remote_addr

    async def close(self) -> None:
        for t in list(self._inflight):
            t.cancel()
        await self.inner.close()


class ChaosTransport(Transport):
    """Thread a ChaosNetwork under any Transport: both dialed and
    accepted connections come back chaos-wrapped."""

    def __init__(self, net: ChaosNetwork, inner: Transport, node_id: str):
        self.net = net
        self.inner = inner
        self.node_id = node_id
        self.PROTOCOL = inner.PROTOCOL

    async def listen(self, endpoint: str) -> None:
        await self.inner.listen(endpoint)

    def endpoint(self) -> str | None:
        return self.inner.endpoint()

    async def accept(self) -> Connection:
        return ChaosConnection(self.net, await self.inner.accept(), self.node_id)

    async def dial(self, address) -> Connection:
        return ChaosConnection(self.net, await self.inner.dial(address), self.node_id)

    async def close(self) -> None:
        await self.inner.close()
