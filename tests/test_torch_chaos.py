"""The port's chaos-net and chaos-fs layers (libs/chaos.py, libs/chaosfs.py
and the `config` sections that mirror them) against the JAX package's, on
the CPU.

- `ChaosConfig.from_env` / `ChaosFSConfig.from_env` read every
  TMTPU_CHAOS_* / TMTPU_CHAOS_FS_* knob as the reference does, and the
  `config.ChaosNetConfig` / `ChaosFSConfig` sections equal the reference's.
- One seed gives the same fault plan, the same fault counters and the same
  delivered bytes in both packages: the plan draw by draw (shared stream
  and per-link streams), and a `ChaosConnection` over the memory transport
  delivering a seeded message sequence (drops, duplicates, corruption).
- The crash-model cases of tests/test_chaosfs.py run in both packages: the
  WAL bytes that survive a simulated crash, the records read back, the
  repair and the fault counters are equal. `ChaosDB`'s ENOSPC and bit-rot
  likewise.

Nothing here touches a device. The tolerance is zero; each test bounds
its own wall time."""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import time
import types

import pytest

import tendermint_tpu.config as j_config
import tendermint_tpu.consensus.wal as j_wal
import tendermint_tpu.libs.chaos as j_chaos
import tendermint_tpu.libs.chaosfs as j_chaosfs
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu.p2p.memory as j_memory
import tendermint_tpu.p2p.types as j_types
import tendermint_tpu.store.db as j_db
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.consensus.wal as p_wal
import tendermint_tpu_torch.libs.chaos as p_chaos
import tendermint_tpu_torch.libs.chaosfs as p_chaosfs
import tendermint_tpu_torch.libs.clock as p_clock
import tendermint_tpu_torch.p2p.memory as p_memory
import tendermint_tpu_torch.p2p.types as p_types
import tendermint_tpu_torch.store.db as p_db

REF = types.SimpleNamespace(chaos=j_chaos, chaosfs=j_chaosfs, wal=j_wal, clock=j_clock,
                            memory=j_memory, types=j_types, db=j_db, config=j_config)
PORT = types.SimpleNamespace(chaos=p_chaos, chaosfs=p_chaosfs, wal=p_wal, clock=p_clock,
                             memory=p_memory, types=p_types, db=p_db, config=p_config)
PKGS = (REF, PORT)

CHAOS_ENV = {
    "TMTPU_CHAOS_SEED": "17", "TMTPU_CHAOS_DROP": "0.1", "TMTPU_CHAOS_DELAY_MS": "4.5",
    "TMTPU_CHAOS_DUP": "0.02", "TMTPU_CHAOS_REORDER": "0.03", "TMTPU_CHAOS_CORRUPT": "0.01",
    "TMTPU_CHAOS_BW": "65536", "TMTPU_CHAOS_GRAY_MS": "120", "TMTPU_CHAOS_SKEW_MS": "80",
    "TMTPU_CHAOS_DRIFT": "0.02",
}
CHAOS_FS_ENV = {
    "TMTPU_CHAOS_FS_SEED": "9", "TMTPU_CHAOS_FS_TORN": "0.5", "TMTPU_CHAOS_FS_TORN_OFFSET": "7",
    "TMTPU_CHAOS_FS_LOST_FSYNC": "0.25", "TMTPU_CHAOS_FS_ENOSPC": "0.01",
    "TMTPU_CHAOS_FS_ENOSPC_AT": "4096", "TMTPU_CHAOS_FS_BITROT": "0.05",
}


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("env", [CHAOS_ENV, CHAOS_FS_ENV], ids=["chaos", "chaos-fs"])
def test_from_env_reads_every_knob_as_the_reference_does(env, monkeypatch):
    cls = "ChaosConfig" if env is CHAOS_ENV else "ChaosFSConfig"
    mod = "chaos" if env is CHAOS_ENV else "chaosfs"
    for k in (*CHAOS_ENV, *CHAOS_FS_ENV):
        monkeypatch.delenv(k, raising=False)
    unset = [_fields(getattr(getattr(p, mod), cls).from_env()) for p in PKGS]
    assert unset[1] == unset[0]
    assert not getattr(getattr(PORT, mod), cls).from_env().enabled()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    armed = [getattr(getattr(p, mod), cls).from_env() for p in PKGS]
    assert _fields(armed[1]) == _fields(armed[0])
    assert armed[1].enabled() and armed[1].seed == int(env[next(iter(env))])
    assert armed[1] != unset[1]


@pytest.mark.parametrize("section", ["ChaosNetConfig", "ChaosFSConfig"])
def test_config_sections_equal_the_reference(section):
    j, p = getattr(j_config, section), getattr(p_config, section)
    assert [(f.name, f.default) for f in dataclasses.fields(p)] == [
        (f.name, f.default) for f in dataclasses.fields(j)]
    assert p().enabled is False


def _plan_trace(pkg, cfg_kw: dict, n: int) -> tuple[list, dict]:
    """`n` seeded plan() draws over three links and two channels, with a
    partition cycle and a gray peer in the middle: every _Faults, and the
    counters after."""
    net = pkg.chaos.ChaosNetwork(pkg.chaos.ChaosConfig(**cfg_kw))
    out = []
    links = [("a", "b"), ("b", "a"), ("a", "c")]
    for i in range(n):
        if i == n // 3:
            net.partition_oneway("a", "c")
            net.set_gray("b", 40.0)
        if i == 2 * n // 3:
            net.heal()
            net.set_peer_config("b", net.config)
        local, remote = links[i % 3]
        f = net.plan(local, remote, 0x20 + (i % 2), nbytes=100 + i, now=0.001 * i)
        out.append(dataclasses.astuple(f))
    return out, dict(net.faults)


@pytest.mark.parametrize("link_seeded", [False, True], ids=["shared-stream", "per-link"])
def test_same_seed_same_fault_plan_and_counters(link_seeded):
    t0 = time.perf_counter()
    cfg = dict(seed=424, drop_rate=0.1, delay_ms=3.0, duplicate_rate=0.05, reorder_rate=0.05,
               corrupt_rate=0.05, bandwidth_rate=50_000.0, link_seeded=link_seeded)
    ref = _plan_trace(REF, cfg, 600)
    port = _plan_trace(PORT, cfg, 600)
    assert port == ref
    faults = port[1]
    for cls in ("drop", "delay", "duplicate", "reorder", "corrupt", "asym_drop",
                "shaped", "gray_delay"):
        assert faults[cls] > 0, (cls, faults)
    # a per-channel override inherits the network's seed in both
    over = {0x21: j_chaos.ChaosConfig(drop_rate=0.5)}
    pover = {0x21: p_chaos.ChaosConfig(drop_rate=0.5)}
    assert _plan_trace(PORT, {**cfg, "per_channel": pover}, 90) == \
        _plan_trace(REF, {**cfg, "per_channel": over}, 90)
    rng = random.Random(5)
    for _ in range(50):
        data = rng.randbytes(rng.randrange(0, 64))
        at = rng.getrandbits(30)
        assert p_chaos._corrupt(data, at) == j_chaos._corrupt(data, at)
    assert time.perf_counter() - t0 < 10.0


def test_clock_for_gives_the_references_skew_and_drift():
    for seed in (1, 11, 29):
        for node in ("node0", "nodeA", "rn7"):
            got = []
            for pkg in PKGS:
                net = pkg.chaos.ChaosNetwork(pkg.chaos.ChaosConfig(
                    seed=seed, clock_skew_ms=80.0, clock_drift=0.02))
                c = net.clock_for(node, base=pkg.clock.ManualClock(1_000_000_000))
                got.append((c.offset_ns, c.rate, c.now_ns(), net.faults["clock_skew"]))
            assert got[1] == got[0]
    base = p_clock.ManualClock(5)
    assert p_chaos.ChaosNetwork(p_chaos.ChaosConfig(seed=3)).clock_for("x", base=base) is base


async def _deliver(pkg, cfg_kw: dict, msgs: list[bytes]) -> tuple[list, dict]:
    """Send `msgs` from a chaos-wrapped memory transport to a plain one and
    read back everything that arrives (in order); returns the delivered
    (channel, bytes) list and the fault counters."""
    net = pkg.chaos.ChaosNetwork(pkg.chaos.ChaosConfig(**cfg_kw))
    mem = pkg.memory.MemoryNetwork()
    a = net.wrap(mem.create_transport("aa"), "aa")
    b = mem.create_transport("bb")
    dial = asyncio.ensure_future(a.dial(pkg.types.NodeAddress(node_id="bb", protocol="memory")))
    cb = await b.accept()
    ca = await dial
    info = lambda nid: pkg.types.NodeInfo(node_id=nid, network="c", moniker=nid)  # noqa: E731
    await asyncio.gather(ca.handshake(info("aa"), None), cb.handshake(info("bb"), None))
    for i, m in enumerate(msgs):
        await ca.send_message(0x20 + i % 3, m)
    got = []
    while True:
        try:
            got.append(await asyncio.wait_for(cb.receive_message(), 0.2))
        except asyncio.TimeoutError:
            break
    await ca.close()
    await cb.close()
    return got, dict(net.faults)


def test_same_seed_delivers_the_same_bytes_over_the_memory_transport():
    """Drops, duplicates and corruption on the send path (no delay, so the
    delivery order is the send order): the same frames arrive, byte for
    byte, and the counters agree."""
    t0 = time.perf_counter()
    rng = random.Random(31)
    msgs = [rng.randbytes(rng.randrange(1, 300)) for _ in range(400)]
    cfg = dict(seed=77, drop_rate=0.08, duplicate_rate=0.06, corrupt_rate=0.07)
    ref = asyncio.run(_deliver(REF, cfg, msgs))
    port = asyncio.run(_deliver(PORT, cfg, msgs))
    assert port == ref
    got, faults = port
    assert faults["drop"] > 0 and faults["duplicate"] > 0 and faults["corrupt"] > 0
    assert len(got) == len(msgs) - faults["drop"] + faults["duplicate"]
    # a corrupted frame may also be duplicated
    assert faults["corrupt"] <= sum(d not in msgs for _c, d in got) <= 2 * faults["corrupt"]
    assert time.perf_counter() - t0 < 15.0


# -- chaos-fs: the crash-model cases of tests/test_chaosfs.py ----------------


def _fill(wal, n: int = 5, sync: bool = True) -> list[bytes]:
    payloads = [bytes([i]) * (10 + i) for i in range(n)]
    for p in payloads:
        (wal.write_sync if sync else wal.write)(p)
    return payloads


def _survivor(d: str) -> bytes:
    with open(os.path.join(d, "wal"), "rb") as f:
        return f.read()


def _repairs(wal) -> list:
    return [(r.valid_end, bool(r.tail_path)) for r in wal.last_repair]


def _case_fsynced(pkg, d):
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=1))
    wal = pkg.wal.WAL(d, fs=fs)
    _fill(wal, 5)
    wal.write(b"buffered-not-synced")
    fs.halt()
    wal.close()
    crash = fs.simulate_crash()
    wal2 = pkg.wal.WAL(d, fs=fs)
    recs = [r.data for r in wal2.iter_records()]
    out = (_survivor(d), recs, _repairs(wal2), dict(fs.faults), sorted(crash.values()))
    wal2.close()
    return out


def _case_torn(pkg, d):
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=7, torn_write_rate=1.0))
    wal = pkg.wal.WAL(d, fs=fs)
    _fill(wal, 5)
    wal.write(b"torn-away-1")
    wal.write(b"torn-away-2")
    fs.halt()
    wal.close()
    fs.simulate_crash()
    torn = _survivor(d)
    wal2 = pkg.wal.WAL(d, fs=fs)
    recs = [r.data for r in wal2.iter_records()]
    rep = _repairs(wal2)
    wal2.write_sync(b"after-restart")
    recs2 = [r.data for r in wal2.iter_records()]
    wal2.close()
    return torn, recs, rep, recs2, dict(fs.faults)


def _case_lost_fsync(pkg, d):
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=3, lost_fsync_rate=1.0))
    wal = pkg.wal.WAL(d, fs=fs)
    _fill(wal, 4)
    fs.halt()
    wal.close()
    fs.simulate_crash()
    wal2 = pkg.wal.WAL(d, fs=fs)
    recs = list(wal2.iter_records())
    wal2.close()
    return _survivor(d), recs, dict(fs.faults)


def _case_enospc(pkg, d):
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=1, enospc_at_byte=40))
    wal = pkg.wal.WAL(d, fs=fs)
    with pytest.raises(OSError):
        _fill(wal, 5)
    wal.write_sync(b"after-enospc")
    fs.halt()
    wal.close()
    fs.simulate_crash()
    wal2 = pkg.wal.WAL(d, fs=fs)
    recs = [r.data for r in wal2.iter_records()]
    wal2.close()
    return _survivor(d), recs, dict(fs.faults)


def _case_enospc_during_salvage(pkg, d):
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=7, torn_write_rate=1.0))
    wal = pkg.wal.WAL(d, fs=fs)
    _fill(wal, 5)
    wal.write(b"torn-away-1")
    wal.write(b"torn-away-2")
    fs.halt()
    wal.close()
    fs.simulate_crash()
    fs2 = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=1, enospc_at_byte=0))
    wal2 = pkg.wal.WAL(d, fs=fs2)  # disk still full: repair degrades, no raise
    rep = _repairs(wal2)
    salvaged = os.path.exists(os.path.join(d, "wal.corrupt.0"))
    recs = [r.data for r in wal2.iter_records()]
    wal2.write_sync(b"after")
    wal2.close()
    return rep, salvaged, recs, _survivor(d), dict(fs2.faults)


def _case_same_seed_crash(pkg, d):
    out = []
    for run in range(2):
        sub = os.path.join(d, f"w{run}")
        fs = pkg.chaosfs.ChaosFS(
            pkg.chaosfs.ChaosFSConfig(seed=42, torn_write_rate=0.5, lost_fsync_rate=0.3))
        wal = pkg.wal.WAL(sub, fs=fs)
        _fill(wal, 8)
        fs.halt()
        wal.close()
        fs.simulate_crash()
        out.append((_survivor(sub), dict(fs.faults)))
    assert out[0] == out[1]
    return out


def _case_chaos_db(pkg, d):
    del d
    fs = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=5, enospc_rate=1.0))
    db = pkg.chaosfs.ChaosDB(fs, pkg.db.MemDB())
    errs = 0
    for op in (lambda: db.set(b"k", b"v"), lambda: db.write_batch([(b"k", b"v")])):
        try:
            op()
        except OSError:
            errs += 1
    fs2 = pkg.chaosfs.ChaosFS(pkg.chaosfs.ChaosFSConfig(seed=5, bitrot_rate=1.0))
    db2 = fs2.wrap_db(pkg.db.MemDB())
    db2.set(b"k", b"value")
    db2.set(b"k2", b"other-value")
    rotten = (db2.get(b"k"), list(db2.iterate()))
    return errs, db.get(b"k"), dict(fs.faults), rotten, dict(fs2.faults)


CASES = {
    "fsynced_records_always_survive": _case_fsynced,
    "torn_write_repaired_to_last_whole_record": _case_torn,
    "lost_fsync_is_acked_but_not_durable": _case_lost_fsync,
    "enospc_mid_record_rolls_back_partial_frame": _case_enospc,
    "repair_survives_enospc_during_salvage": _case_enospc_during_salvage,
    "same_seed_same_crash": _case_same_seed_crash,
    "chaos_db_enospc_and_bitrot": _case_chaos_db,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chaosfs_crash_model_equals_the_reference(case, tmp_path):
    t0 = time.perf_counter()
    ref = CASES[case](REF, str(tmp_path / "ref"))
    port = CASES[case](PORT, str(tmp_path / "port"))
    assert port == ref
    if case == "torn_write_repaired_to_last_whole_record":
        assert port[4]["torn_write"] == 1 and port[2], "the tear never hit a record"
    if case == "lost_fsync_is_acked_but_not_durable":
        assert port[1] == [] and port[2]["lost_fsync"] >= 4
    if case == "chaos_db_enospc_and_bitrot":
        assert port[0] == 2 and port[1] is None and port[2]["db_enospc"] == 2
        assert port[3][0] != b"value" and port[4]["db_bitrot"] >= 1
    assert time.perf_counter() - t0 < 10.0
