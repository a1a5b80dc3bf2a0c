"""The port's state sync (statesync/: messages, BootD, the verified backfill,
the reactor) against the JAX package's, on the CPU.

Both packages build the same light chains and kvstore chains from
`det_priv_keys` and the same BLS keys, so bytes compare directly. Held
equal: every wire message's encoding (and each package decodes the
other's bytes back to the same encoding), the wire bounds, BootD's
serving discipline (cache, coalescing, busy-shed, manifest pruning: the
same stats from the same sequence of requests), `verify_backfill_batch`'s
counts and errors (per-signature windows, one aggregate pairing per BLS
height, a tampered window, the empty batch), and the restore scenario of
bench.py's config 5 at 16 blocks of 4 validators: the same headers held,
the same restored State and app hash. The port runs on device="cpu" (the
pairing checks through K7a/K7b's plain versions); the tolerance is zero.

Pinned difference by design: BootD reads its knobs from BootDConfig
alone; the reference's TMTPU_BOOTD_* env overrides are not read.
"""

from __future__ import annotations

import asyncio
import dataclasses
import types

import pytest
import torch

import tendermint_tpu.abci.types as j_abci
import tendermint_tpu.config as j_config
import tendermint_tpu.light.types as j_ltypes
import tendermint_tpu.statesync.fleet as j_fleet
import tendermint_tpu.statesync.messages as j_msg
import tendermint_tpu.statesync.reactor as j_reactor
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.block as j_block
import tendermint_tpu.types.params as j_params
import tendermint_tpu.types.validation as j_val
import tendermint_tpu_torch.abci.types as p_abci
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.light.types as p_ltypes
import tendermint_tpu_torch.statesync.fleet as p_fleet
import tendermint_tpu_torch.statesync.messages as p_msg
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.block as p_block
import tendermint_tpu_torch.types.params as p_params
import tendermint_tpu_torch.types.validation as p_val

torch.set_num_threads(1)

CHAIN = "boot-fleet-chain"

REF = types.SimpleNamespace(
    abci=j_abci, config=j_config, ltypes=j_ltypes, fleet=j_fleet, msg=j_msg, tt=j_tt,
    block=j_block, params=j_params, val=j_val, kw={},
)
PORT = types.SimpleNamespace(
    abci=p_abci, config=p_config, ltypes=p_ltypes, fleet=p_fleet, msg=p_msg, tt=p_tt,
    block=p_block, params=p_params, val=p_val, kw={"device": "cpu"},
)


def ed_blocks(ns, n=6, n_vals=4):
    vals, keys = ns.tt.make_validator_set(n_vals)
    return ns.tt.make_light_chain(n, vals, keys, CHAIN)


def bls_blocks(ns, n=3, n_vals=4):
    vals, keys = ns.tt.make_validator_set(n_vals, key_types=("bls12381",))
    return [
        ns.ltypes.LightBlock(
            ns.ltypes.SignedHeader(lb.header, ns.block.aggregate_commit(lb.signed_header.commit, vals)),
            lb.validators,
        )
        for lb in ns.tt.make_light_chain(n, vals, keys, CHAIN)
    ]


def tamper(ns, blocks, height_index=2):
    """Flip the last bit of signature 0 of one block's commit."""
    lb = blocks[height_index]
    sigs = list(lb.signed_header.commit.signatures)
    bad = sigs[0].signature[:-1] + bytes([sigs[0].signature[-1] ^ 0x01])
    sigs[0] = dataclasses.replace(sigs[0], signature=bad)
    commit = dataclasses.replace(lb.signed_header.commit, signatures=tuple(sigs))
    blocks = list(blocks)
    blocks[height_index] = ns.ltypes.LightBlock(ns.ltypes.SignedHeader(lb.header, commit), lb.validators)
    return blocks


# -- wire messages -----------------------------------------------------------


def _messages(ns):
    m = ns.msg
    chain = ed_blocks(ns, n=3)
    params = ns.params.ConsensusParams().update(
        evidence=ns.params.EvidenceParams(max_age_num_blocks=77, max_age_duration_ns=5 * 10**9)
    )
    return {
        "snapshots_request": m.SnapshotsRequest(),
        "snapshots_response": m.SnapshotsResponse(60, 1, 3, b"\x5a" * 32, b"meta"),
        "snapshots_response_empty": m.SnapshotsResponse(0, 0, 0, b""),
        "chunk_request": m.ChunkRequest(60, 1, 2),
        "chunk_response": m.ChunkResponse(60, 1, 2, bytes(range(256)) * 3),
        "chunk_response_missing": m.ChunkResponse(60, 1, 9, missing=True),
        "chunk_response_busy": m.ChunkResponse(60, 1, 1, busy=True),
        "light_block_request": m.LightBlockRequest(17),
        "light_block_response": m.LightBlockResponse(chain[1]),
        "light_block_response_none": m.LightBlockResponse(None),
        "light_block_batch_request": m.LightBlockBatchRequest(59, 64),
        "light_block_batch_response": m.LightBlockBatchResponse(tuple(reversed(chain))),
        "light_block_batch_response_empty": m.LightBlockBatchResponse(()),
        "params_request": m.ParamsRequest(61),
        "params_response": m.ParamsResponse(61, params),
        "params_response_default": m.ParamsResponse(1, ns.params.ConsensusParams()),
        "params_response_none": m.ParamsResponse(5, None),
    }


MESSAGE_CASES = sorted(_messages(PORT))


@pytest.fixture(scope="module")
def messages():
    return _messages(REF), _messages(PORT)


@pytest.mark.parametrize("name", MESSAGE_CASES)
def test_message_bytes_match_reference_and_round_trip(messages, name):
    ref, port = messages[0][name], messages[1][name]
    ref_bytes, port_bytes = j_msg.encode_message(ref), p_msg.encode_message(port)
    assert port_bytes == ref_bytes
    assert p_msg.encode_message(p_msg.decode_message(ref_bytes)) == ref_bytes
    assert j_msg.encode_message(j_msg.decode_message(port_bytes)) == port_bytes
    assert type(p_msg.decode_message(port_bytes)).__name__ == type(ref).__name__


def _bomb_frames(ns):
    import tendermint_tpu_torch.libs.protoenc as pe

    m = ns.msg
    lb = ed_blocks(ns, n=1)[0].encode()
    return {
        "backfill_request_count": pe.message_field(
            m.T_LIGHT_BLOCK_BATCH_REQUEST,
            pe.varint_field(1, 100) + pe.varint_field(2, m.MAX_WIRE_BACKFILL_BATCH + 1)),
        "backfill_response_blocks": pe.message_field(
            m.T_LIGHT_BLOCK_BATCH_RESPONSE,
            b"".join(pe.message_field(1, lb) for _ in range(m.MAX_WIRE_BACKFILL_BATCH + 1))),
        "snapshot_chunks": pe.message_field(
            m.T_SNAPSHOTS_RESPONSE, pe.varint_field(3, m.MAX_WIRE_SNAPSHOT_CHUNKS + 1)),
        "snapshot_hash": pe.message_field(
            m.T_SNAPSHOTS_RESPONSE, pe.bytes_field(4, b"\x00" * (m.MAX_WIRE_SNAPSHOT_HASH + 1))),
    }


@pytest.mark.parametrize("frame", sorted(_bomb_frames(PORT)))
def test_wire_bounds_raise_as_the_reference_does(frame):
    data = _bomb_frames(PORT)[frame]
    assert data == _bomb_frames(REF)[frame]
    with pytest.raises(ValueError) as mine:
        p_msg.decode_message(data)
    with pytest.raises(ValueError) as ref:
        j_msg.decode_message(data)
    assert str(mine.value) == str(ref.value)
    for name in ("MAX_WIRE_BACKFILL_BATCH", "MAX_WIRE_SNAPSHOT_CHUNKS", "MAX_WIRE_SNAPSHOT_HASH",
                 "MAX_WIRE_SNAPSHOT_METADATA", "MAX_WIRE_CHUNK"):
        assert getattr(p_msg, name) == getattr(j_msg, name)


# -- BootD serving -------------------------------------------------------------


class _SnapshotConn:
    """The snapshot-connection surface BootD talks to, with a gate so a
    scenario can hold a store read in flight."""

    def __init__(self, abci, snapshots, chunks):
        self.abci = abci
        self.snapshots = tuple(snapshots)
        self.chunks = dict(chunks)
        self.gate = asyncio.Event()
        self.gate.set()
        self.loads = 0

    async def list_snapshots(self):
        return self.abci.ResponseListSnapshots(self.snapshots)

    async def load_snapshot_chunk(self, req):
        await self.gate.wait()
        self.loads += 1
        return self.abci.ResponseLoadSnapshotChunk(self.chunks.get((req.height, req.format, req.chunk), b""))


def make_bootd(ns, **cfg):
    snap = ns.abci.Snapshot(height=10, format=1, chunks=3, hash=b"\x01" * 32)
    conn = _SnapshotConn(ns.abci, (snap,), {(10, 1, i): bytes([i]) * 64 for i in range(3)})
    d = ns.fleet.BootD(types.SimpleNamespace(snapshot=conn),
                       config=ns.config.BootDConfig(refresh_s=0.05, **cfg))
    return d, conn


async def _cache(ns):
    d, conn = make_bootd(ns)
    await d.start()
    try:
        out = [await d.serve_chunk(10, 1, 0) for _ in range(3)]
    finally:
        await d.stop()
    return out, conn.loads, d.cache_hit_rate(), dict(d.stats)


async def _coalesce(ns):
    d, conn = make_bootd(ns)
    await d.start()
    try:
        conn.gate.clear()
        tasks = [asyncio.ensure_future(d.serve_chunk(10, 1, 1)) for _ in range(4)]
        await asyncio.sleep(0.05)
        conn.gate.set()
        out = await asyncio.gather(*tasks)
    finally:
        await d.stop()
    return out, conn.loads, dict(d.stats)


async def _shed(ns):
    d, conn = make_bootd(ns, max_sessions=1)
    await d.start()
    try:
        warm = await d.serve_chunk(10, 1, 0)
        conn.gate.clear()
        t1 = asyncio.ensure_future(d.serve_chunk(10, 1, 1))
        await asyncio.sleep(0.05)
        try:
            await d.serve_chunk(10, 1, 2)
            shed = None
        except ns.fleet.BootDBusyError as e:
            shed = str(e)
        hit = await d.serve_chunk(10, 1, 0)
        t2 = asyncio.ensure_future(d.serve_chunk(10, 1, 1))
        await asyncio.sleep(0.05)
        conn.gate.set()
        out = (await t1, await t2)
    finally:
        await d.stop()
    return warm, shed, hit, out, dict(d.stats)


async def _prune(ns):
    d, conn = make_bootd(ns)
    await d.start()
    try:
        first = [s.height for s in await d.serve_snapshots()]
        await d.serve_chunk(10, 1, 0)
        await d.serve_chunk(10, 1, 1)
        conn.snapshots = (ns.abci.Snapshot(height=20, format=1, chunks=1, hash=b"\x02" * 32),)
        manifest = [s.height for s in await d.refresh_manifest()]
        missing = await d.serve_chunk(99, 1, 0)
    finally:
        await d.stop()
    stats = dict(d.stats)
    stats.pop("manifest_refreshes")  # the loop's own refreshes race the test's
    stats.pop("pruned_chunks")
    return first, manifest, dict(d._chunks), missing, d.stats["pruned_chunks"] >= 2, stats


async def _interval(ns):
    d, conn = make_bootd(ns, snapshot_interval=20)
    conn.snapshots += (ns.abci.Snapshot(height=20, format=1, chunks=1, hash=b"\x02" * 32),)
    await d.start()
    try:
        return [s.height for s in await d.serve_snapshots()]
    finally:
        await d.stop()


SERVING = {"cache": _cache, "coalesce": _coalesce, "shed": _shed, "prune": _prune,
           "interval": _interval}
EXPECTED = {
    "cache": lambda r: r[1] == 1 and r[3]["cache_hits"] == 2 and r[3]["chunk_bytes"] == 192,
    "coalesce": lambda r: r[1] == 1 and r[2]["coalesced"] == 3 and r[2]["sheds"] == 0,
    "shed": lambda r: r[1] is not None and "busy" in r[1] and r[4]["sheds"] == 1
    and r[4]["coalesced"] == 1,
    "prune": lambda r: r[1] == [20] and r[2] == {} and r[3] == b"" and r[4],
    "interval": lambda r: r == [20],
}


@pytest.mark.parametrize("case", sorted(SERVING))
def test_bootd_serving_matches_reference(case):
    ref = asyncio.run(SERVING[case](REF))
    port = asyncio.run(SERVING[case](PORT))
    assert port == ref
    assert EXPECTED[case](port)


def test_bootd_reads_no_env(monkeypatch):
    """The reference's BootD takes TMTPU_BOOTD_* over its config; the
    port's takes its config alone."""
    monkeypatch.setenv("TMTPU_BOOTD_SESSIONS", "3")
    monkeypatch.setenv("TMTPU_BOOTD_CHUNK_CACHE", "5")
    monkeypatch.setenv("TMTPU_BOOTD_REFRESH_S", "7.5")
    port, _ = make_bootd(PORT)
    ref, _ = make_bootd(REF)
    assert (port.max_sessions, port.chunk_cache_size, port.refresh_s) == (32, 256, 0.05)
    assert (ref.max_sessions, ref.chunk_cache_size, ref.refresh_s) == (3, 5, 7.5)
    assert dataclasses.asdict(p_config.BootDConfig()) == dataclasses.asdict(j_config.BootDConfig())


def test_aggregate_sums_live_bootds():
    async def run(ns):
        ds = [make_bootd(ns)[0] for _ in range(2)]
        for d in ds:
            await d.start()
        try:
            await ds[0].serve_chunk(10, 1, 0)
            await ds[1].serve_chunk(10, 1, 1)
            ds[1].record_synced(0.7)
            stats, hist = ns.fleet.aggregate()
        finally:
            for d in ds:
                await d.stop()
        return stats["chunks_served"], stats["synced"], hist

    assert asyncio.run(run(PORT)) == asyncio.run(run(REF))
    assert p_fleet.aggregate() == (None, None)


# -- verified backfill ---------------------------------------------------------


async def _backfill(ns, blocks):
    d, _ = make_bootd(ns)
    try:
        n = await ns.fleet.verify_backfill_batch(CHAIN, blocks, bootd=d, **ns.kw)
        err = None
    except ns.val.InvalidCommitError as e:
        n, err = None, (str(e), getattr(e, "failed_index", None))
    keys = ("backfill_heights", "backfill_sigs", "backfill_agg_heights", "backfill_batches")
    return n, err, {k: d.stats[k] for k in keys}


@pytest.mark.parametrize("case", ["per_sig", "tampered"])
def test_verify_backfill_batch_ed25519_matches_reference(case):
    def blocks(ns):
        b = ed_blocks(ns, n=5)
        return tamper(ns, b) if case == "tampered" else b

    ref = asyncio.run(_backfill(REF, blocks(REF)))
    port = asyncio.run(_backfill(PORT, blocks(PORT)))
    assert port == ref
    if case == "per_sig":
        assert port[0] == 20 and port[2] == {"backfill_heights": 5, "backfill_sigs": 20,
                                             "backfill_agg_heights": 0, "backfill_batches": 1}
    else:
        assert port[1] is not None and port[1][1] == 2  # the tampered height's entry
        assert port[2]["backfill_heights"] == 0 and port[2]["backfill_batches"] == 0


def test_verify_backfill_batch_aggregate_one_pairing_per_height():
    """3 heights of a 4-validator bls12381 committee, each folded into one
    aggregate: one pairing check per height (the port's through K7a/K7b's
    plain versions), 12 signatures covered."""
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    ref_blocks, port_blocks = bls_blocks(REF), bls_blocks(PORT)
    assert [lb.encode() for lb in port_blocks] == [lb.encode() for lb in ref_blocks]
    assert all(lb.signed_header.commit.is_aggregate() for lb in port_blocks)
    calls = []
    real = BP._final_exp_plain

    def counted(f):
        calls.append(tuple(f.shape[:2]))
        return real(f)

    BP._final_exp_plain = counted
    try:
        port = asyncio.run(_backfill(PORT, port_blocks))
    finally:
        BP._final_exp_plain = real
    ref = asyncio.run(_backfill(REF, ref_blocks))
    assert port == ref
    assert port[0] == 12 and port[2]["backfill_agg_heights"] == 3
    assert len(calls) == 3


def test_verify_backfill_batch_empty_is_a_noop():
    assert asyncio.run(p_fleet.verify_backfill_batch(CHAIN, [], device="cpu")) == 0
    assert asyncio.run(j_fleet.verify_backfill_batch(CHAIN, [])) == 0


# -- the reactor and the restore scenario ---------------------------------------


def _reactor(**kw):
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    chs = [Channel(cid, "c", 5, p_msg.encode_message, p_msg.decode_message)
           for cid in (0x60, 0x61, 0x62, 0x63)]
    return StateSyncReactor("c", AppConns.local(KVStoreApp()), StateStore(MemDB()),
                            BlockStore(MemDB()), *chs, asyncio.Queue(), **kw)


def test_reactor_raises_without_a_card_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _reactor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _reactor(device="cuda")
    assert _reactor(device="cpu").device == torch.device("cpu")


@pytest.fixture(scope="module")
def restored():
    """The restore scenario of both packages at 16 blocks of 4 validators
    (snapshots every 10 heights: the snapshot at 10, 9 headers
    backfilled). The reference's restored State is read off its
    reactor's `sync`."""
    got = {}
    real = j_reactor.StateSyncReactor.sync

    async def sync(self, cfg):
        state = await real(self, cfg)
        got.update(state=state, client=self)
        return state

    j_reactor.StateSyncReactor.sync = sync
    try:
        ref_held = asyncio.run(j_tt.statesync_restore_scenario(16, 4))
    finally:
        j_reactor.StateSyncReactor.sync = real
    report: dict = {}
    port_held = asyncio.run(p_tt.statesync_restore_scenario(16, 4, device="cpu", report=report))
    return {"ref": (ref_held, got), "port": (port_held, report)}


def test_restore_scenario_holds_the_same_headers_and_state(restored):
    ref_held, ref = restored["ref"]
    port_held, port = restored["port"]
    assert port_held == ref_held == 10
    assert port["state"].encode() == ref["state"].encode()
    assert port["state"].app_hash == ref["state"].app_hash
    assert port["state"].last_block_height == 10
    for h in range(1, 11):
        assert port["block_store"].load_block_meta(h).header.hash() == \
            ref["client"].block_store.load_block_meta(h).header.hash()
    pstats, rstats = port["client"].bootd.stats, ref["client"].bootd.stats
    for k in ("backfill_heights", "backfill_sigs", "backfill_batches", "synced"):
        assert pstats[k] == rstats[k]
    assert pstats["backfill_heights"] == 9 and pstats["backfill_sigs"] == 36
