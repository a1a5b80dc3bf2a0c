"""The port's full node (tendermint_tpu_torch/node.py) and its metrics
exporter (libs/metrics.py) on the CPU, against the JAX package's:

- the frozen-clock recipe on full Nodes (3 equal-power validators, a
  `ManualClock` 500 ms behind genesis, 60 s propose/prevote/precommit
  timeouts, a tx in the first proposer's mempool before its consensus
  starts) over the memory transport: blocks 1-3 and the app-hash chain
  byte-equal to the reference's node net of the same genesis and keys;
- a late joiner block-syncs a chain from a source Node, its ranges on the
  `kernel_eq` path (the plain version on the CPU, with
  `crypto.batch.MIN_TPU_BATCH` patched down as tests/test_torch_batch.py
  does), byte-equal to the source's;
- a byzantine source whose top block carries a flipped commit signature
  is punished: a fatal PeerError, the Router drops it, its score falls,
  nothing from the bad height is applied;
- a port Node block-syncs a reference Node's chain over TCP with the
  secret connection: the wire is equal end to end;
- `NodeMetrics.render()`: the reference's family names, HELP and TYPE
  lines (with the differences by design pinned in libs/metrics.py), and
  `observe_block` folds the same chain into the same lines;
- settings the port does not run yet (chaos, chaos-fs, RPC) raise.

Every port Node runs on device="cpu". The tolerance is zero (bytes)."""

from __future__ import annotations

import asyncio
import shutil
import types
from dataclasses import replace

import pytest

import tendermint_tpu.abci.kvstore as j_kv
import tendermint_tpu.abci.types as j_abci
import tendermint_tpu.config as j_config
import tendermint_tpu.consensus.harness as j_harness
import tendermint_tpu.crypto.ed25519 as j_ed
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu.libs.metrics as j_metrics
import tendermint_tpu.node as j_node
import tendermint_tpu.p2p.memory as j_memory
import tendermint_tpu.p2p.tcp as j_tcp
import tendermint_tpu.p2p.types as j_types
import tendermint_tpu.privval as j_pv
import tendermint_tpu.proxy as j_proxy
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.block as j_block
import tendermint_tpu_torch.abci.kvstore as p_kv
import tendermint_tpu_torch.abci.types as p_abci
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.crypto.ed25519 as p_ed
import tendermint_tpu_torch.libs.clock as p_clock
import tendermint_tpu_torch.libs.metrics as p_metrics
import tendermint_tpu_torch.node as p_node
import tendermint_tpu_torch.p2p.memory as p_memory
import tendermint_tpu_torch.p2p.tcp as p_tcp
import tendermint_tpu_torch.p2p.types as p_types
import tendermint_tpu_torch.privval as p_pv
import tendermint_tpu_torch.proxy as p_proxy
import tendermint_tpu_torch.types.block as p_block
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import testing as p_tt
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto import verify_hub as p_vh

MS = 1_000_000
TX = b"mercury=planet"

REF = types.SimpleNamespace(
    name="ref", harness=j_harness, clock=j_clock, node=j_node, memory=j_memory, types=j_types,
    ed=j_ed, kv=j_kv, abci=j_abci, pv=j_pv, config=j_config, block=j_block, kw={})
PORT = types.SimpleNamespace(
    name="port", harness=p_harness, clock=p_clock, node=p_node, memory=p_memory, types=p_types,
    ed=p_ed, kv=p_kv, abci=p_abci, pv=p_pv, config=p_config, block=p_block, kw={"device": "cpu"})


async def _stop(nodes) -> None:
    await asyncio.gather(*(n.stop() for n in nodes), return_exceptions=True)
    for n in nodes:
        if n.consensus is not None:
            shutil.rmtree(n.consensus.wal.dir, ignore_errors=True)


def _node_key(pkg, i: int):
    return pkg.ed.Ed25519PrivKey(bytes([0x40 + i]) * 32)


def _memory_node(pkg, memory, i: int, genesis, app, **kw):
    key = _node_key(pkg, i)
    transport = memory.create_transport(pkg.types.node_id_from_pubkey(key.pub_key()))
    return pkg.node.Node(kw.pop("config"), genesis, app, key, [transport], **kw, **pkg.kw)


# -- the frozen-clock validator net --------------------------------------------


async def frozen_node_net(pkg, height: int = 3):
    """The frozen-clock recipe on full Nodes in `pkg`: every node's blocks
    1..height, the app-hash chain, and the tx's value in every node's app."""
    genesis, keys = pkg.harness.make_genesis(3)
    cfg = pkg.harness.fast_config()
    for f in ("timeout_propose_ns", "timeout_prevote_ns", "timeout_precommit_ns"):
        setattr(cfg, f, 60_000 * MS)
    clock = pkg.clock.ManualClock(pkg.harness.GENESIS_TIME_NS - 500 * MS)
    memory = pkg.memory.MemoryNetwork()
    proposer = genesis.validator_set().get_proposer().address
    nodes, apps = [], []
    for i, k in enumerate(keys):
        app = pkg.kv.KVStoreApp()
        node = _memory_node(pkg, memory, i, genesis, app, priv_validator=pkg.pv.MockPV(k),
                            config=pkg.node.NodeConfig(consensus=cfg, clock=clock))
        if k.pub_key().address() == proposer:
            real_start = node._start_consensus

            async def start_consensus(node=node, real_start=real_start):
                await node.mempool.check_tx(TX)
                await real_start()

            node._start_consensus = start_consensus
        nodes.append(node)
        apps.append(app)
    try:
        for n in nodes:
            await n.start()
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                a.peer_manager.add_address(pkg.types.NodeAddress(node_id=b.node_id,
                                                                 protocol="memory"))
        await asyncio.gather(*(n.wait_for_height(height, 60) for n in nodes))
        blocks = [[n.block_store.load_block(h).encode() for h in range(1, height + 1)]
                  for n in nodes]
        app_hashes = [nodes[0].block_store.load_block(h).header.app_hash
                      for h in range(1, height + 1)]
        values = [a.query(pkg.abci.RequestQuery(data=b"mercury")).value for a in apps]
        return blocks, app_hashes, values
    finally:
        await _stop(nodes)


@pytest.fixture(scope="module")
def nets():
    return {pkg.name: asyncio.run(frozen_node_net(pkg)) for pkg in (PORT, REF)}


def test_frozen_node_net_is_byte_equal_to_the_reference(nets):
    (p_blocks, p_hashes, p_values), (j_blocks, j_hashes, j_values) = nets["port"], nets["ref"]
    assert all(b == p_blocks[0] for b in p_blocks)  # every node, the same chain
    assert p_blocks[0] == j_blocks[0] and p_hashes == j_hashes
    assert TX in p_block.Block.decode(p_blocks[0][0]).txs  # block 1 carries the tx
    assert p_values == j_values == [b"planet"] * 3  # committed on every node


# -- block-sync between Nodes ----------------------------------------------------


def _chain(n_vals: int, n_blocks: int):
    keys = p_tt.det_priv_keys(n_vals)
    genesis = p_tt.make_genesis(keys, "node-chain")
    bstore, sstore, conns, state = asyncio.run(
        p_tt.build_kvstore_chain(genesis, keys, n_blocks, device="cpu"))
    return types.SimpleNamespace(genesis=genesis, store=bstore, state_store=sstore,
                                 app=conns.consensus.app, state=state)


def _source(memory, chain, i: int):
    """A port Node serving `chain` (its stores and app), block-sync off."""
    return _memory_node(PORT, memory, i, chain.genesis, p_proxy.AppConns.local(chain.app),
                        block_db=chain.store.db, state_db=chain.state_store.db,
                        config=p_node.NodeConfig(block_sync=False))


def _assert_synced(joiner, store, top: int) -> None:
    assert joiner.block_store.height() == top
    for h in range(1, top + 1):
        assert joiner.block_store.load_block(h).encode() == store.load_block(h).encode()


def _route_log(monkeypatch) -> list:
    real = p_batch.AdaptiveBatchVerifier.verify
    routes: list = []

    def verify(bv):
        out = real(bv)
        routes.append((len(bv._items), bv.last_route))
        return out

    monkeypatch.setattr(p_batch.AdaptiveBatchVerifier, "verify", verify)
    return routes


def test_late_joiner_ranges_take_the_kernel_eq_path(monkeypatch):
    """4 validators, 16 blocks: with MIN_TPU_BATCH at 8, every range of 3
    or more blocks (9 signatures at light semantics) runs the plain
    kernel_eq through the nodes' hub on the CPU."""
    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 8)
    routes = _route_log(monkeypatch)
    chain = _chain(4, 16)

    async def go():
        memory = p_memory.MemoryNetwork()
        src = _source(memory, chain, 0)
        joiner = _memory_node(PORT, memory, 1, chain.genesis, p_kv.KVStoreApp(),
                              config=p_node.NodeConfig())
        try:
            await src.start()
            await joiner.start()
            joiner.peer_manager.add_address(p_types.NodeAddress(node_id=src.node_id,
                                                                protocol="memory"))
            await asyncio.wait_for(joiner.blocksync_reactor.synced.wait(), 60)
            hub = p_vh.running_hub()
            return joiner, hub.stats(), str(hub.device)
        finally:
            await _stop([joiner, src])

    joiner, hs, hub_device = asyncio.run(go())
    _assert_synced(joiner, chain.store, 15)
    assert joiner.state_store.load().app_hash == chain.store.load_block(16).header.app_hash
    assert hub_device == "cpu" and hs["verify_errors"] == 0 and p_vh.running_hub() is None
    assert any(route == "cuda" and n >= 8 for n, route in routes), routes
    assert all(route == ("cuda" if n >= 8 else "cpu") for n, route in routes)


def test_byzantine_source_is_dropped():
    """A source that serves the chain up to block 9, whose LastCommit
    carries a flipped signature bit: the joiner punishes height 8 with a
    fatal PeerError naming it, the Router drops it and its score falls;
    nothing from height 8 on is applied; then it syncs from an honest
    source."""
    chain = _chain(4, 12)
    good = chain.store.load_block(9)
    sigs = list(good.last_commit.signatures)
    s = sigs[1].signature
    sigs[1] = replace(sigs[1], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    bad = p_block.Block(good.header, good.txs, good.evidence,
                        replace(good.last_commit, signatures=tuple(sigs)))

    async def go():
        memory = p_memory.MemoryNetwork()
        byz = _source(memory, chain, 0)
        honest = _source(memory, chain, 2)
        joiner = _memory_node(PORT, memory, 1, chain.genesis, p_kv.KVStoreApp(),
                              config=p_node.NodeConfig())
        errors = []
        real_errored = joiner.peer_manager.errored
        joiner.peer_manager.errored = lambda e: (errors.append(e), real_errored(e))
        try:
            await byz.start()
            real_load = byz.block_store.load_block
            byz.block_store.height = lambda: 9
            byz.block_store.load_block = lambda h: bad if h == 9 else (
                real_load(h) if h < 9 else None)
            await honest.start()
            await joiner.start()
            sub = joiner.peer_manager.subscribe()
            joiner.peer_manager.add_address(p_types.NodeAddress(node_id=byz.node_id,
                                                                protocol="memory"))
            while not errors:
                await asyncio.sleep(0.01)
            down = await asyncio.wait_for(_next_down(sub, byz.node_id), 10)
            applied = joiner.block_store.height()
            score = joiner.peer_manager.peer_score(byz.node_id)
            await byz.stop()
            joiner.peer_manager.add_address(p_types.NodeAddress(node_id=honest.node_id,
                                                                protocol="memory"))
            await asyncio.wait_for(joiner.blocksync_reactor.synced.wait(), 60)
            return joiner, byz.node_id, errors, down, applied, score
        finally:
            await _stop([joiner, honest, byz])

    joiner, byz_id, errors, down, applied, score = asyncio.run(go())
    assert errors[0].node_id == byz_id and errors[0].fatal and "bad block" in errors[0].err
    assert down and applied < 8 and score < 1
    _assert_synced(joiner, chain.store, 11)


async def _next_down(sub, node_id) -> bool:
    while True:
        u = await sub.get()
        if u.node_id == node_id and u.status.value == "down":
            return True


def test_port_node_block_syncs_a_reference_node_over_tcp():
    """A reference Node serves its 12-block chain (txs every third
    block) over TCP; a port Node on device="cpu" dials it, runs the secret
    connection and block-syncs it: blocks 1-11 byte-equal, the State the
    reference's."""
    ref_store, ref_sstore, ref_conns, ref_genesis, _ = asyncio.run(
        j_tt.build_kvstore_chain(12, 4, "tcp-chain"))

    async def go():
        j_t, p_t = j_tcp.TCPTransport(), p_tcp.TCPTransport()
        await j_t.listen("127.0.0.1:0")
        await p_t.listen("127.0.0.1:0")
        src = j_node.Node(
            j_node.NodeConfig(block_sync=False,
                              verify_hub=j_config.VerifyHubConfig(enabled=False)),
            ref_genesis, j_proxy.AppConns.local(ref_conns.consensus.app),
            _node_key(REF, 0), [j_t], block_db=ref_store.db, state_db=ref_sstore.db)
        joiner = p_node.Node(p_node.NodeConfig(), convert.genesis(ref_genesis),
                             p_kv.KVStoreApp(), _node_key(PORT, 1), [p_t], device="cpu")
        try:
            await src.start()
            await joiner.start()
            host, port = j_t.endpoint().rsplit(":", 1)
            joiner.peer_manager.add_address(p_types.NodeAddress(
                node_id=src.node_id, protocol="tcp", host=host, port=int(port)))
            await asyncio.wait_for(joiner.blocksync_reactor.synced.wait(), 60)
            conn = joiner.router._peers[src.node_id].conn
            return joiner, conn.recv_meter.total
        finally:
            await _stop([joiner])
            await src.stop()
            if src.consensus is not None:
                shutil.rmtree(src.consensus.wal.dir, ignore_errors=True)

    joiner, received = asyncio.run(go())
    _assert_synced(joiner, ref_store, 11)
    state = joiner.state_store.load()
    assert state.app_hash == ref_store.load_block(12).header.app_hash
    assert state.last_block_height == 11 and received > 0


# -- metrics -------------------------------------------------------------------


def _families(text: str) -> tuple[dict, dict]:
    helps, kinds = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, rest = line[7:].partition(" ")
            helps[name] = rest
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            kinds[name] = kind
    return helps, kinds


def test_node_metrics_families_equal_the_reference_but_by_design():
    p_help, p_kind = _families(p_metrics.NodeMetrics().render())
    j_help, j_kind = _families(j_metrics.NodeMetrics().render())
    ns = "tendermint_tpu_"
    not_rendered = {ns + n for n in p_metrics.NOT_RENDERED}
    port_only = {ns + n for n in p_metrics.PORT_ONLY}
    changed = {ns + n for n in p_metrics.HELP_CHANGED}
    assert not_rendered <= set(j_kind) and not (not_rendered & set(p_kind))
    assert set(p_kind) == (set(j_kind) - not_rendered) | port_only
    assert {n: k for n, k in p_kind.items() if n not in port_only} == \
        {n: k for n, k in j_kind.items() if n not in not_rendered}
    for name in set(p_help) - port_only:
        assert (p_help[name] != j_help[name]) == (name in changed), name
    # the port names no breaker, degrade or fallback of its own
    assert not [n for n in p_kind if "breaker" in n or "degrade" in n]


def test_observe_block_folds_equal_the_reference(nets):
    p_blocks, j_blocks = nets["port"][0][0], nets["ref"][0][0]
    pm, jm = p_metrics.NodeMetrics(), j_metrics.NodeMetrics()
    for p_raw, j_raw in zip(p_blocks, j_blocks):
        p_metrics.observe_block(pm, p_block.Block.decode(p_raw))
        j_metrics.observe_block(jm, j_block.Block.decode(j_raw))
    pick = ("consensus_height ", "consensus_num_txs ", "consensus_block_interval_seconds_count")
    lines = lambda m: [ln for ln in m.render().splitlines()  # noqa: E731
                       if ln.startswith(tuple("tendermint_tpu_" + p for p in pick))]
    assert lines(pm) == lines(jm)
    assert "tendermint_tpu_consensus_height 3" in lines(pm)


def test_node_metrics_fold_the_device_errors_and_a_running_hub():
    from tendermint_tpu_torch.libs.metrics import RESILIENCE

    hub = p_vh.acquire_hub(device="cpu", max_batch=64)
    try:
        text = p_metrics.NodeMetrics().render()
    finally:
        p_vh.release_hub()
    assert f"tendermint_tpu_crypto_device_error_batches " \
        f"{p_metrics._fmt(RESILIENCE['device_error_batches'])}" in text
    assert 'tendermint_tpu_verifyhub_lane_queued{lane="live"} 0' in text
    assert 'tendermint_tpu_backend_active{kind="cuda"}' in text
    assert hub is not None


# -- the chaos settings, and the one the port does not run yet (RPC) ----------


#: each setting: the NodeConfig fields it sets (built per package), or
#: the env var it arms
SETTINGS = {
    "chaos": lambda pkg: {"chaos": pkg.config.ChaosNetConfig(
        enabled=True, seed=3, drop_rate=0.05, clock_skew_ms=50.0, clock_drift=0.01)},
    "chaos_fs": lambda pkg: {"chaos_fs": pkg.config.ChaosFSConfig(
        enabled=True, seed=4, torn_write_rate=0.5)},
    "rpc_laddr": lambda pkg: {"rpc_laddr": "127.0.0.1:0"},
    "chaos-env": ("TMTPU_CHAOS_DROP", "0.1"),
    "chaos-fs-env": ("TMTPU_CHAOS_FS_TORN", "0.5"),
    "enospc-at-env": ("TMTPU_CHAOS_FS_ENOSPC_AT", "0"),
}


def _chaos_wiring(pkg, cfg_fields: dict, start: bool = True) -> dict:
    """What a Node of `pkg` built with `cfg_fields` wired (and, with
    `start`, started to height 1 and stopped): its chaos-net and chaos-fs
    configs, the types of its transports and DBs, its validator clock's
    skew, whether its WAL runs on its chaos FS."""
    genesis, keys = pkg.harness.make_genesis(1)
    cfg = pkg.node.NodeConfig(consensus=pkg.harness.fast_config(), block_sync=False,
                              **cfg_fields)
    node = _memory_node(pkg, pkg.memory.MemoryNetwork(), 0, genesis, pkg.kv.KVStoreApp(),
                        config=cfg, priv_validator=pkg.pv.MockPV(keys[0]))

    async def run():
        await node.start()
        try:
            await node.wait_for_height(1, 20)
        finally:
            await _stop([node])

    if start:
        asyncio.run(asyncio.wait_for(run(), 40))
    clock = node.consensus.clock if start else None
    return {
        "chaos_net": None if node.chaos_net is None else vars(node.chaos_net.config),
        "chaos_fs": None if node.chaos_fs is None else vars(node.chaos_fs.config),
        "transports": sorted(type(t).__name__ for t in node.router.transports.values())
        if isinstance(node.router.transports, dict)
        else sorted(type(t).__name__ for t in node.router.transports),
        "dbs": (type(node.block_store.db).__name__, type(node.state_store.db).__name__),
        "clock": (getattr(clock, "offset_ns", None), getattr(clock, "rate", None)),
        "wal_fs_is_chaos_fs": start and node.consensus.wal.fs is node.chaos_fs,
    }


@pytest.mark.parametrize("setting", list(SETTINGS), ids=list(SETTINGS))
def test_unported_settings_raise(setting, monkeypatch):
    """The reference's chaos settings now wire as the reference wires them
    (chaos-net wraps every transport and skews the validator's clock;
    chaos-fs wraps the block and state DBs and runs the WAL on its FS),
    from the config sections and from an armed TMTPU_CHAOS_* /
    TMTPU_CHAOS_FS_* env alike; a seed alone arms nothing. Only RPC still
    waits for its port, and raises."""
    spec = SETTINGS[setting]
    if setting == "rpc_laddr":
        genesis, _ = p_harness.make_genesis(1)
        with pytest.raises(NotImplementedError, match="RPC"):
            p_node.Node(p_node.NodeConfig(**spec(PORT)), genesis, p_kv.KVStoreApp(),
                        _node_key(PORT, 0), [p_memory.MemoryNetwork().create_transport("x")],
                        device="cpu")
        return
    if callable(spec):
        ref, port = _chaos_wiring(REF, spec(REF)), _chaos_wiring(PORT, spec(PORT))
    else:
        # ENOSPC at byte 0 stops the WAL's first write: wiring only
        start = setting != "enospc-at-env"
        monkeypatch.setenv(*spec)
        ref, port = _chaos_wiring(REF, {}, start), _chaos_wiring(PORT, {}, start)
    assert port == ref
    net_armed = setting in ("chaos", "chaos-env")
    assert (port["chaos_net"] is not None) == net_armed
    assert (port["chaos_fs"] is not None) == (not net_armed)
    if net_armed:
        assert port["transports"] == ["ChaosTransport"]
        if setting == "chaos":
            assert port["clock"][0] is not None and port["clock"][1] != 1.0
    else:
        assert port["dbs"] == ("ChaosDB", "ChaosDB")
        assert port["wal_fs_is_chaos_fs"] == (setting != "enospc-at-env")
    monkeypatch.delenv(spec[0] if not callable(spec) else "TMTPU_NONE", raising=False)
    monkeypatch.setenv("TMTPU_CHAOS_SEED", "7")  # a seed alone arms nothing
    monkeypatch.setenv("TMTPU_CHAOS_FS_SEED", "7")
    plain = _chaos_wiring(PORT, {})
    assert plain["chaos_net"] is None and plain["chaos_fs"] is None
    assert plain == _chaos_wiring(REF, {})
