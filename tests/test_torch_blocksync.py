"""The port's BlockSyncReactor against the JAX package's, on the CPU.

A chain built by the reference (4 validators, kvstore txs, a validator
joining mid-chain: tests/test_torch_chain.py's) is carried across to the
port through `convert` and replayed by each package's own reactor, fed by
an in-process peer serving the same blocks through a `Channel`. Both end
at the same state: height, app hash, validators hash, the whole encoded
State. A commit with a flipped signature bit punishes the same height in
both, and neither applies a block from that height on. The rotation
scenario of tests/test_blocksync_rotation.py (a `val:` tx inside the
window) recovers through the sequential fallback in the port too. One
replay patches the port's `crypto.batch.MIN_TPU_BATCH` down to 8 so its
ranges reach the plain `kernel_eq`; the others stay on the host route.
The port runs on device="cpu"; the tolerance is zero."""

from __future__ import annotations

import asyncio
import types
from dataclasses import replace

import pytest
import torch

import tendermint_tpu.blocksync.messages as j_bsm
import tendermint_tpu.blocksync.reactor as j_reactor
import tendermint_tpu.consensus.replay as j_replay
import tendermint_tpu.p2p.peermanager as j_pm
import tendermint_tpu.p2p.router as j_router
import tendermint_tpu.p2p.types as j_p2p
import tendermint_tpu.proxy as j_proxy
import tendermint_tpu.state.execution as j_exec
import tendermint_tpu.state.state as j_state
import tendermint_tpu.state.store as j_sstore
import tendermint_tpu.store.blockstore as j_bstore
import tendermint_tpu.store.db as j_db
import tendermint_tpu_torch.blocksync.messages as p_bsm
import tendermint_tpu_torch.blocksync.reactor as p_reactor
import tendermint_tpu_torch.consensus.replay as p_replay
import tendermint_tpu_torch.p2p.peermanager as p_pm
import tendermint_tpu_torch.p2p.router as p_router
import tendermint_tpu_torch.p2p.types as p_p2p
import tendermint_tpu_torch.proxy as p_proxy
import tendermint_tpu_torch.state.execution as p_exec
import tendermint_tpu_torch.state.state as p_state
import tendermint_tpu_torch.state.store as p_sstore
import tendermint_tpu_torch.store.blockstore as p_bstore
import tendermint_tpu_torch.store.db as p_db
from tendermint_tpu.abci.kvstore import KVStoreApp as JKVStoreApp
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.abci.kvstore import KVStoreApp as PKVStoreApp
from tendermint_tpu_torch.crypto import batch as p_batch

from test_torch_chain import (
    N_BLOCKS,
    build_reference_chain,
    chain_txs,
    keys_and_joiner,
    reference_genesis,
)

# the plain kernel_eq runs on small tensors: one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

BLOCKSYNC_CHANNEL = 0x40
WINDOW = 5
TAMPER_HEIGHT, TAMPER_VAL = 7, 1  # the commit FOR height 7 (block 8's LastCommit)

REF = types.SimpleNamespace(
    bsm=j_bsm, reactor=j_reactor, replay=j_replay, pm=j_pm, router=j_router, p2p=j_p2p,
    proxy=j_proxy, exec=j_exec, state=j_state, sstore=j_sstore, bstore=j_bstore, db=j_db,
    app=JKVStoreApp, kw={},
)
PORT = types.SimpleNamespace(
    bsm=p_bsm, reactor=p_reactor, replay=p_replay, pm=p_pm, router=p_router, p2p=p_p2p,
    proxy=p_proxy, exec=p_exec, state=p_state, sstore=p_sstore, bstore=p_bstore, db=p_db,
    app=PKVStoreApp, kw={"device": "cpu"},
)


async def replay(pkg, genesis, blocks: dict, *, window=WINDOW, stop_on_punish=False, timeout=60):
    """Block-sync a fresh node of package `pkg` from an in-process peer
    that serves `blocks` (height → that package's Block). Returns the
    reactor, its final state, the heights it punished, and the peer
    errors it reported."""
    conns = pkg.proxy.AppConns.local(pkg.app())
    bstore = pkg.bstore.BlockStore(pkg.db.MemDB())
    sstore = pkg.sstore.StateStore(pkg.db.MemDB())
    state = await pkg.replay.Handshaker(
        sstore, pkg.state.state_from_genesis(genesis), bstore, genesis, **pkg.kw
    ).handshake(conns)
    sstore.save(state)
    ex = pkg.exec.BlockExecutor(sstore, conns.consensus, block_store=bstore, **pkg.kw)
    ch = pkg.router.Channel(
        BLOCKSYNC_CHANNEL, "blocksync", 5, pkg.bsm.encode_message, pkg.bsm.decode_message
    )
    peer_q: asyncio.Queue = asyncio.Queue()
    reactor = pkg.reactor.BlockSyncReactor(
        state, ex, bstore, ch, peer_q, window=window, active=True, **pkg.kw
    )
    punished, errors, done = [], [], asyncio.Event()
    real_punish = reactor._punish

    async def punish(height, provider, next_provider, err):
        punished.append(height)
        await real_punish(height, provider, next_provider, err)
        if stop_on_punish:
            done.set()

    reactor._punish = punish
    top = max(blocks)

    async def serve():
        while True:
            msg = (await ch.out_q.get()).message
            if isinstance(msg, pkg.bsm.StatusRequest):
                reply = pkg.bsm.StatusResponse(top, 1)
            elif isinstance(msg, pkg.bsm.BlockRequest) and msg.height in blocks:
                reply = pkg.bsm.BlockResponse(blocks[msg.height])
            else:
                continue
            await ch.in_q.put(pkg.p2p.Envelope(BLOCKSYNC_CHANNEL, reply, from_="peer0"))

    async def watch_errors():
        while True:
            errors.append(await ch.err_q.get())

    async def synced():
        await reactor.synced.wait()
        done.set()

    loop = asyncio.get_running_loop()
    tasks = [loop.create_task(f()) for f in (serve, watch_errors, synced)]
    await peer_q.put(pkg.pm.PeerUpdate("peer0", pkg.pm.PeerStatus.UP))
    await reactor.start()
    try:
        await asyncio.wait_for(done.wait(), timeout=timeout)
    finally:
        await reactor.stop()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await conns.stop()
    return reactor, reactor.state, punished, errors


@pytest.fixture(scope="module")
def source():
    keys, joiner = keys_and_joiner()
    genesis = reference_genesis(keys)
    bstore, _sstore, _conns, state = asyncio.run(
        build_reference_chain(genesis, keys + [joiner], chain_txs(joiner.pub_key().bytes()))
    )
    ref_blocks = {h: bstore.load_block(h) for h in range(1, N_BLOCKS + 1)}
    port_store = convert.block_store(bstore)
    port_blocks = {h: port_store.load_block(h) for h in ref_blocks}
    return {"genesis": genesis, "state": state, "store": bstore,
            "ref_blocks": ref_blocks, "port_blocks": port_blocks}


@pytest.fixture(scope="module")
def replays(source):
    async def both():
        j = await replay(REF, source["genesis"], source["ref_blocks"])
        p = await replay(PORT, convert.genesis(source["genesis"]), source["port_blocks"])
        return j, p

    return asyncio.run(both())


def test_carried_blocks_are_byte_identical(source):
    for h, jb in source["ref_blocks"].items():
        assert source["port_blocks"][h].encode() == jb.encode()
        assert convert.block(jb).hash() == jb.hash()


def test_port_reactor_reaches_the_reference_final_state(source, replays):
    (jr, js, jpun, jerr), (pr, ps, ppun, perr) = replays
    # every block but the tip (its commit rides in no block yet)
    assert js.last_block_height == ps.last_block_height == N_BLOCKS - 1
    assert ps.app_hash == js.app_hash
    assert ps.validators.hash() == js.validators.hash()
    assert ps.encode() == js.encode()
    # the source chain's own state after the same height
    assert ps.app_hash == source["ref_blocks"][N_BLOCKS].header.app_hash
    assert ps.validators.hash() == source["ref_blocks"][N_BLOCKS].header.validators_hash
    assert jpun == ppun == [] and jerr == perr == []
    assert pr.metrics["blocks_applied"] == jr.metrics["blocks_applied"] == N_BLOCKS - 1
    assert pr.metrics["ranges"] >= 1


def _tampered(blocks: dict, module) -> dict:
    """`blocks` with one signature bit of the commit for TAMPER_HEIGHT
    flipped (block TAMPER_HEIGHT + 1's LastCommit; its header keeps the
    honest last_commit_hash)."""
    b = blocks[TAMPER_HEIGHT + 1]
    sigs = list(b.last_commit.signatures)
    s = sigs[TAMPER_VAL].signature
    sigs[TAMPER_VAL] = replace(sigs[TAMPER_VAL], signature=s[:9] + bytes([s[9] ^ 0x04]) + s[10:])
    out = dict(blocks)
    out[TAMPER_HEIGHT + 1] = module.Block(
        b.header, b.txs, b.evidence, replace(b.last_commit, signatures=tuple(sigs))
    )
    return out


def test_tampered_commit_punishes_the_same_height(source):
    import tendermint_tpu.types.block as jblock
    import tendermint_tpu_torch.types.block as pblock

    genesis, ref_blocks, port_blocks = (
        source["genesis"], source["ref_blocks"], source["port_blocks"]
    )

    async def both():
        j = await replay(REF, genesis, _tampered(ref_blocks, jblock), stop_on_punish=True)
        p = await replay(PORT, convert.genesis(genesis), _tampered(port_blocks, pblock),
                         stop_on_punish=True)
        return j, p

    (_jr, js, jpun, jerr), (_pr, ps, ppun, perr) = asyncio.run(both())
    assert jpun[:1] == ppun[:1] == [TAMPER_HEIGHT]
    # no block from the punished height on was applied
    assert js.last_block_height == ps.last_block_height == TAMPER_HEIGHT - 1
    assert ps.encode() == js.encode()
    # the peer that served the bad commit is named, fatally
    assert [(e.node_id, e.fatal) for e in perr[:1]] == [(e.node_id, e.fatal) for e in jerr[:1]]
    assert perr[0].node_id == "peer0" and "invalid signature" in perr[0].err


def test_rotation_mid_window_recovers_through_the_sequential_fallback(source):
    """tests/test_blocksync_rotation.py's scenario: the window spans the
    join (committed at 5, effective at 7), so the range verified against
    the pre-rotation set fails and the reactor re-verifies block by
    block against the true set — punishing no one."""
    fallbacks = []

    async def run():
        reactor_cls = p_reactor.BlockSyncReactor
        real = reactor_cls._apply_sequential

        async def spy(self, run, parts_list):
            fallbacks.append(run[0][0].header.height)
            await real(self, run, parts_list)

        reactor_cls._apply_sequential = spy
        try:
            return await replay(PORT, convert.genesis(source["genesis"]), source["port_blocks"],
                                window=N_BLOCKS)
        finally:
            reactor_cls._apply_sequential = real

    reactor, state, punished, errors = asyncio.run(run())
    assert fallbacks, "no range failed on the rotation: the test is vacuous"
    assert punished == [] and errors == []
    assert state.last_block_height == N_BLOCKS - 1
    assert len(state.validators) == 5
    assert state.app_hash == source["ref_blocks"][N_BLOCKS].header.app_hash


def test_ranges_reach_the_plain_kernel_eq_below_a_lowered_cutoff(source, replays, monkeypatch):
    """With MIN_TPU_BATCH at 8, every range of 8 or more signatures goes
    through DeviceBatchVerifier — the plain `kernel_eq` on the CPU — and
    the replay still ends at the reference's state."""
    routes = []
    real_verify = p_batch.AdaptiveBatchVerifier.verify

    def recording_verify(self):
        out = real_verify(self)
        routes.append((len(self._items), self.last_route))
        return out

    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 8)
    monkeypatch.setattr(p_batch.AdaptiveBatchVerifier, "verify", recording_verify)
    _reactor, state, punished, _errors = asyncio.run(
        replay(PORT, convert.genesis(source["genesis"]), source["port_blocks"], window=8)
    )
    assert punished == []
    assert state.encode() == replays[0][1].encode()
    device_ranges = [n for n, route in routes if route == "cuda"]
    assert device_ranges and all(n >= 8 for n in device_ranges)
    assert all(route == "cpu" for n, route in routes if n < 8)


def test_launch_counts_lose_nothing_across_threads():
    """The reactor verifies its ranges in worker threads, so kernels
    launch off the main thread: 16 threads launching one kernel wrapper
    at a short switch interval must count every launch."""
    import sys
    import threading

    from tendermint_tpu_torch.crypto.cuda import _build

    kernel = _build.Kernel("stress_probe", "none", [], "none")
    try:
        kernel._fn = lambda: 0  # a launcher that succeeds
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [
                threading.Thread(target=lambda: [kernel() for _ in range(500)])
                for _ in range(16)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert kernel.launches == 16 * 500
    finally:
        del _build.KERNELS["stress_probe"]
