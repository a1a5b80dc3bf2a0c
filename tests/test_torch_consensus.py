"""The port's consensus state machine, harness and reactor
(consensus/{state,harness,reactor}.py) on the CPU, against the JAX
package's.

- The frozen-clock recipe (3 equal-power validators, a `ManualClock` 500 ms
  behind genesis, 60 s propose/prevote/precommit timeouts: round 0 always
  completes and every block is a pure function of its height) runs in both
  packages: blocks 1-3 and the seen commit at 3 are byte-equal, and so are
  the BLS aggregate net's blocks 1-2 and its aggregate seen commit.
- The reference's `TestConsensus` cases run on the port: 1 validator, 4
  validators, one node down, and no empty blocks.
- A port node resumes from a WAL and stores the reference's node wrote
  (carried by `convert`; a torn tail in the WAL is repaired and reported
  as the reference reports it) and commits the next height.
- Two `ConsensusReactor`s over cross-wired in-process `Channel`s reach
  height 2, and a peer that sends a vote with a bad signature is punished.

Every port node runs on device="cpu" with no hub unless a test acquires
one. The tolerance is zero (bytes)."""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import shutil
import types

import pytest

import tendermint_tpu.consensus.harness as j_harness
import tendermint_tpu.consensus.replay as j_replay
import tendermint_tpu.consensus.wal as j_wal
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.consensus.replay as p_replay
import tendermint_tpu_torch.consensus.wal as p_wal
import tendermint_tpu_torch.libs.clock as p_clock
import tendermint_tpu_torch.testing as p_tt
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.consensus import messages as m
from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL, ConsensusReactor
from tendermint_tpu_torch.p2p.peermanager import PeerStatus, PeerUpdate
from tendermint_tpu_torch.p2p.types import Envelope
from tendermint_tpu_torch.types.block import Block

MS = 1_000_000

REF = types.SimpleNamespace(harness=j_harness, clock=j_clock, wal=j_wal, kw={})
PORT = types.SimpleNamespace(harness=p_harness, clock=p_clock, wal=p_wal, kw={"device": "cpu"})


def _cleanup(nodes) -> None:
    for n in nodes:
        shutil.rmtree(n.wal_dir, ignore_errors=True)


async def frozen_chain(pkg, n_vals: int, height: int, *, key_type: str = "ed25519",
                       scheme: str = "per-sig", timeout: float = 60.0):
    """The frozen-clock recipe (tests/test_bls.py:655-730) in `pkg`: every
    node's blocks 1..height and node 0's seen commit at `height`, encoded."""
    cfg = pkg.harness.fast_config()
    cfg.commit_scheme = scheme
    for f in ("timeout_propose_ns", "timeout_prevote_ns", "timeout_precommit_ns"):
        setattr(cfg, f, 60_000 * MS)
    clock = pkg.clock.ManualClock(pkg.harness.GENESIS_TIME_NS - 500 * MS)
    net = pkg.harness.LocalNetwork(n_vals, config=cfg, base_clock=clock, key_type=key_type,
                                   **pkg.kw)
    await net.start()
    try:
        await net.wait_for_height(height, timeout)
        blocks = [[n.block_store.load_block(h).encode() for h in range(1, height + 1)]
                  for n in net.nodes]
        seen = net.nodes[0].block_store.load_seen_commit(height)
        return blocks, seen.encode(), seen.is_aggregate()
    finally:
        await net.stop()
        _cleanup(net.nodes)


def test_frozen_clock_chain_is_byte_equal_to_the_reference():
    ref_blocks, ref_seen, _ = asyncio.run(frozen_chain(REF, 3, 3))
    port_blocks, port_seen, _ = asyncio.run(frozen_chain(PORT, 3, 3))
    assert all(b == port_blocks[0] for b in port_blocks)  # every node, the same chain
    assert port_blocks[0] == ref_blocks[0]
    assert port_seen == ref_seen


def test_bls_aggregate_net_is_byte_equal_to_the_reference():
    """3 bls12381 validators to height 2 with commit_scheme bls-aggregate:
    the seen commit and block 2's LastCommit are aggregates, byte-equal to
    the reference's. The port verifies each aggregate LastCommit with the
    plain K7a/K7b (~2 s a pairing on the CPU; the hub's verdict cache
    answers the repeats)."""
    from tendermint_tpu_torch.crypto import verify_hub as vh

    ref_blocks, ref_seen, ref_agg = asyncio.run(
        frozen_chain(REF, 3, 2, key_type="bls12381", scheme="bls-aggregate", timeout=240))
    vh.acquire_hub(device="cpu")
    try:
        port_blocks, port_seen, port_agg = asyncio.run(
            frozen_chain(PORT, 3, 2, key_type="bls12381", scheme="bls-aggregate", timeout=240))
    finally:
        vh.release_hub()
    assert ref_agg and port_agg
    assert Block.decode(port_blocks[0][1]).last_commit.is_aggregate()
    assert all(b == port_blocks[0] for b in port_blocks)
    assert port_blocks[0] == ref_blocks[0]
    assert port_seen == ref_seen


# -- the reference's TestConsensus cases on the port ------------------------------


@pytest.mark.asyncio
async def test_single_validator_produces_blocks():
    net = p_harness.LocalNetwork(1, device="cpu")
    await net.start()
    try:
        await net.wait_for_height(3, timeout=20)
        node = net.nodes[0]
        assert node.block_store.height() >= 3
        assert node.block_store.load_block(2).last_commit.height == 1
    finally:
        await net.stop()
        _cleanup(net.nodes)


@pytest.mark.asyncio
async def test_four_validators_reach_consensus():
    net = p_harness.LocalNetwork(4, device="cpu")
    await net.start()
    try:
        await net.wait_for_height(3, timeout=30)
        assert len({n.block_store.load_block(2).hash() for n in net.nodes}) == 1
        commit = net.nodes[0].block_store.load_seen_commit(2)
        assert sum(1 for s in commit.signatures if s.is_commit()) >= 3
    finally:
        await net.stop()
        _cleanup(net.nodes)


@pytest.mark.asyncio
async def test_one_node_down_still_commits():
    """3 of 4 validators (>2/3 power) keep committing."""
    net = p_harness.LocalNetwork(4, device="cpu")
    down = net.nodes.pop(3)  # its consensus never starts
    await net.start()
    try:
        await net.wait_for_height(2, timeout=30)
        commit = net.nodes[0].block_store.load_seen_commit(1)
        assert sum(1 for s in commit.signatures if s.is_commit()) == 3
    finally:
        await net.stop()
        _cleanup([*net.nodes, down])


@pytest.mark.asyncio
async def test_no_empty_blocks_stalls_then_advances_on_a_tx():
    cfg = dataclasses.replace(p_harness.fast_config(), create_empty_blocks=False)
    net = p_harness.LocalNetwork(2, config=cfg, device="cpu")
    await net.start()
    try:
        # heights 1 and 2 are proof blocks; then the chain idles
        await net.wait_for_height(2, timeout=20)
        await asyncio.sleep(1.0)
        assert all(n.cs.rs.height == 3 for n in net.nodes)
        for n in net.nodes:
            await n.mempool.check_tx(b"k=v")
        await net.wait_for_height(4, timeout=20)
        assert b"k=v" in net.nodes[0].block_store.load_block(3).txs
        await asyncio.sleep(1.0)
        assert all(n.cs.rs.height == 5 for n in net.nodes)
    finally:
        await net.stop()
        _cleanup(net.nodes)


def test_local_network_chaos_waits_for_its_port():
    """`LocalNetwork(chaos=)` threads the fault plan under its hook wiring
    as the reference does (the port refused it until libs/chaos.py was
    ported): byte-stream classes are rejected with the reference's
    ValueError, each validator gets the reference's skewed clock, and the
    reference's live-chaos run (tests/test_chaos_live.py: skewed frozen
    clocks, a one-way partition) commits heights 1-3 on every node with
    the reference's header times."""
    import tendermint_tpu.libs.chaos as j_chaos
    import tendermint_tpu_torch.libs.chaos as p_chaos

    for bad in (dict(corrupt_rate=0.1), dict(bandwidth_rate=1024.0)):
        with pytest.raises(ValueError, match="byte-stream"):
            p_harness.LocalNetwork(3, chaos=p_chaos.ChaosNetwork(p_chaos.ChaosConfig(**bad)),
                                   device="cpu")
    with pytest.raises(ValueError, match="byte-stream"):
        p_harness.LocalNetwork(3, device="cpu", chaos=p_chaos.ChaosNetwork(p_chaos.ChaosConfig(
            per_channel={0x22: p_chaos.ChaosConfig(corrupt_rate=0.5)})))
    skew = dict(seed=5, clock_skew_ms=80.0, clock_drift=0.02)
    pnet = p_harness.LocalNetwork(3, device="cpu",
                                  chaos=p_chaos.ChaosNetwork(p_chaos.ChaosConfig(**skew)))
    jnet = j_harness.LocalNetwork(3, chaos=j_chaos.ChaosNetwork(j_chaos.ChaosConfig(**skew)))
    assert [(n.clock.offset_ns, n.clock.rate) for n in pnet.nodes] == [
        (n.clock.offset_ns, n.clock.rate) for n in jnet.nodes]
    _cleanup(pnet.nodes + jnet.nodes)

    async def run(pkg, chaos_mod):
        """tests/test_chaos_live.py's run: 4 validators on frozen clocks
        skewed per validator, node0 -> node1 cut for the whole run."""
        chaos = chaos_mod.ChaosNetwork(chaos_mod.ChaosConfig(seed=9, clock_skew_ms=80.0))
        chaos.partition_oneway("node0", "node1")
        net = pkg.harness.LocalNetwork(
            4, config=pkg.harness.fast_config(), chaos=chaos,
            base_clock=pkg.clock.ManualClock(pkg.harness.GENESIS_TIME_NS - 500 * MS), **pkg.kw)
        await net.start()
        try:
            await net.wait_for_height(3, 30)
            hashes = [[n.block_store.load_block(h).hash() for h in range(1, 4)]
                      for n in net.nodes]
            times = [net.nodes[0].block_store.load_block(h).header.time_ns for h in range(1, 4)]
            return dict(chaos.faults), hashes, times
        finally:
            await net.stop()
            _cleanup(net.nodes)

    ref_faults, _ref_hashes, ref_times = asyncio.run(asyncio.wait_for(run(REF, j_chaos), 45))
    faults, hashes, times = asyncio.run(asyncio.wait_for(run(PORT, p_chaos), 45))
    assert all(h == hashes[0] for h in hashes)  # every node, one chain
    assert times == ref_times  # every header time a pure function of its height
    assert faults["asym_drop"] > 0 and faults["clock_skew"] == 4 == ref_faults["clock_skew"]


# -- crash and resume from the reference's WAL -------------------------------------


def test_port_node_resumes_from_the_references_wal_and_stores(tmp_path, caplog):
    genesis, keys = j_harness.make_genesis(1)
    ref_dir = str(tmp_path / "ref-wal")

    async def ref_run():
        node = j_harness.Node(genesis, keys[0], wal_dir=ref_dir)
        await node.start()
        await node.cs.wait_for_height(2, timeout=20)
        await node.stop()
        return node

    ref = asyncio.run(ref_run())
    height = ref.block_store.height()
    port_dir = convert.wal_dir(ref_dir, str(tmp_path / "port-wal"))
    # the crash tore the WAL's last record in both copies
    for d in (ref_dir, port_dir):
        with open(f"{d}/wal", "ab") as f:
            f.write(b"\x01\x02\x03\x04\x05")
    reports = []
    for pkg_wal, replay, d in ((j_wal, j_replay, ref_dir), (p_wal, p_replay, port_dir)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="replay"):
            wal = pkg_wal.WAL(d)
            replay.report_wal_repair(wal)
            wal.close()
        reports.append([r.getMessage().replace(d, "<wal>") for r in caplog.records
                        if r.name == "replay"])
    assert reports[0] == reports[1] and len(reports[1]) == 1
    assert "crash recovery: WAL truncated at <wal>/wal:" in reports[1][0]

    async def port_run():
        node = p_harness.Node(
            convert.genesis(genesis), p_tt.det_priv_keys(1)[0], wal_dir=port_dir,
            block_store=convert.block_store(ref.block_store),
            state_store=convert.state_store(ref.state_store), device="cpu",
        )
        await node.start()
        try:
            await node.cs.wait_for_height(height + 1, timeout=20)
            return node.block_store.height(), node.block_store.load_block(height + 1)
        finally:
            await node.stop()

    new_height, block = asyncio.run(port_run())
    assert new_height > height
    assert block.last_commit.height == height
    assert block.header.last_block_id.hash == ref.block_store.load_block(height).hash()


def test_replay_drops_a_wal_vote_whose_signature_a_corrupted_frame_broke(tmp_path, caplog):
    """A difference by design (ROADMAP Queue C, C2): the WAL logs a peer's
    vote before its signature is checked, so a frame corrupted on the wire
    leaves a vote with a broken signature in the WAL. The JAX package's
    replay raises on it and the node cannot restart (a 50-validator
    full_taxonomy run's crashed node stayed down this way); the port's
    replay drops it, as the live loop did and as the reference's Go replay
    does, and the node commits the next height."""
    import tendermint_tpu.consensus.messages as j_m
    import tendermint_tpu.types.block as j_block
    import tendermint_tpu.types.vote as j_vote
    import tendermint_tpu_torch.types.block as p_block
    import tendermint_tpu_torch.types.vote as p_vote

    async def run(pkg, msgs, block, vote, d):
        genesis, keys = pkg.harness.make_genesis(1)
        old = pkg.harness.Node(genesis, keys[0], wal_dir=d, **pkg.kw)
        await old.start()
        await old.cs.wait_for_height(2, timeout=20)
        await old.stop()
        # the crash: the WAL's last record is a vote whose signature broke
        h = old.block_store.height() + 1
        addr = keys[0].pub_key().address()
        bad = vote.Vote(type=1, height=h, round=0, timestamp_ns=0,
                        block_id=block.BlockID(b"\x01" * 32, block.PartSetHeader(1, b"\x02" * 32)),
                        validator_address=addr, validator_index=0, signature=bytes(64))
        wal = pkg.wal.WAL(d)
        wal.write_sync(msgs.encode_wal_message(msgs.VoteMessage(bad), "peer-x"))
        wal.close()
        node = pkg.harness.Node(genesis, keys[0], wal_dir=d, app=old.app,
                                block_store=old.block_store, state_store=old.state_store,
                                **pkg.kw)
        try:
            await node.start()
            await node.cs.wait_for_height(h, timeout=20)
            return node.block_store.height(), h
        finally:
            await node.stop()

    with pytest.raises(ValueError, match="signature"):
        asyncio.run(asyncio.wait_for(run(REF, j_m, j_block, j_vote, str(tmp_path / "ref")), 60))
    with caplog.at_level(logging.INFO):
        height, h = asyncio.run(asyncio.wait_for(
            run(PORT, m, p_block, p_vote, str(tmp_path / "port")), 60))
    assert height >= h
    assert "replay: dropped invalid WAL input" in caplog.text


# -- the reactor --------------------------------------------------------------


@pytest.mark.asyncio
async def test_two_reactors_over_in_process_channels_reach_height_two(tmp_path):
    from tendermint_tpu_torch.crypto import verify_hub as vh

    genesis, keys = p_harness.make_genesis(2)
    nodes = [p_harness.Node(genesis, k, wal_dir=str(tmp_path / f"wal{i}"), device="cpu")
             for i, k in enumerate(keys)]
    names = ("node0", "node1")
    chans = [p_tt.consensus_channels() for _ in nodes]
    ups = [asyncio.Queue() for _ in nodes]
    vh.acquire_hub(device="cpu")
    for n in nodes:
        await n.start(start_consensus=False)
    reactors = [ConsensusReactor(n.cs, *c, u) for n, c, u in zip(nodes, chans, ups)]
    pumps = []
    try:
        for r in reactors:
            await r.start()
        for i in (0, 1):
            for k in range(4):
                pumps.append(asyncio.ensure_future(
                    p_tt.pump_channel(chans[i][k], chans[1 - i][k], names[i])))
        await ups[0].put(PeerUpdate(names[1], PeerStatus.UP))
        await ups[1].put(PeerUpdate(names[0], PeerStatus.UP))
        for n in nodes:
            await n.cs.start()
        await asyncio.gather(*(n.cs.wait_for_height(2, 30) for n in nodes))
        assert nodes[0].block_store.load_block(2).hash() == \
            nodes[1].block_store.load_block(2).hash()
        # node 1 stops, so node 0 stays at its height; a third peer sends
        # it validator 1's prevote with a flipped signature bit: stage 1
        # disproves it in the hub and the reactor reports that peer
        await nodes[1].cs.stop()
        cs = nodes[0].cs
        idx = cs.rs.validators.get_by_address(keys[1].pub_key().address())[0]
        vote = p_tt.make_vote(genesis.chain_id, keys[1], idx, cs.rs.height, 0,
                              p_tt.SignedMsgType.PREVOTE, p_tt.make_block_id(b"bad"))
        bad = dataclasses.replace(vote, signature=bytes([vote.signature[0] ^ 1])
                                  + vote.signature[1:])
        await chans[0][2].in_q.put(Envelope(VOTE_CHANNEL, m.VoteMessage(bad), from_="p3"))
        err = await asyncio.wait_for(chans[0][2].err_q.get(), 10)
        assert err.node_id == "p3" and "invalid vote signature" in err.err
        assert cs.ingest.stats["sig_invalid"] == 1
    finally:
        for p in pumps:
            p.cancel()
        await asyncio.gather(*pumps, return_exceptions=True)
        for r in reactors:
            await r.stop()
        for n in nodes:
            await n.stop()
        vh.release_hub()
