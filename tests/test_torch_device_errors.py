"""Device errors reach the caller through the four catch-alls the port
copied from the reference (ROADMAP Queue C, C1), on the CPU.

A failing card is stood in for by the plain versions: `crypto.batch.
MIN_TPU_BATCH` is lowered to 1, so every Edwards batch takes the device
path (`kernel_eq` through the plain B1-B3 twins on device="cpu"), and the
plain B2 (`crypto.cuda.field._pow22523_plain`) raises the ValueError a
misplaced operand raises on the card. `AdaptiveBatchVerifier` turns that
into a `crypto.batch.DeviceError`, and each site lets it through:

- the consensus receive loop (`consensus/state.py`, `_process_input`): the
  input is not dropped; the receive task ends with the error, and
  `wait_for_height` re-raises it instead of timing out;
- the prevote step (`_do_prevote`): a proposal whose LastCommit check
  raised gets no nil prevote;
- block-sync apply (`blocksync/reactor.py`, `_apply_one`): no `PeerError`
  against the provider, no redo;
- state-sync restore (`statesync/reactor.py`, `sync`): no "trying next"
  snapshot, no `SyncAbortedError`.

Each site's non-device errors keep the reference's behaviour: a failed
input is dropped and the receive task lives on, a bad proposal gets a nil
prevote, a failed apply costs the provider, a failed restore moves to the
next snapshot. Each test bounds its own wall time."""

from __future__ import annotations

import asyncio
import logging
import shutil
import time
import types

import pytest

import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.testing as p_tt
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto import verify_hub as p_vh
from tendermint_tpu_torch.crypto.batch import DeviceError
from tendermint_tpu_torch.crypto.cuda import field as p_field
from tendermint_tpu_torch.types.block import NIL_BLOCK_ID
from tendermint_tpu_torch.types.keys import SignedMsgType

MS = 1_000_000
CARD_FAULT = "field.pow22523: operand on the wrong device"


@pytest.fixture
def failing_card(monkeypatch):
    """Arm the stand-in for a failing card; returns a list that counts the
    plain B2's calls."""
    calls = []

    def fail(z):
        calls.append(tuple(z.shape))
        raise ValueError(CARD_FAULT)

    def arm():
        monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 1)
        monkeypatch.setattr(p_field, "_pow22523_plain", fail)

    arm.calls = calls
    return arm


def _device_errors() -> int:
    return p_batch.device_errors()[0]


def _observer_config():
    cfg = p_harness.fast_config()
    cfg.timeout_propose_ns = 3_600 * 10**9  # park the observer: it only tallies
    cfg.timeout_commit_ns = 0
    return cfg


def _votes(n_vals: int = 4):
    genesis, keys = p_harness.make_genesis(n_vals)
    vals = p_harness.state_from_genesis(genesis).validators
    return genesis, p_tt.make_vote_waves(genesis.chain_id, vals, keys, 1, 1)[0]


def _tallied(cs) -> int:
    return sum(v is not None for r in range(2)
               for vs in (cs.rs.votes.prevotes(r), cs.rs.votes.precommits(r)) for v in vs.votes)


def _net():
    """Three validators: every LastCommit (three signatures) takes the
    batch path. Block 1 has none, so the first device batch is the check
    of block 2's LastCommit, in its proposer's `_do_prevote` (the others
    never see the whole proposal: the proposer's machine stops first)."""
    return p_harness.LocalNetwork(3, device="cpu")


def _cleanup(net) -> None:
    for n in net.nodes:
        shutil.rmtree(n.wal_dir, ignore_errors=True)


async def _until(pred, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        await asyncio.sleep(0.02)


def _own_prevote(cs, height: int):
    if cs.rs.height != height:
        return "moved on"
    vs = cs.rs.votes.prevotes(0)
    idx = cs.rs.validators.get_by_address(cs.priv_validator.get_pub_key().address())[0]
    return vs.votes[idx] if vs is not None else None


# -- site 1: the consensus receive loop ------------------------------------------------


def test_receive_loop_ends_with_a_device_error_instead_of_dropping_the_input(
        failing_card, caplog):
    """Three validators on a failing card commit height 1. The input that
    completes the height-2 proposer's own proposal raises the DeviceError
    in the proposal's LastCommit check: the input is not dropped, the
    receive task ends with the error, and `wait_for_height` raises it at
    once."""
    failing_card()
    before = _device_errors()

    async def run():
        net = _net()
        raised_in = []

        def wrap(cs):
            real = cs._process_input

            async def process(item):
                try:
                    return await real(item)
                except DeviceError:
                    raised_in.append(type(getattr(item, "msg", item)).__name__)
                    raise

            cs._process_input = process

        try:
            await net.start()
            for n in net.nodes:
                wrap(n.cs)
            t0 = time.perf_counter()
            with pytest.raises(DeviceError, match="wrong device") as err:
                await net.wait_for_height(2, 20)
            waited = time.perf_counter() - t0
            return err.value, waited, [n.cs for n in net.nodes], raised_in
        finally:
            await net.stop()
            _cleanup(net)

    with caplog.at_level(logging.INFO):
        err, waited, states, raised_in = asyncio.run(asyncio.wait_for(run(), 60))
    assert waited < 10.0, "wait_for_height waited for a dead card"
    erred = [cs for cs in states if cs.device_error is not None]
    assert len(erred) == 1 and erred[0].device_error is err and erred[0].rs.height == 2
    assert erred[0].rs.proposal_block is not None  # its own, complete
    assert len(raised_in) == 1, raised_in  # out of _process_input, once
    assert isinstance(err.__cause__, ValueError)
    assert failing_card.calls and _device_errors() > before
    assert "consensus input failed" not in caplog.text
    assert "dropped invalid consensus input" not in caplog.text


def test_receive_loop_still_drops_a_failed_non_device_input(caplog):
    """The reference's behaviour for any other error: the input fails, is
    logged and dropped, and the next input is applied."""
    genesis, votes = _votes()

    async def run():
        node = p_harness.Node(genesis, None, config=_observer_config(), device="cpu")
        try:
            await node.start()
            cs = node.cs
            real = cs._try_add_vote
            failed = []

            def once(vote, peer_id, sig_ok=None):
                if not failed:
                    failed.append(vote)
                    raise RuntimeError("a bug in a handler, not the card")
                return real(vote, peer_id, sig_ok=sig_ok)

            cs._try_add_vote = once
            for v in votes[:2]:
                await cs.add_vote(v, "peer0")
            deadline = time.monotonic() + 10
            while _tallied(cs) < 1 and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            return cs, failed
        finally:
            await node.stop()
            shutil.rmtree(node.wal_dir, ignore_errors=True)

    with caplog.at_level(logging.ERROR):
        cs, failed = asyncio.run(asyncio.wait_for(run(), 30))
    assert failed and cs.device_error is None
    assert _tallied(cs) == 1
    assert "consensus input failed" in caplog.text


# -- site 2: the prevote step -----------------------------------------------------------


def test_a_device_error_in_the_proposals_check_is_no_nil_prevote(failing_card):
    """On a failing card, the height-2 proposal's LastCommit check raises in
    its proposer's `_do_prevote`: the proposer signs no prevote at height 2
    (the reference's breaker would re-verify on the host; a copied
    catch-all would prevote nil), and the net's `wait_for_height` raises
    rather than time out."""
    failing_card()

    async def run():
        net = _net()
        try:
            await net.start()
            with pytest.raises(DeviceError, match="wrong device"):
                await net.wait_for_height(2, 20)
            return [n.cs for n in net.nodes]
        finally:
            await net.stop()
            _cleanup(net)

    states = asyncio.run(asyncio.wait_for(run(), 60))
    erred = [cs for cs in states if cs.device_error is not None]
    assert len(erred) == 1 and erred[0].rs.height == 2
    cs = erred[0]
    proposer = cs.rs.validators.get_proposer().address
    assert proposer == cs.priv_validator.get_pub_key().address()
    assert _own_prevote(cs, 2) is None, "a failed card became a prevote"


def test_an_invalid_proposal_still_gets_a_nil_prevote(monkeypatch):
    """The reference's behaviour for a proposal that fails validation (a
    BlockValidationError, a ValueError): a nil prevote, and the machine
    runs on."""
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.validation import BlockValidationError

    def reject(self, state, block):
        raise BlockValidationError("a bad proposal, not the card")

    monkeypatch.setattr(BlockExecutor, "validate_block", reject)

    async def run():
        net = _net()
        try:
            await net.start()
            cs = net.nodes[0].cs
            await _until(lambda: _own_prevote(cs, 1) is not None, 20)
            return cs, _own_prevote(cs, 1)
        finally:
            await net.stop()
            _cleanup(net)

    cs, vote = asyncio.run(asyncio.wait_for(run(), 40))
    assert vote not in (None, "moved on") and vote.block_id == NIL_BLOCK_ID
    assert vote.type == SignedMsgType.PREVOTE
    assert cs.device_error is None


# -- site 3: block-sync apply -----------------------------------------------------------


class _Channel:
    """The reactor's channel as `_apply_one` uses it: the PeerErrors it
    files."""

    def __init__(self):
        self.errors = []
        self.out_q = asyncio.Queue()

    async def error(self, pe):
        self.errors.append(pe)


async def _reactor_at_height_1():
    """A port chain of 3 blocks (4 validators) and a fresh block-sync
    reactor that has applied block 1 (whose LastCommit is empty)."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.blocksync.reactor import BlockSyncReactor
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB
    from tendermint_tpu_torch.types.block import BlockID

    keys = p_tt.det_priv_keys(4)
    genesis = p_tt.make_genesis(keys, "c1-chain")
    src, _sstore, src_conns, _state = await p_tt.build_kvstore_chain(genesis, keys, 3,
                                                                     device="cpu")
    await src_conns.stop()
    conns = AppConns.local(KVStoreApp())
    bstore, sstore = BlockStore(MemDB()), StateStore(MemDB())
    state = await Handshaker(sstore, state_from_genesis(genesis), bstore, genesis,
                             device="cpu").handshake(conns)
    sstore.save(state)
    ex = BlockExecutor(sstore, conns.consensus, block_store=bstore, device="cpu")
    ch = _Channel()
    reactor = BlockSyncReactor(state, ex, bstore, ch, asyncio.Queue(), device="cpu")
    redone = []
    real_redo = reactor.pool.redo
    reactor.pool.redo = lambda *a: (redone.append(a), real_redo(*a))[1]

    def args(h):
        block = src.load_block(h)
        parts = block.make_part_set()
        return block, BlockID(block.hash(), parts.header), parts, src.load_block(h + 1), "peer-a"

    assert await reactor._apply_one(*args(1))
    return reactor, ch, redone, args, conns


def test_a_device_error_in_block_sync_apply_is_no_peer_error(failing_card):
    async def run():
        reactor, ch, redone, args, conns = await _reactor_at_height_1()
        try:
            failing_card()
            with pytest.raises(DeviceError, match="wrong device"):
                await reactor._apply_one(*args(2))
            return reactor, ch, redone
        finally:
            await conns.stop()

    reactor, ch, redone = asyncio.run(asyncio.wait_for(run(), 60))
    assert ch.errors == [] and redone == []
    assert reactor.state.last_block_height == 1
    assert failing_card.calls


def test_a_failed_apply_still_costs_the_provider():
    async def run():
        reactor, ch, redone, args, conns = await _reactor_at_height_1()
        try:
            async def broken(*a, **kw):
                raise RuntimeError("the app failed, not the card")

            reactor.block_exec.apply_block = broken
            return await reactor._apply_one(*args(2)), ch, redone
        finally:
            await conns.stop()

    applied, ch, redone = asyncio.run(asyncio.wait_for(run(), 60))
    assert applied is False
    assert [pe.node_id for pe in ch.errors] == ["peer-a"]
    assert redone == [(2, "peer-a")]


# -- site 4: state-sync restore ---------------------------------------------------------


@pytest.fixture(scope="module")
def statesync_source():
    return asyncio.run(p_tt.build_statesync_source(16, 4, device="cpu"))


def _restore(source, report):
    return asyncio.run(asyncio.wait_for(
        p_tt.statesync_restore_scenario(16, 4, device="cpu", source=source, report=report), 60))


def _count_restores(monkeypatch) -> list:
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    tried = []
    real = StateSyncReactor._restore

    async def counted(self, snap, *a, **kw):
        tried.append(snap.height)
        return await real(self, snap, *a, **kw)

    monkeypatch.setattr(StateSyncReactor, "_restore", counted)
    return tried


def test_a_device_error_in_a_restore_is_not_a_bad_snapshot(
        statesync_source, failing_card, monkeypatch, caplog):
    tried = _count_restores(monkeypatch)
    failing_card()
    with caplog.at_level(logging.INFO):
        with pytest.raises(DeviceError, match="wrong device"):
            _restore(statesync_source, {})
    assert len(tried) == 1, "a failed card sent the joiner to another snapshot"
    assert "trying next" not in caplog.text
    assert failing_card.calls


def test_a_failed_restore_still_tries_the_next_snapshot(statesync_source, monkeypatch, caplog):
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor, SyncAbortedError

    tried = []

    async def broken(self, snap, *a, **kw):
        tried.append(snap.height)
        raise RuntimeError("a bad snapshot, not the card")

    monkeypatch.setattr(StateSyncReactor, "_restore", broken)
    with caplog.at_level(logging.INFO):
        with pytest.raises(SyncAbortedError, match="all discovered snapshots failed"):
            _restore(statesync_source, {})
    assert len(tried) >= 2 and "trying next" in caplog.text


# -- the node's wait ---------------------------------------------------------------------


@pytest.mark.parametrize("part", ["consensus", "blocksync_reactor"])
def test_node_wait_for_height_raises_a_device_error_instead_of_timing_out(part):
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.p2p.memory import MemoryNetwork

    genesis, _ = p_harness.make_genesis(1)
    node = Node(NodeConfig(), genesis, KVStoreApp(), ed25519.Ed25519PrivKey(bytes(32)),
                [MemoryNetwork().create_transport("n")], device="cpu")
    err = DeviceError("the card failed")
    setattr(node, part, types.SimpleNamespace(device_error=err))
    t0 = time.perf_counter()
    with pytest.raises(DeviceError) as got:
        asyncio.run(node.wait_for_height(5, timeout=30))
    assert got.value is err and time.perf_counter() - t0 < 2.0
