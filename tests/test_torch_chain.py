"""The port's chain against the JAX package's, on the CPU: both packages
build the same 4-validator kvstore chain of 12 heights through their own
Handshaker, BlockExecutor, KVStoreApp and stores (the port on
device="cpu"), from the same keys and the same txs — `k=v` every third
height, as the reference's `testing.build_kvstore_chain` has them, a
validator joining at height 5 and a power change at height 8 (so proposer
rotation and `update_with_change_set` run). Compared height by height:
header, block, part-set and commit hashes and encodings, the block store's
round trips (MemDB and SQLiteDB), and the State after each `apply_block`.
The tolerance is zero (bytes and integers)."""

from __future__ import annotations

import asyncio

import pytest

from tendermint_tpu import testing as jtt
from tendermint_tpu.abci.kvstore import KVStoreApp as JKVStoreApp
from tendermint_tpu.consensus.replay import Handshaker as JHandshaker
from tendermint_tpu.mempool import Mempool as JMempool
from tendermint_tpu.proxy import AppConns as JAppConns
from tendermint_tpu.state.execution import BlockExecutor as JBlockExecutor
from tendermint_tpu.state.state import state_from_genesis as j_state_from_genesis
from tendermint_tpu.state.store import StateStore as JStateStore
from tendermint_tpu.store.blockstore import BlockStore as JBlockStore
from tendermint_tpu.store.db import MemDB as JMemDB
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc
from tendermint_tpu.types.genesis import GenesisValidator as JGenesisValidator
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.mempool import Mempool as PMempool
from tendermint_tpu_torch.store.blockstore import BlockStore as PBlockStore
from tendermint_tpu_torch.store.db import SQLiteDB
from tendermint_tpu_torch.types.block import Block, Commit, Header

CHAIN = "port-kv-chain"
N_VALS = 4
N_BLOCKS = 12
HEIGHTS = list(range(1, N_BLOCKS + 1))


def chain_txs(joiner_pub: bytes) -> dict[int, list[bytes]]:
    """Height → the txs its block carries: `k=v` every third height from
    1, a validator joining at 5 (effective at 7) and raising its power
    at 8."""
    txs = {h: [b"k%d=v%d" % (h, h)] for h in HEIGHTS if h % 3 == 1}
    txs.setdefault(5, []).append(b"val:" + joiner_pub.hex().encode() + b"!10")
    txs.setdefault(8, []).append(b"val:" + joiner_pub.hex().encode() + b"!25")
    return txs


def fixed_tx_mempool(base, txs: dict[int, list[bytes]]):
    """A mempool of either package that hands each height its fixed txs."""

    class _NullLock:
        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return False

    class FixedTxMempool(base):
        def __init__(self):
            self.next_height = 1

        def reap_max_bytes_max_gas(self, max_bytes, max_gas):
            return list(txs.get(self.next_height, ()))

        def lock(self):
            return _NullLock()

        async def update(self, height, txs_, results, *, recheck=True):
            self.next_height = height + 1

    return FixedTxMempool()


def keys_and_joiner():
    keys = jtt.det_priv_keys(N_VALS)
    joiner = jtt.det_priv_keys(1, seed=b"joiner")[0]
    return keys, joiner


def reference_genesis(keys):
    return JGenesisDoc(
        chain_id=CHAIN,
        initial_height=1,
        genesis_time_ns=1_700_000_000_000_000_000,
        validators=[JGenesisValidator(k.pub_key(), 10, f"v{i}") for i, k in enumerate(keys)],
    )


async def build_reference_chain(genesis, signers, txs, n_blocks=N_BLOCKS, on_height=None):
    """The reference's chain, built step for step as the port's
    `testing.build_kvstore_chain` builds its own."""
    by_addr = {k.pub_key().address(): k for k in signers}
    conns = JAppConns.local(JKVStoreApp())
    bstore, sstore = JBlockStore(JMemDB()), JStateStore(JMemDB())
    state = await JHandshaker(
        sstore, j_state_from_genesis(genesis), bstore, genesis
    ).handshake(conns)
    sstore.save(state)
    ex = JBlockExecutor(
        sstore, conns.consensus, mempool=fixed_tx_mempool(JMempool, txs), block_store=bstore
    )
    commit = None
    for h in range(1, n_blocks + 1):
        block, parts = ex.create_proposal_block(
            h, state, commit, state.validators.get_proposer().address
        )
        bid = block.block_id(parts.header)
        state, _ = await ex.apply_block(state, bid, block)
        commit = jtt.make_commit(
            genesis.chain_id, h, 0, bid, state.last_validators, by_addr,
            timestamp_ns=block.header.time_ns + 1,
        )
        bstore.save_block(block, parts, commit)
        if on_height is not None:
            on_height(h, block, parts, commit, state)
    return bstore, sstore, conns, state


def _record(into):
    def on_height(h, block, parts, commit, state):
        into[h] = (block, parts, commit, state)

    return on_height


@pytest.fixture(scope="module")
def chains():
    keys, joiner = keys_and_joiner()
    txs = chain_txs(joiner.pub_key().bytes())
    genesis = reference_genesis(keys)
    ref, port = {}, {}

    async def build():
        j = await build_reference_chain(genesis, keys + [joiner], txs, on_height=_record(ref))
        p = await tt.build_kvstore_chain(
            convert.genesis(genesis),
            tt.det_priv_keys(N_VALS) + tt.det_priv_keys(1, seed=b"joiner"),
            N_BLOCKS,
            mempool=fixed_tx_mempool(PMempool, txs),
            device="cpu",
            on_height=_record(port),
        )
        return j, p

    j, p = asyncio.run(build())
    return {"ref": ref, "port": port, "ref_stores": j, "port_stores": p, "genesis": genesis}


def test_genesis_and_initial_state_match(chains):
    g = chains["genesis"]
    pg = convert.genesis(g)
    assert pg.to_json() == g.to_json()
    assert pg.hash() == g.hash()
    from tendermint_tpu.state.state import state_from_genesis as jsg
    from tendermint_tpu_torch.state.state import state_from_genesis as psg

    assert psg(pg).encode() == jsg(g).encode()
    assert pg.validator_set().hash() == g.validator_set().hash()


@pytest.mark.parametrize("h", HEIGHTS)
def test_block_header_parts_and_commit_byte_identical(chains, h):
    jb, jparts, jcommit, _ = chains["ref"][h]
    pb, pparts, pcommit, _ = chains["port"][h]
    assert pb.header.encode() == jb.header.encode()
    assert pb.header.hash() == jb.header.hash()
    assert pb.encode() == jb.encode()
    assert pb.hash() == jb.hash()
    assert pb.txs_hash() == jb.txs_hash()
    assert (pparts.header.total, pparts.header.hash) == (jparts.header.total, jparts.header.hash)
    for i in range(pparts.header.total):
        assert pparts.get_part(i).encode() == jparts.get_part(i).encode()
    assert pcommit.encode() == jcommit.encode()
    assert pcommit.hash() == jcommit.hash()
    if h > 1:
        assert pb.last_commit.hash() == jb.last_commit.hash() == jb.header.last_commit_hash
    # the port decodes the reference's bytes to the same objects
    assert Block.decode(jb.encode()).encode() == jb.encode()
    assert Header.decode(jb.header.encode()).hash() == jb.header.hash()
    assert Commit.decode(jcommit.encode()).hash() == jcommit.hash()
    pcommit.validate_basic()
    pb.validate_basic()


@pytest.mark.parametrize("h", HEIGHTS)
def test_state_after_apply_block_matches(chains, h):
    js = chains["ref"][h][3]
    ps = chains["port"][h][3]
    assert ps.app_hash == js.app_hash
    assert ps.validators.hash() == js.validators.hash()
    assert ps.next_validators.hash() == js.next_validators.hash()
    assert ps.validators.get_proposer().address == js.validators.get_proposer().address
    assert [v.proposer_priority for v in ps.validators.validators] == [
        v.proposer_priority for v in js.validators.validators
    ]
    assert ps.last_results_hash == js.last_results_hash
    assert ps.encode() == js.encode()
    assert convert.state(js).encode() == js.encode()


def test_chain_rotated_its_validator_set(chains):
    final = chains["port"][N_BLOCKS][3]
    assert len(final.validators) == N_VALS + 1
    powers = sorted(v.voting_power for v in final.validators.validators)
    assert powers == [10] * N_VALS + [25]
    assert chains["port"][N_BLOCKS][0].txs == chains["ref"][N_BLOCKS][0].txs


def test_block_store_round_trips(chains, tmp_path):
    jstore = chains["ref_stores"][0]
    pstore = chains["port_stores"][0]
    sqlite = convert.block_store(jstore, SQLiteDB(str(tmp_path / "blocks.db")))
    for store in (pstore, sqlite):
        assert (store.base(), store.height()) == (jstore.base(), jstore.height())
        for h in HEIGHTS:
            assert store.load_block(h).encode() == jstore.load_block(h).encode()
            assert store.load_block_meta(h).encode() == jstore.load_block_meta(h).encode()
            assert store.load_seen_commit(h).encode() == jstore.load_seen_commit(h).encode()
            if h < N_BLOCKS:
                assert store.load_block_commit(h).encode() == jstore.load_block_commit(h).encode()
            assert store.load_block_part(h, 0).encode() == jstore.load_block_part(h, 0).encode()
            assert store.load_block_by_hash(jstore.load_block(h).hash()).header.height == h
    reopened = PBlockStore(SQLiteDB(str(tmp_path / "blocks.db")))
    assert reopened.height() == N_BLOCKS
    assert reopened.load_block(N_BLOCKS).encode() == jstore.load_block(N_BLOCKS).encode()


def test_state_store_matches(chains):
    jss = chains["ref_stores"][1]
    pss = chains["port_stores"][1]
    assert pss.load().encode() == jss.load().encode()
    for h in HEIGHTS:
        assert pss.load_validators(h).hash() == jss.load_validators(h).hash()
        assert pss.load_abci_responses(h).encode() == jss.load_abci_responses(h).encode()


def test_aggregate_commit_keeps_its_wire_bytes_and_refuses_verification(chains):
    from dataclasses import replace

    from tendermint_tpu_torch.types import validation

    _, _, pcommit, pstate = chains["port"][3]
    agg = replace(
        pcommit,
        signatures=tuple(replace(cs, signature=b"") for cs in pcommit.signatures),
        agg_sig=b"\x01" * 96,
    )
    from tendermint_tpu.types.block import Commit as JCommit

    from tendermint_tpu.types import validation as jvalidation

    assert JCommit.decode(agg.encode()).hash() == agg.hash()
    assert agg.hash() != pcommit.hash()
    # an aggregate over this ed25519 set is refused before any pairing,
    # with the reference's message
    _, _, jcommit, jstate = chains["ref"][3]
    with pytest.raises(jvalidation.InvalidCommitError) as jerr:
        jvalidation.verify_commit(
            CHAIN, jstate.last_validators, jcommit.block_id, 3, JCommit.decode(agg.encode())
        )
    with pytest.raises(validation.InvalidCommitError, match="non-BLS signer") as err:
        validation.verify_commit(
            CHAIN, pstate.last_validators, pcommit.block_id, 3, agg, device="cpu"
        )
    assert str(err.value) == str(jerr.value)
