"""Test/bench fixtures: deterministic validator sets, signed commits and
votes, light chains, kvstore chains, pairing buckets, the state-sync
restore and join-wave scenarios, and the seeded tx flood (the subset of
tendermint_tpu/testing.py the commit, block-sync, light-client,
state-sync and evidence paths need, the chain builds of bench.py's
block-sync and state-sync benches, the envelope txs of its tx-flood
bench, and the vote waves of its consensus-ingest bench). Keys derive
from the same seeds as the reference's, so both packages build the same
validators and addresses, and the same signatures wherever the scheme is
deterministic (ed25519, sr25519; secp256k1 only on the pure-Python
path)."""

from __future__ import annotations

import hashlib

from .crypto import ed25519
from .device import DEFAULT_DEVICE
from .crypto.hashes import sha256
from .types.block import NIL_BLOCK_ID, BlockID, Commit, CommitSig, PartSetHeader
from .types.canonical import vote_sign_bytes
from .types.keys import SignedMsgType
from .types.validator_set import Validator, ValidatorSet


def det_priv_keys(n: int, seed: bytes = b"tmtpu-test") -> list[ed25519.Ed25519PrivKey]:
    return [
        ed25519.Ed25519PrivKey(hashlib.sha256(seed + i.to_bytes(4, "big")).digest())
        for i in range(n)
    ]


def make_vote(
    chain_id: str,
    key,
    index: int,
    height: int,
    round_: int,
    type_: SignedMsgType,
    block_id: BlockID,
    timestamp_ns: int = 1_700_000_000_000_000_000,
):
    """One signed vote by `key` at validator `index` (the reference's
    `testing.make_vote`)."""
    from .types.vote import Vote

    sb = vote_sign_bytes(chain_id, type_, height, round_, block_id, timestamp_ns)
    return Vote(
        type=type_,
        height=height,
        round=round_,
        block_id=block_id,
        timestamp_ns=timestamp_ns,
        validator_address=key.pub_key().address(),
        validator_index=index,
        signature=key.sign(sb),
    )


#: bench.py's consensus-ingest vote kinds per round (bench.py:1419-1424)
INGEST_TYPES = (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)
INGEST_BASE_TS = 1_700_000_000_000_000_000


def ingest_cap(n_vals: int) -> int:
    """Votes per (round, type) that keep every tally of `n_vals` validators
    of equal power below 2/3 (bench.py:1418): 98 at 150."""
    return max(1, (2 * n_vals) // 3 - 2)


def make_vote_waves(
    chain_id: str,
    vals: ValidatorSet,
    keys: list,
    height: int,
    n_waves: int,
    *,
    rounds: int = 2,
    first_wave: int = 0,
) -> list[list]:
    """bench.py's consensus-ingest vote waves (bench.py:1449-1468): for
    each wave, for each round below `rounds` and each vote type, nil votes
    of the first `ingest_cap` validators by index, signed with their
    `keys` (any order) at timestamp INGEST_BASE_TS + the wave's number, so
    every wave has sign-bytes of its own. Both packages sign the same
    bytes with the same deterministic keys."""
    from .types.vote import Vote

    cap = ingest_cap(len(vals.validators))
    idx_key = sorted(
        ((vals.get_by_address(k.pub_key().address())[0], k) for k in keys),
        key=lambda ik: ik[0],
    )
    waves = []
    for w in range(first_wave, first_wave + n_waves):
        votes = []
        for round_ in range(rounds):
            for type_ in INGEST_TYPES:
                for idx, key in idx_key[:cap]:
                    v = Vote(
                        type=type_,
                        height=height,
                        round=round_,
                        block_id=NIL_BLOCK_ID,
                        timestamp_ns=INGEST_BASE_TS + w,
                        validator_address=key.pub_key().address(),
                        validator_index=idx,
                    )
                    votes.append(
                        Vote(**{**v.__dict__, "signature": key.sign(v.sign_bytes(chain_id))})
                    )
        waves.append(votes)
    return waves


def consensus_channels() -> list:
    """A consensus reactor's four Channels — state, data, vote, vote-set
    bits — with the consensus codec, as the reference's node.py opens
    them (ids, names, priorities)."""
    from .consensus import messages as m
    from .consensus.reactor import (
        DATA_CHANNEL,
        STATE_CHANNEL,
        VOTE_CHANNEL,
        VOTE_SET_BITS_CHANNEL,
    )
    from .p2p.router import Channel

    return [
        Channel(cid, name, prio, m.encode_message, m.decode_message)
        for cid, name, prio in (
            (STATE_CHANNEL, "cs-state", 6),
            (DATA_CHANNEL, "cs-data", 10),
            (VOTE_CHANNEL, "cs-vote", 7),
            (VOTE_SET_BITS_CHANNEL, "cs-bits", 1),
        )
    ]


async def pump_channel(src, dst, from_: str) -> None:
    """Carry every envelope `src` sends to `dst`'s inbound queue as if it
    came over the wire from peer `from_`: encoded with the channel's
    codec and decoded again (an in-process link between two nodes; runs
    until cancelled)."""
    from .p2p.types import Envelope

    while True:
        env = await src.out_q.get()
        msg = dst.decode(src.encode(env.message))
        await dst.in_q.put(Envelope(dst.id, msg, from_=from_))


def make_duplicate_vote_evidence(
    chain_id: str, block_store, state_store, key, height: int, round_: int = 0
):
    """DuplicateVoteEvidence of `key` signing two different blocks at
    (`height`, `round_`, precommit), stamped with the committed block's
    time and the height's validator set from the stores (the reference's
    tests/test_evidence.py equivocation)."""
    from .types.evidence import DuplicateVoteEvidence

    vals = state_store.load_validators(height)
    meta = block_store.load_block_meta(height)
    idx, _val = vals.get_by_address(key.pub_key().address())
    va, vb = (
        make_vote(chain_id, key, idx, height, round_, SignedMsgType.PRECOMMIT,
                  make_block_id(tag), timestamp_ns=meta.header.time_ns)
        for tag in (b"fork-a", b"fork-b")
    )
    return DuplicateVoteEvidence.from_votes(va, vb, meta.header.time_ns, vals)


async def make_lunatic_evidence(
    chain_id: str,
    block_store,
    state_store,
    keys_by_addr: dict,
    *,
    common_height: int,
    attack_height: int,
    n_traitors: int,
    seed: int = 0,
):
    """LightClientAttackEvidence against the stored chain: a
    `light.byzantine.LunaticProvider` over the committed light blocks
    serves its forgery at `attack_height` (signed by `n_traitors`
    colluders), and the evidence is formed as the light client forms it
    (light/client.py): common height `common_height`, the common set's
    power and block time, and the attribution against the committed
    header."""
    import dataclasses

    from .light.byzantine import LunaticConfig, LunaticProvider
    from .light.types import LightBlock, SignedHeader
    from .types.evidence import LightClientAttackEvidence

    def stored(height):
        # the committed header, its canonical commit (the seen commit at
        # the store's tip) and the height's validator set
        meta = block_store.load_block_meta(height)
        commit = block_store.load_block_commit(height) or block_store.load_seen_commit(height)
        return LightBlock(SignedHeader(meta.header, commit), state_store.load_validators(height))

    common, real = stored(common_height), stored(attack_height)
    lunatic = LunaticProvider(
        make_list_provider([common, real], chain_id),
        LunaticConfig((attack_height,), seed, n_traitors),
        real.validators,
        keys_by_addr,
    )
    forged = await lunatic.light_block(attack_height)
    ev = LightClientAttackEvidence(
        conflicting_block=forged,
        common_height=common_height,
        byzantine_validators=(),
        total_voting_power=common.validators.total_voting_power(),
        timestamp_ns=common.header.time_ns,
    )
    return dataclasses.replace(
        ev,
        byzantine_validators=tuple(
            ev.get_byzantine_validators(common.validators, real.signed_header)
        ),
    )


def make_envelope_flood(
    n_clients: int,
    txs_per_client: int,
    *,
    seed: bytes = b"tx-flood",
    tampered=(),
    reversed_clients=(),
) -> list[bytes]:
    """The seeded tx flood: `n_clients` × `txs_per_client` signed envelope
    txs (mempool/ingress.py), client i signing with `det_priv_keys(
    n_clients, seed)[i]` nonces 0.. with payload b"flood-<i>-<nonce>"
    (bench.py's tx-flood payloads), in client-major order. `tampered`
    holds (client, nonce) pairs whose signature gets its first bit
    flipped; `reversed_clients` lists clients whose txs come in reverse
    nonce order (out-of-order arrivals that park in their nonce lane).
    Deterministic: both packages' ingresses get the same bytes."""
    from .mempool.ingress import decode_envelope, encode_envelope, make_signed_tx

    tampered = set(tampered)
    reversed_clients = set(reversed_clients)
    txs: list[bytes] = []
    for ci, key in enumerate(det_priv_keys(n_clients, seed)):
        own = []
        for nonce in range(txs_per_client):
            tx = make_signed_tx(key, nonce, b"flood-%d-%d" % (ci, nonce))
            if (ci, nonce) in tampered:
                env = decode_envelope(tx)
                sig = bytes([env.signature[0] ^ 1]) + env.signature[1:]
                tx = encode_envelope(
                    type(env)(env.key_type, env.pub_key_bytes, env.nonce, env.payload, sig)
                )
            own.append(tx)
        txs.extend(reversed(own) if ci in reversed_clients else own)
    return txs


def make_validator_set(
    n: int,
    power: int = 10,
    seed: bytes = b"tmtpu-test",
    key_types: tuple[str, ...] = ("ed25519",),
) -> tuple[ValidatorSet, dict[bytes, object]]:
    """Deterministic validator set and its keys by address; `key_types`
    cycles over the validators in creation order (("ed25519",
    "secp256k1") is the BASELINE config-4 mixed set)."""
    keys: list = []
    for i in range(n):
        kt = key_types[i % len(key_types)]
        secret = hashlib.sha256(seed + kt.encode() + i.to_bytes(4, "big")).digest()
        if kt == "ed25519":
            keys.append(ed25519.Ed25519PrivKey(secret))
        elif kt == "secp256k1":
            from .crypto.secp256k1 import Secp256k1PrivKey

            keys.append(Secp256k1PrivKey(secret))
        elif kt == "sr25519":
            from .crypto.sr25519 import Sr25519PrivKey

            keys.append(Sr25519PrivKey(secret))
        elif kt == "bls12381":
            from .crypto.bls import BLSPrivKey

            keys.append(BLSPrivKey(secret))
        else:
            raise ValueError(f"unknown key type {kt}")
    vals = ValidatorSet([Validator(k.pub_key(), power) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    return vals, by_addr


def make_block_id(tag: bytes = b"blk") -> BlockID:
    return BlockID(sha256(tag), PartSetHeader(1, sha256(b"parts" + tag)))


def make_commit(
    chain_id: str,
    height: int,
    round_: int,
    block_id: BlockID,
    vals: ValidatorSet,
    keys_by_addr: dict,
    *,
    nil_indices: frozenset[int] = frozenset(),
    absent_indices: frozenset[int] = frozenset(),
    timestamp_ns: int = 1_700_000_000_000_000_000,
) -> Commit:
    """Build a fully-signed commit over `block_id` by the validator set."""
    sigs = []
    for i, val in enumerate(vals.validators):
        if i in absent_indices:
            sigs.append(CommitSig.absent())
            continue
        ts = timestamp_ns + i
        vote_bid = NIL_BLOCK_ID if i in nil_indices else block_id
        sb = vote_sign_bytes(
            chain_id, SignedMsgType.PRECOMMIT, height, round_, vote_bid, ts
        )
        sig = keys_by_addr[val.address].sign(sb)
        if i in nil_indices:
            sigs.append(CommitSig.for_nil(val.address, ts, sig))
        else:
            sigs.append(CommitSig.for_block(val.address, ts, sig))
    return Commit(height, round_, block_id, tuple(sigs))


def make_light_chain(
    n_heights: int,
    vals: ValidatorSet,
    keys_by_addr: dict,
    chain_id: str = "light-chain",
    *,
    start_time_ns: int = 1_700_000_000_000_000_000,
    block_interval_ns: int = 1_000_000_000,
):
    """A synthetic chain of properly-signed LightBlocks 1..n_heights
    over one static validator set: hash-linked headers with monotone
    times, each committed by the full set — the light-client serving /
    hop-proof workload shape (LightFleet tests and `bench.py
    light_fleet`) without spinning a live network."""
    from .crypto.hashes import sha256 as _sha
    from .light.types import LightBlock, SignedHeader
    from .types.block import Header

    out: list = []
    last_bid = BlockID()
    vh = vals.hash()
    for h in range(1, n_heights + 1):
        header = Header(
            chain_id=chain_id,
            height=h,
            time_ns=start_time_ns + h * block_interval_ns,
            last_block_id=last_bid,
            last_commit_hash=_sha(b"lc" + h.to_bytes(8, "big")),
            data_hash=_sha(b"data" + h.to_bytes(8, "big")),
            validators_hash=vh,
            next_validators_hash=vh,
            consensus_hash=_sha(b"consensus"),
            app_hash=_sha(b"app" + h.to_bytes(8, "big")),
            last_results_hash=_sha(b"results"),
            evidence_hash=b"",
            proposer_address=vals.validators[h % len(vals.validators)].address,
        )
        bid = BlockID(header.hash(), PartSetHeader(1, _sha(b"p" + h.to_bytes(8, "big"))))
        commit = make_commit(
            chain_id, h, 0, bid, vals, keys_by_addr,
            timestamp_ns=header.time_ns,
        )
        out.append(LightBlock(SignedHeader(header, commit), vals))
        last_bid = bid
    return out


def make_list_provider(blocks, chain_id: str = "light-chain"):
    """An in-memory light-block Provider over a prebuilt chain (height
    0 = tip), with a fetch counter — the serving-side fixture for the
    LightFleet tests and `bench.py light_fleet`."""
    from .light.provider import LightBlockNotFoundError, Provider

    class ListProvider(Provider):
        def __init__(self):
            self.blocks = {b.height: b for b in blocks}
            self.tip = max(self.blocks)
            self.fetches = 0

        def chain_id(self):
            return chain_id

        async def light_block(self, height):
            self.fetches += 1
            h = height or self.tip
            if h not in self.blocks:
                raise LightBlockNotFoundError(str(h))
            return self.blocks[h]

        async def report_evidence(self, ev):
            pass

    return ListProvider()



def make_pairing_bucket(real: list[int], npairs: int, device=DEFAULT_DEVICE) -> list:
    """K7a's six input arrays for a (len(real), npairs) pairing bucket
    laid out as the BLS paths lay theirs out: item i holds real[i] real
    pairs, then pad pairs. The real pairs repeat 8 prepared ones
    (([3 + k] G1, hash_to_point_g2(b"k7-%d" % k)), lane (i, j) pair
    (i + j) % 8), so a bucket of any size costs 8 hashes to G2."""
    import torch

    from .crypto import bls_math
    from .crypto.cuda import bls_pairing

    pool = [[(bls_math.g1_mul(bls_math.G1_GEN, 3 + k), bls_math.hash_to_point_g2(b"k7-%d" % k))]
            for k in range(8)]
    base = bls_pairing.prepare_pairing_batch(pool, 8, 2)[0]  # lane (k, 0) pair k, (k, 1) a pad
    item = torch.tensor([[(i + j) % 8 for j in range(npairs)] for i in range(len(real))])
    pair = torch.tensor([[int(j >= n) for j in range(npairs)] for n in real])
    return [(torch.from_numpy(a)[:, item, pair] if a.ndim == 5 else
             torch.from_numpy(a)[item, pair]).contiguous().to(device) for a in base]

def make_genesis(
    keys, chain_id: str, *, power: int = 10, genesis_time_ns: int = 1_700_000_000_000_000_000
):
    """A genesis doc with one validator of `power` per key, named v0, v1, …"""
    from .types.genesis import GenesisDoc, GenesisValidator

    return GenesisDoc(
        chain_id=chain_id,
        initial_height=1,
        genesis_time_ns=genesis_time_ns,
        validators=[GenesisValidator(k.pub_key(), power, f"v{i}") for i, k in enumerate(keys)],
    )


async def build_kvstore_chain(
    genesis,
    keys,
    n_blocks: int,
    *,
    mempool=None,
    device=DEFAULT_DEVICE,
    on_height=None,
):
    """Build an `n_blocks` kvstore chain through the real executor, as
    bench.py's block-sync bench builds its source chain: an ABCI
    handshake (InitChain), then per height a proposal from the current
    proposer with the txs `mempool` reaps (empty blocks without one),
    `apply_block` (which verifies the block's LastCommit on `device`),
    and a commit signed by every validator of the set that voted, its
    timestamps one nanosecond after the block's. `keys` are the signers'
    private keys (every key that is ever in the set). `on_height(h,
    block, parts, commit, state)` is called after each height. Returns
    (block_store, state_store, app_conns, state)."""
    from .abci.kvstore import KVStoreApp
    from .consensus.replay import Handshaker
    from .proxy import AppConns
    from .state.execution import BlockExecutor
    from .state.state import state_from_genesis
    from .state.store import StateStore
    from .store.blockstore import BlockStore
    from .store.db import MemDB

    by_addr = {k.pub_key().address(): k for k in keys}
    conns = AppConns.local(KVStoreApp())
    bstore, sstore = BlockStore(MemDB()), StateStore(MemDB())
    state = await Handshaker(
        sstore, state_from_genesis(genesis), bstore, genesis, device=device
    ).handshake(conns)
    sstore.save(state)
    ex = BlockExecutor(sstore, conns.consensus, mempool=mempool, block_store=bstore, device=device)
    commit = None
    for h in range(1, n_blocks + 1):
        block, parts = ex.create_proposal_block(
            h, state, commit, state.validators.get_proposer().address
        )
        bid = block.block_id(parts.header)
        state, _ = await ex.apply_block(state, bid, block)
        commit = make_commit(
            genesis.chain_id, h, 0, bid, state.last_validators, by_addr,
            timestamp_ns=block.header.time_ns + 1,
        )
        bstore.save_block(block, parts, commit)
        if on_height is not None:
            on_height(h, block, parts, commit, state)
    return bstore, sstore, conns, state


def fixed_tx_mempool(txs_by_height: dict[int, list[bytes]]):
    """A mempool that hands each height's proposal the txs
    `txs_by_height` lists for it (nothing else), as a priority mempool
    fed those txs just before each proposal would."""
    from .mempool import NopMempool

    class FixedTxMempool(NopMempool):
        def __init__(self):
            self.next_height = 1

        def reap_max_bytes_max_gas(self, max_bytes, max_gas):
            return list(txs_by_height.get(self.next_height, ()))

        async def update(self, height, txs, results, *, recheck=True):
            self.next_height = height + 1

    return FixedTxMempool()


async def build_statesync_source(
    n_blocks: int, n_vals: int, chain_id: str = "ss-bench", *, device=DEFAULT_DEVICE
):
    """The donor chain of the state-sync scenarios (the reference's
    `testing.build_kvstore_chain(n_blocks, n_vals)`): `n_vals` validators
    of power 10 from `det_priv_keys`, `n_blocks` kvstore blocks with the
    tx `k<h>=v<h>` at every height h = 1 mod 3, the app holding its
    periodic snapshots (every 10 heights). Returns (block_store,
    state_store, app_conns, genesis)."""
    keys = det_priv_keys(n_vals)
    genesis = make_genesis(keys, chain_id)
    txs = {h: [b"k%d=v%d" % (h, h)] for h in range(1, n_blocks + 1) if h % 3 == 1}
    bstore, sstore, conns, _state = await build_kvstore_chain(
        genesis, keys, n_blocks, mempool=fixed_tx_mempool(txs), device=device
    )
    return bstore, sstore, conns, genesis


async def statesync_restore_scenario(
    n_blocks: int,
    n_vals: int,
    *,
    backfill_blocks: int | None = None,
    device=DEFAULT_DEVICE,
    source=None,
    report: dict | None = None,
) -> int:
    """BASELINE config 5 shape: snapshot restore + verified backfill over
    the real statesync reactor protocol, two reactors bridged in-process
    (the reference's `testing.statesync_restore_scenario`). The joining
    reactor verifies on `device`. Returns the number of headers the
    restored node holds afterwards.

    `source` is a donor chain from `build_statesync_source` (built here,
    on `device`, when None). `report`, when given, receives the restored
    "state", the joiner's "client" reactor, "block_store" and
    "state_store", the "server" reactor and the sync's "wall_s"."""
    import asyncio
    import time

    from .abci.kvstore import KVStoreApp
    from .p2p.peermanager import PeerStatus, PeerUpdate
    from .p2p.router import Channel
    from .p2p.types import Envelope
    from .proxy import AppConns
    from .state.store import StateStore
    from .statesync import (
        CHUNK_CHANNEL,
        LIGHT_BLOCK_CHANNEL,
        PARAMS_CHANNEL,
        SNAPSHOT_CHANNEL,
    )
    from .statesync import messages as ssm
    from .statesync.reactor import StateSyncReactor, SyncConfig
    from .store.blockstore import BlockStore
    from .store.db import MemDB

    if source is None:
        source = await build_statesync_source(n_blocks, n_vals, device=device)
    src_bstore, src_sstore, src_conns, genesis = source

    def channels() -> dict[int, Channel]:
        return {
            cid: Channel(cid, name, 5, ssm.encode_message, ssm.decode_message)
            for cid, name in (
                (SNAPSHOT_CHANNEL, "snapshot"),
                (CHUNK_CHANNEL, "chunk"),
                (LIGHT_BLOCK_CHANNEL, "lightblock"),
                (PARAMS_CHANNEL, "params"),
            )
        }

    src_ch, dst_ch = channels(), channels()

    server_q: asyncio.Queue = asyncio.Queue()
    client_q: asyncio.Queue = asyncio.Queue()
    server = StateSyncReactor(
        genesis.chain_id, src_conns, src_sstore, src_bstore,
        src_ch[SNAPSHOT_CHANNEL], src_ch[CHUNK_CHANNEL],
        src_ch[LIGHT_BLOCK_CHANNEL], src_ch[PARAMS_CHANNEL], server_q,
        device=device,
    )
    dst_app = AppConns.local(KVStoreApp(MemDB()))
    dst_bstore = BlockStore(MemDB())
    dst_sstore = StateStore(MemDB())
    client = StateSyncReactor(
        genesis.chain_id, dst_app, dst_sstore, dst_bstore,
        dst_ch[SNAPSHOT_CHANNEL], dst_ch[CHUNK_CHANNEL],
        dst_ch[LIGHT_BLOCK_CHANNEL], dst_ch[PARAMS_CHANNEL], client_q,
        device=device,
    )

    async def pump(src: Channel, dst: Channel, from_name: str) -> None:
        while True:
            env = await src.out_q.get()
            await dst.in_q.put(Envelope(env.channel_id, env.message, from_=from_name))

    pumps = [
        asyncio.get_running_loop().create_task(pump(a, b, name))
        for cid in src_ch
        for a, b, name in (
            (dst_ch[cid], src_ch[cid], "client"),
            (src_ch[cid], dst_ch[cid], "server"),
        )
    ]
    await server.start()
    await client.start()
    await client_q.put(PeerUpdate("server", PeerStatus.UP))
    try:
        meta1 = src_bstore.load_block_meta(1)
        cfg = SyncConfig(
            trust_height=1,
            trust_hash=meta1.header.hash(),
            trust_period_ns=10 * 365 * 24 * 3600 * 10**9,
            backfill_blocks=backfill_blocks,
        )
        t0 = time.perf_counter()
        state = await asyncio.wait_for(client.sync(cfg), timeout=300)
        wall = time.perf_counter() - t0
        assert state.last_block_height >= n_blocks - 12, state.last_block_height
        held = 0
        h = state.last_block_height
        while h >= 1 and dst_bstore.load_block_meta(h) is not None:
            held += 1
            h -= 1
        if report is not None:
            report.update(state=state, client=client, server=server, block_store=dst_bstore,
                          state_store=dst_sstore, wall_s=wall)
        return held
    finally:
        for t in pumps:
            t.cancel()
        await asyncio.gather(*pumps, return_exceptions=True)
        await client.stop()
        await server.stop()
        await dst_app.stop()
        await src_conns.stop()


async def statesync_fleet_scenario(
    n_blocks: int,
    n_vals: int,
    n_joiners: int = 4,
    *,
    backfill_blocks: int | None = None,
    bootd_config=None,
    sync_timeout_s: float = 300.0,
    device=DEFAULT_DEVICE,
    source=None,
    report: dict | None = None,
) -> dict:
    """BootFleet in-process shape (the reference's
    `testing.statesync_fleet_scenario`): ONE donor reactor (its BootD
    serving every joiner from the shared chunk cache) vs `n_joiners`
    concurrent cold joiners, bridged by routing pumps — the `bench.py
    statesync` join-wave workload, without a live router mesh. Every
    reactor is built on `device`, so each joiner's backfill windows verify
    there. Returns per-joiner sync times, the donor's BootD stats (cache
    amortization, sheds, store reads), and per-joiner join outcomes (a
    shed/failed joiner is an outcome, not a raise).

    `source` is a donor chain from `build_statesync_source` (built here,
    on `device`, when None). `report`, when given, receives each joined
    joiner's restored State ("states", by joiner name)."""
    import asyncio

    from .abci.kvstore import KVStoreApp
    from .p2p.peermanager import PeerStatus, PeerUpdate
    from .p2p.router import Channel
    from .p2p.types import Envelope
    from .proxy import AppConns
    from .state.store import StateStore
    from .statesync import (
        CHUNK_CHANNEL,
        LIGHT_BLOCK_CHANNEL,
        PARAMS_CHANNEL,
        SNAPSHOT_CHANNEL,
    )
    from .statesync import messages as ssm
    from .statesync.reactor import StateSyncReactor, SyncConfig
    from .store.blockstore import BlockStore
    from .store.db import MemDB

    if source is None:
        source = await build_statesync_source(n_blocks, n_vals, device=device)
    src_bstore, src_sstore, src_conns, genesis = source

    def channels() -> dict[int, Channel]:
        return {
            cid: Channel(cid, name, 5, ssm.encode_message, ssm.decode_message)
            for cid, name in (
                (SNAPSHOT_CHANNEL, "snapshot"),
                (CHUNK_CHANNEL, "chunk"),
                (LIGHT_BLOCK_CHANNEL, "lightblock"),
                (PARAMS_CHANNEL, "params"),
            )
        }

    src_ch = channels()
    server = StateSyncReactor(
        genesis.chain_id, src_conns, src_sstore, src_bstore,
        src_ch[SNAPSHOT_CHANNEL], src_ch[CHUNK_CHANNEL],
        src_ch[LIGHT_BLOCK_CHANNEL], src_ch[PARAMS_CHANNEL],
        asyncio.Queue(),
        bootd_config=bootd_config,
        device=device,
    )
    joiner_ch: dict[str, dict[int, Channel]] = {
        f"joiner-{i}": channels() for i in range(n_joiners)
    }
    clients: dict[str, StateSyncReactor] = {}
    apps: list[AppConns] = []
    stores: dict[str, BlockStore] = {}
    for name, chs in joiner_ch.items():
        app = AppConns.local(KVStoreApp(MemDB()))
        apps.append(app)
        bstore = BlockStore(MemDB())
        stores[name] = bstore
        q: asyncio.Queue = asyncio.Queue()
        clients[name] = StateSyncReactor(
            genesis.chain_id, app, StateStore(MemDB()), bstore,
            chs[SNAPSHOT_CHANNEL], chs[CHUNK_CHANNEL],
            chs[LIGHT_BLOCK_CHANNEL], chs[PARAMS_CHANNEL], q,
            device=device,
        )
        await q.put(PeerUpdate("server", PeerStatus.UP))

    async def pump_to_server(cid: int, name: str) -> None:
        src = joiner_ch[name][cid]
        while True:
            env = await src.out_q.get()
            await src_ch[cid].in_q.put(
                Envelope(env.channel_id, env.message, from_=name)
            )

    async def route_from_server(cid: int) -> None:
        # the server addresses every reply (`to=env.from_`); route it to
        # that joiner's channel — a broadcast (never sent today) fans out
        while True:
            env = await src_ch[cid].out_q.get()
            targets = [env.to] if env.to else list(joiner_ch)
            for t in targets:
                if t in joiner_ch:
                    await joiner_ch[t][cid].in_q.put(
                        Envelope(env.channel_id, env.message, from_="server")
                    )

    pumps = [
        asyncio.get_running_loop().create_task(pump_to_server(cid, name))
        for cid in src_ch
        for name in joiner_ch
    ] + [
        asyncio.get_running_loop().create_task(route_from_server(cid))
        for cid in src_ch
    ]
    await server.start()
    for c in clients.values():
        await c.start()
    loop = asyncio.get_running_loop()
    meta1 = src_bstore.load_block_meta(1)
    cfg = SyncConfig(
        trust_height=1,
        trust_hash=meta1.header.hash(),
        trust_period_ns=10 * 365 * 24 * 3600 * 10**9,
        backfill_blocks=backfill_blocks,
    )
    out: dict = {
        "n_joiners": n_joiners,
        "joined": 0,
        "join_errors": [],
        "time_to_synced_s": [],
        "headers_held": [],
        "elapsed_s": 0.0,
        "server_stats": {},
    }
    states: dict = {}

    async def join_one(name: str) -> None:
        t0 = loop.time()
        try:
            state = await asyncio.wait_for(
                clients[name].sync(cfg), sync_timeout_s
            )
        except Exception as e:  # noqa: BLE001 — structured outcome
            out["join_errors"].append(f"{name}: {e!r}")
            return
        out["joined"] += 1
        out["time_to_synced_s"].append(round(loop.time() - t0, 4))
        states[name] = state
        held, h = 0, state.last_block_height
        while h >= 1 and stores[name].load_block_meta(h) is not None:
            held += 1
            h -= 1
        out["headers_held"].append(held)

    try:
        t0 = loop.time()
        await asyncio.gather(*(join_one(n) for n in clients))
        out["elapsed_s"] = round(loop.time() - t0, 4)
        out["server_stats"] = dict(server.bootd.stats)
        # backfill verification happens on the JOINERS' side (their
        # BootD counters), not the donor's
        out["joiner_backfill"] = {
            key: sum(c.bootd.stats[key] for c in clients.values())
            for key in (
                "backfill_heights", "backfill_sigs",
                "backfill_agg_heights", "backfill_batches",
            )
        }
        if report is not None:
            report["states"] = states
        return out
    finally:
        for t in pumps:
            t.cancel()
        await asyncio.gather(*pumps, return_exceptions=True)
        for c in clients.values():
            await c.stop()
        await server.stop()
        for app in apps:
            await app.stop()
        await src_conns.stop()
