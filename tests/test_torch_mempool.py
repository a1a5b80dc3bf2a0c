"""The port's priority mempool and mempool reactor
(tendermint_tpu_torch/mempool/{pool,reactor}.py) against the JAX
package's, on the CPU.

Both packages run the same script on the same app (priority from a tx's
leading digits; rejects b"bad"; on RECHECK rejects b"stale" and re-prices
b"reprice" to 100) with the same txs: every admission's outcome (error
type and text), reap order under byte and gas budgets, eviction of the
lowest priority from a full pool, recheck after a commit, the tx cache
and the committed-tx LRU, the TTL config (which neither pool reads: both
keep their txs across heights), stats and `aggregate_pools`. The reactor:
its wire bytes, what it gossips to a peer (fan-out cap, no echo to the
source), and what it does with inbound txs. The tolerance is zero."""

from __future__ import annotations

import asyncio
import types

import pytest

import tendermint_tpu.abci.application as j_app
import tendermint_tpu.abci.client as j_client
import tendermint_tpu.abci.types as j_abci
import tendermint_tpu.config as j_config
import tendermint_tpu.mempool as j_mempool
import tendermint_tpu.mempool.pool as j_pool
import tendermint_tpu.mempool.reactor as j_reactor
import tendermint_tpu.p2p.peermanager as j_pm
import tendermint_tpu.p2p.router as j_router
import tendermint_tpu.p2p.types as j_p2p
import tendermint_tpu_torch.abci.application as p_app
import tendermint_tpu_torch.abci.client as p_client
import tendermint_tpu_torch.abci.types as p_abci
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.mempool as p_mempool
import tendermint_tpu_torch.mempool.pool as p_pool
import tendermint_tpu_torch.mempool.reactor as p_reactor
import tendermint_tpu_torch.p2p.peermanager as p_pm
import tendermint_tpu_torch.p2p.router as p_router
import tendermint_tpu_torch.p2p.types as p_p2p

REF = types.SimpleNamespace(
    app=j_app, client=j_client, abci=j_abci, config=j_config, mempool=j_mempool,
    pool=j_pool, reactor=j_reactor, pm=j_pm, router=j_router, p2p=j_p2p,
)
PORT = types.SimpleNamespace(
    app=p_app, client=p_client, abci=p_abci, config=p_config, mempool=p_mempool,
    pool=p_pool, reactor=p_reactor, pm=p_pm, router=p_router, p2p=p_p2p,
)


def make_pool(pkg, **cfg):
    abci = pkg.abci

    class PrioApp(pkg.app.BaseApplication):
        def check_tx(self, req):
            if b"bad" in req.tx:
                return abci.ResponseCheckTx(code=1, log="bad tx")
            if req.type == abci.CheckTxType.RECHECK and b"stale" in req.tx:
                return abci.ResponseCheckTx(code=2, log="stale")
            if req.type == abci.CheckTxType.RECHECK and b"reprice" in req.tx:
                return abci.ResponseCheckTx(priority=100, gas_wanted=1)
            try:
                prio = int(req.tx.split(b":")[0])
            except ValueError:
                prio = 0
            return abci.ResponseCheckTx(priority=prio, gas_wanted=len(req.tx) % 3 + 1)

    return pkg.pool.PriorityMempool(pkg.config.MempoolConfig(**cfg), pkg.client.LocalClient(PrioApp()))


async def _admit(pool, tx, sender=""):
    try:
        await pool.check_tx(tx, sender=sender)
        return "ok"
    except ValueError as e:
        return (type(e).__name__, str(e))


def _ok_results(pkg, n, bad=()):
    return [
        pkg.abci.ResponseDeliverTx(code=1 if i in bad else 0) for i in range(n)
    ]


async def pool_script(pkg) -> list:
    """The scripted pool run; returns everything observable in order."""
    out = []
    pool = make_pool(pkg, size=4, cache_size=16, max_tx_bytes=64, ttl_num_blocks=1,
                     recheck_batch=2)
    for tx, sender in [
        (b"1:a", "p1"), (b"9:b", ""), (b"5:stale", "p2"), (b"3:reprice", ""),
        (b"bad:x", ""), (b"9:b", "p3"), (b"7:" + b"z" * 70, ""),
        (b"2:c", ""),  # full pool: outranks the 1:a resident, evicts it
        (b"0:d", ""),  # full pool, outranks nothing: rejected
        (b"1:a", ""),  # evicted earlier, so out of the cache: tried again
    ]:
        out.append((tx, await _admit(pool, tx, sender)))
    out.append(("reap", pool.reap_max_txs(-1), pool.reap_max_txs(2)))
    out.append(("reap_budget", pool.reap_max_bytes_max_gas(12, -1),
                pool.reap_max_bytes_max_gas(-1, 3), pool.reap_max_bytes_max_gas(-1, -1)))
    out.append(("size", pool.size(), pool.size_bytes(), dict(pool.stats)))
    out.append(("peers", sorted((w.tx, sorted(w.peers)) for w in pool.all_entries())))
    async with pool.lock():
        await pool.update(1, [b"9:b", b"never-seen"], _ok_results(pkg, 2, bad={1}))
    out.append(("after_update", pool.reap_max_txs(-1),
                [(w.tx, w.priority) for w in pool.all_entries()], dict(pool.stats)))
    out.append(("committed", pool.is_committed(b"9:b"), pool.is_committed(b"never-seen"),
                pool.cache.has(b"never-seen")))
    for tx in (b"9:b", b"never-seen", b"5:stale"):
        out.append((tx, await _admit(pool, tx)))
    # a second height: nothing expires (the TTL config is not read)
    async with pool.lock():
        await pool.update(2, [], [], recheck=False)
    out.append(("ttl", pool.reap_max_txs(-1), pool.height))
    out.append(("aggregate", pkg.pool.aggregate_pools()[1:]))
    await pool.flush()
    out.append(("flushed", pool.size(), pool.size_bytes(), pool.cache.has(b"3:reprice")))
    pool.close()
    return out


@pytest.mark.asyncio
async def test_pool_script_matches_reference():
    ref, port = await pool_script(REF), await pool_script(PORT)
    assert port == ref
    # what the script must have exercised
    flat = repr(port)
    assert "MempoolFullError" in flat and "TxInCacheError" in flat and "TxRejectedError" in flat
    assert port[0][1] == "ok" and ("after_update" in flat)


def test_tx_cache_lru_matches_reference():
    got = []
    for pkg in (REF, PORT):
        c = pkg.pool.TxCache(2)
        seq = [c.push(b"a"), c.push(b"b"), c.push(b"a"), c.push(b"c")]
        seq += [c.has(b"a"), c.has(b"b"), c.has(b"c")]
        c.remove(b"a")
        seq.append(c.has(b"a"))
        got.append(seq)
    assert got[0] == got[1] == [True, True, False, True, True, False, True, False]


@pytest.mark.parametrize("recheck", [True, False])
@pytest.mark.asyncio
async def test_recheck_and_eviction_order_match_reference(recheck):
    async def run(pkg):
        pool = make_pool(pkg, size=6, recheck=recheck, recheck_batch=3)
        txs = [b"%d:%s" % (p, t) for p, t in
               [(4, b"stale1"), (6, b"keep"), (2, b"reprice"), (6, b"keep2"), (1, b"stale2"), (3, b"x")]]
        for tx in txs:
            await pool.check_tx(tx)
        async with pool.lock():
            await pool.update(1, [txs[1]], _ok_results(pkg, 1))
        for tx in (b"8:new", b"0:low"):
            await _admit(pool, tx)
        return pool.reap_max_txs(-1), dict(pool.stats), pool.size_bytes()

    ref, port = await run(REF), await run(PORT)
    assert port == ref


# -- reactor ---------------------------------------------------------------------


def test_wire_codec_matches_reference():
    txs = [b"", b"1:a", b"x" * 300, bytes(range(256))]
    assert p_reactor.encode_txs(txs) == j_reactor.encode_txs(txs)
    # an empty tx is an omitted proto3 field on both sides
    assert p_reactor.decode_txs(j_reactor.encode_txs(txs)) == j_reactor.decode_txs(
        p_reactor.encode_txs(txs)) == txs[1:]
    big = j_reactor.encode_txs([b"t"] * (j_reactor.MAX_WIRE_TXS + 1))
    for mod in (p_reactor, j_reactor):
        with pytest.raises(ValueError, match="exceeds"):
            mod.decode_txs(big)
    assert p_reactor.MAX_WIRE_TXS == j_reactor.MAX_WIRE_TXS
    assert p_mempool.MEMPOOL_CHANNEL == j_mempool.MEMPOOL_CHANNEL


async def reactor_script(pkg) -> list:
    pool = make_pool(pkg, gossip_fanout=1)
    ch = pkg.router.Channel(
        pkg.mempool.MEMPOOL_CHANNEL, "mempool", 5, pkg.reactor.encode_txs, pkg.reactor.decode_txs
    )
    updates: asyncio.Queue = asyncio.Queue()
    r = pkg.reactor.MempoolReactor(pool, ch, updates)
    await r.start()
    out = []
    try:
        await pool.check_tx(b"5:from-peer-a", sender="peer-a")
        await pool.check_tx(b"7:local")
        await updates.put(pkg.pm.PeerUpdate("peer-a", pkg.pm.PeerStatus.UP))
        env = await asyncio.wait_for(ch.out_q.get(), 5)
        # never echoed back to its source; the local tx goes out
        out.append(("to_a", env.to, list(env.message), pkg.reactor.encode_txs(env.message)))
        await updates.put(pkg.pm.PeerUpdate("peer-b", pkg.pm.PeerStatus.UP))
        env = await asyncio.wait_for(ch.out_q.get(), 5)
        # the fan-out cap (1): the local tx already went to peer-a
        out.append(("to_b", env.to, list(env.message)))
        # inbound: a fresh tx, a duplicate, and an app-rejected one
        await ch.in_q.put(pkg.p2p.Envelope(pkg.mempool.MEMPOOL_CHANNEL,
                                           [b"9:in", b"7:local", b"bad:in"], from_="peer-b"))
        for _ in range(200):
            if pool.size() == 3:
                break
            await asyncio.sleep(0.01)
        out.append(("pool", pool.reap_max_txs(-1), ch.err_q.qsize(),
                    sorted(next(w for w in pool.all_entries() if w.tx == b"7:local").peers)))
        await updates.put(pkg.pm.PeerUpdate("peer-b", pkg.pm.PeerStatus.DOWN))
        await asyncio.sleep(0.05)
        out.append(("peers", sorted(r._peer_tasks)))
    finally:
        await r.stop()
        pool.close()
    return out


@pytest.mark.asyncio
async def test_reactor_gossip_matches_reference():
    ref, port = await reactor_script(REF), await reactor_script(PORT)
    assert port == ref
    assert port[0][2] == [b"7:local"] and port[1][2] == [b"5:from-peer-a"]
