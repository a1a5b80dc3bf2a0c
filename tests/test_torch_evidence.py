"""The port's evidence pool and reactor (tendermint_tpu_torch/evidence/
{pool,reactor}.py) against the JAX package's, on the CPU.

The JAX package builds an 8-block kvstore chain of 8 validators;
`convert` carries its block and state stores across to the port. On
that chain both pools (the port's on device="cpu") check the same
evidence — a duplicate vote, a light-client attack from
`light.byzantine.LunaticProvider` (3 colluders forge height 6 against
common height 2), and tampered or mis-stamped copies of each — with the
same verdicts and error texts; pending / committed / prune and the
consensus-reported equivocation follow the same script; and each
package's reactor gossips the valid evidence from one pool to another
over `Channel`s. The port's evidence is carried to the reference through
its bytes. The tolerance is zero (verdicts, texts, bytes)."""

from __future__ import annotations

import asyncio
import dataclasses
import types

import pytest

import tendermint_tpu.evidence as j_evpkg
import tendermint_tpu.evidence.pool as j_pool
import tendermint_tpu.evidence.reactor as j_reactor
import tendermint_tpu.p2p.peermanager as j_pm
import tendermint_tpu.p2p.router as j_router
import tendermint_tpu.p2p.types as j_p2p
import tendermint_tpu.store.db as j_db
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.evidence as j_ev
import tendermint_tpu_torch.evidence as p_evpkg
import tendermint_tpu_torch.evidence.pool as p_pool
import tendermint_tpu_torch.evidence.reactor as p_reactor
import tendermint_tpu_torch.p2p.peermanager as p_pm
import tendermint_tpu_torch.p2p.router as p_router
import tendermint_tpu_torch.p2p.types as p_p2p
import tendermint_tpu_torch.store.db as p_db
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.evidence as p_ev
from tendermint_tpu_torch import convert

CHAIN = "ev-port-chain"
N_VALS, N_BLOCKS = 8, 8

REF = types.SimpleNamespace(
    pool=j_pool, reactor=j_reactor, evpkg=j_evpkg, pm=j_pm, router=j_router, p2p=j_p2p,
    db=j_db, ev=j_ev, kw={},
)
PORT = types.SimpleNamespace(
    pool=p_pool, reactor=p_reactor, evpkg=p_evpkg, pm=p_pm, router=p_router, p2p=p_p2p,
    db=p_db, ev=p_ev, kw={"device": "cpu"},
)


@pytest.fixture(scope="module")
def chain():
    bstore, sstore, _conns, genesis, _by_addr = asyncio.run(
        j_tt.build_kvstore_chain(N_BLOCKS, N_VALS, CHAIN)
    )
    REF.stores = (sstore, bstore)
    PORT.stores = (convert.state_store(sstore), convert.block_store(bstore))
    keys = p_tt.det_priv_keys(N_VALS)
    by_addr = {k.pub_key().address(): k for k in keys}
    ss, bs = PORT.stores
    dup = p_tt.make_duplicate_vote_evidence(CHAIN, bs, ss, keys[1], 3)
    lca = asyncio.run(p_tt.make_lunatic_evidence(
        CHAIN, bs, ss, by_addr, common_height=2, attack_height=6, n_traitors=3, seed=7
    ))
    return types.SimpleNamespace(keys=keys, dup=dup, lca=lca)


def make_pool(pkg):
    ss, bs = pkg.stores
    return pkg.pool.EvidencePool(pkg.db.MemDB(), ss, bs, **pkg.kw)


def _in(pkg, ev):
    """`ev` (the port's) as `pkg`'s evidence, through its bytes."""
    return ev if pkg is PORT else convert.evidence_to(ev, j_ev.decode_evidence)


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


def _flip_sig(sig: bytes) -> bytes:
    return bytes([sig[0] ^ 1]) + sig[1:]


def _tampered_commit_sig(lca, slot=0):
    cb = lca.conflicting_block
    sh = cb.signed_header
    sigs = list(sh.commit.signatures)
    sigs[slot] = dataclasses.replace(sigs[slot], signature=_flip_sig(sigs[slot].signature))
    commit = dataclasses.replace(sh.commit, signatures=tuple(sigs))
    block = dataclasses.replace(cb, signed_header=dataclasses.replace(sh, commit=commit))
    return dataclasses.replace(lca, conflicting_block=block)


CASES = {
    "dup_valid": lambda c: c.dup,
    "dup_bad_signature": lambda c: dataclasses.replace(
        c.dup, vote_b=dataclasses.replace(c.dup.vote_b, signature=_flip_sig(c.dup.vote_b.signature))
    ),
    "dup_power": lambda c: dataclasses.replace(c.dup, validator_power=c.dup.validator_power + 5),
    "dup_total_power": lambda c: dataclasses.replace(c.dup, total_voting_power=1),
    "dup_timestamp": lambda c: dataclasses.replace(c.dup, timestamp_ns=c.dup.timestamp_ns + 1),
    "dup_future": lambda c: dataclasses.replace(
        c.dup,
        vote_a=dataclasses.replace(c.dup.vote_a, height=99),
        vote_b=dataclasses.replace(c.dup.vote_b, height=99),
    ),
    "lca_valid": lambda c: c.lca,
    "lca_bad_commit_signature": lambda c: _tampered_commit_sig(c.lca),
    "lca_attribution": lambda c: dataclasses.replace(
        c.lca, byzantine_validators=c.lca.byzantine_validators[1:]
    ),
    "lca_timestamp": lambda c: dataclasses.replace(c.lca, timestamp_ns=c.lca.timestamp_ns + 1),
    "lca_total_power": lambda c: dataclasses.replace(c.lca, total_voting_power=79),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdicts_and_errors_match_reference(chain, case):
    ev = CASES[case](chain)
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        pool = make_pool(pkg)
        got[name] = (
            _outcome(lambda: pool.add_evidence(_in(pkg, ev))),
            [e.encode() for e in pool.pending_evidence(1 << 20)[0]],
        )
    assert got["port"] == got["ref"]
    if case.endswith("_valid"):
        assert got["port"][0] == "ok" and got["port"][1] == [ev.encode()]
    else:
        assert got["port"][0][0] in ("EvidenceError", "ValueError") and got["port"][1] == []


def test_lunatic_evidence_bytes_match_reference(chain):
    """The reference's light client would form the same bytes: the forged
    block decodes back equal there, and both packages attribute the same
    colluders."""
    ref_ev = convert.evidence_to(chain.lca, j_ev.decode_evidence)
    assert ref_ev.encode() == chain.lca.encode() and ref_ev.hash() == chain.lca.hash()
    assert len(chain.lca.byzantine_validators) == 3
    dup = j_tt.make_vote(CHAIN, j_tt.det_priv_keys(N_VALS)[1], chain.dup.vote_a.validator_index, 3, 0,
                         chain.dup.vote_a.type, chain.dup.vote_a.block_id,
                         timestamp_ns=chain.dup.vote_a.timestamp_ns)
    assert dup.encode() == chain.dup.vote_a.encode()


async def pool_script(pkg, chain) -> list:
    out = []
    pool = make_pool(pkg)
    dup, lca = _in(pkg, chain.dup), _in(pkg, chain.lca)
    for ev in (dup, lca, dup):
        out.append(_outcome(lambda ev=ev: pool.add_evidence(ev)))
    pending, size = pool.pending_evidence(1 << 20)
    out.append(("pending", [e.hash() for e in pending], size))
    out.append(("clipped", [e.hash() for e in pool.pending_evidence(size - 1)[0]]))
    out.append(_outcome(lambda: pool.check_evidence((dup, lca))))
    out.append(_outcome(lambda: pool.check_evidence((dup, dup))))
    state = pool.state
    pool.update(state, (dup,))
    out.append(("after_commit", [e.hash() for e in pool.pending_evidence(1 << 20)[0]]))
    out.append(_outcome(lambda: pool.check_evidence((dup,))))
    out.append(_outcome(lambda: pool.add_evidence(dup)))
    # a consensus-reported equivocation becomes pending at the next update
    other = pkg.ev.decode_evidence(
        p_tt.make_duplicate_vote_evidence(CHAIN, PORT.stores[1], PORT.stores[0],
                                          chain.keys[4], 2).encode()
    )
    pool.report_conflicting_votes(other.vote_a, other.vote_b)
    pool.report_conflicting_votes(other.vote_a, other.vote_b)
    pool.update(state, ())
    out.append(("reported", sorted(e.hash() for e in pool.pending_evidence(1 << 20)[0])))
    # prune: past both expiry dimensions
    params = state.consensus_params.evidence
    later = dataclasses.replace(
        state,
        last_block_height=state.last_block_height + params.max_age_num_blocks + 1,
        last_block_time_ns=state.last_block_time_ns + params.max_age_duration_ns + 1,
    )
    pool.update(later, ())
    out.append(("pruned", [e.hash() for e in pool.pending_evidence(1 << 20)[0]]))
    return out


@pytest.mark.asyncio
async def test_pending_committed_prune_match_reference(chain):
    ref, port = await pool_script(REF, chain), await pool_script(PORT, chain)
    assert port == ref
    assert port[0] == "ok" and port[1] == "ok" and len(port[3][1]) == 2
    assert port[-1] == ("pruned", [])


async def gossip_script(pkg, chain) -> list:
    """Pool A holds the valid evidence; A's reactor offers it to B, whose
    reactor verifies and pools it; an invalid offer costs the peer."""
    pools = [make_pool(pkg), make_pool(pkg)]
    pools[0].add_evidence(_in(pkg, chain.dup))
    pools[0].add_evidence(_in(pkg, chain.lca))
    chans = [pkg.router.Channel(pkg.evpkg.EVIDENCE_CHANNEL, "evidence", 6,
                                lambda e: e.encode(), pkg.ev.decode_evidence) for _ in pools]
    ups = [asyncio.Queue(), asyncio.Queue()]
    reactors = [pkg.reactor.EvidenceReactor(p, c, u) for p, c, u in zip(pools, chans, ups)]
    names = ("node-a", "node-b")

    async def pump(src: int):
        dst = 1 - src
        while True:
            env = await chans[src].out_q.get()
            # the wire carries the evidence's bytes
            await chans[dst].in_q.put(pkg.p2p.Envelope(
                pkg.evpkg.EVIDENCE_CHANNEL, env.message.encode(), from_=names[src]))

    for r in reactors:
        await r.start()
    pumps = [asyncio.ensure_future(pump(i)) for i in (0, 1)]
    try:
        await ups[0].put(pkg.pm.PeerUpdate(names[1], pkg.pm.PeerStatus.UP))
        await ups[1].put(pkg.pm.PeerUpdate(names[0], pkg.pm.PeerStatus.UP))
        for _ in range(500):
            if len(pools[1].pending_evidence(1 << 20)[0]) == 2:
                break
            await asyncio.sleep(0.01)
        ss, bs = PORT.stores
        bad = p_tt.make_duplicate_vote_evidence(CHAIN, bs, ss, chain.keys[5], 4)
        bad = dataclasses.replace(
            bad, vote_b=dataclasses.replace(bad.vote_b, signature=_flip_sig(bad.vote_b.signature))
        )
        await chans[1].in_q.put(pkg.p2p.Envelope(
            pkg.evpkg.EVIDENCE_CHANNEL, bad.encode(), from_="node-c"))
        err = await asyncio.wait_for(chans[1].err_q.get(), 10)
        return [
            sorted(e.hash() for e in pools[1].pending_evidence(1 << 20)[0]),
            sorted(e.hash() for e in pools[0].pending_evidence(1 << 20)[0]),
            (err.node_id, err.err),
        ]
    finally:
        for t in pumps:
            t.cancel()
        await asyncio.gather(*pumps, return_exceptions=True)
        for r in reactors:
            await r.stop()


@pytest.mark.asyncio
async def test_reactor_gossip_matches_reference(chain):
    ref, port = await gossip_script(REF, chain), await gossip_script(PORT, chain)
    assert port == ref
    assert port[0] == port[1] == sorted([chain.dup.hash(), chain.lca.hash()])
    assert port[2][0] == "node-c" and "bad evidence" in port[2][1]
