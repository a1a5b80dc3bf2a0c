"""The port's lunatic provider (light/byzantine.py) against the JAX
package's, on the CPU.

For the same `LunaticConfig`, `traitor_indices` and `forge_light_block`
give the reference's subsets and bytes. A port `LightClient` and a port
`LightD`, each with a `LunaticProvider` primary and an honest witness,
raise `Divergence` and report `LightClientAttackEvidence` byte-equal to
what the reference's client reports on the same chain; LightD counts the
divergence. Chains are built in both packages from the same keys; the
port runs on device="cpu". The tolerance is zero (bytes, integers)."""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

import tendermint_tpu.light.byzantine as j_byz
import tendermint_tpu.light.client as j_client
import tendermint_tpu.light.fleet as j_fleet
import tendermint_tpu.light.provider as j_provider
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.evidence as j_ev
import tendermint_tpu_torch.light.byzantine as p_byz
import tendermint_tpu_torch.light.client as p_client
import tendermint_tpu_torch.light.fleet as p_fleet
import tendermint_tpu_torch.light.provider as p_provider
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.evidence as p_ev

torch.set_num_threads(1)

CHAIN = "lunatic-chain"
LONG_NS = 10 * 365 * 24 * 3600 * 10**9
N_VALS, N_HEIGHTS = 5, 6

REF = types.SimpleNamespace(byz=j_byz, client=j_client, fleet=j_fleet, provider=j_provider,
                            tt=j_tt, ev=j_ev, kw={})
PORT = types.SimpleNamespace(byz=p_byz, client=p_client, fleet=p_fleet, provider=p_provider,
                             tt=p_tt, ev=p_ev, kw={"device": "cpu"})
PKGS = (REF, PORT)


@pytest.fixture(scope="module")
def chains():
    """Per package: the validator set, its keys and a 6-height chain."""
    out = {}
    for pkg in PKGS:
        vals, keys = pkg.tt.make_validator_set(N_VALS)
        out[id(pkg)] = (vals, keys, pkg.tt.make_light_chain(N_HEIGHTS, vals, keys, CHAIN))
    return out


CONFIGS = [((5,), 0, 2), ((4, 6), 7, 2), ((6,), 11, 3), ((6,), 3, 9)]


@pytest.mark.parametrize("heights,seed,n_traitors", CONFIGS)
@pytest.mark.parametrize("n_vals", [1, 4, 5, 150])
def test_traitor_indices_match_reference(heights, seed, n_traitors, n_vals):
    ref, port = (pkg.byz.traitor_indices(pkg.byz.LunaticConfig(heights, seed, n_traitors), n_vals)
                 for pkg in PKGS)
    assert port == ref
    assert len(port) == min(n_traitors, n_vals) and len(set(port)) == len(port)


@pytest.mark.parametrize("heights,seed,n_traitors", CONFIGS[:3])
def test_forged_light_blocks_match_reference(chains, heights, seed, n_traitors):
    forged = []
    for pkg in PKGS:
        vals, keys, chain = chains[id(pkg)]
        cfg = pkg.byz.LunaticConfig(heights, seed, n_traitors)
        forged.append([pkg.byz.forge_light_block(cfg, chain[h - 1], vals, keys, CHAIN).encode()
                       for h in heights])
    ref, port = forged
    assert port == ref
    vals, keys, chain = chains[id(PORT)]
    lb = p_client.LightBlock.decode(port[0])
    assert lb.header.app_hash != chain[heights[0] - 1].header.app_hash
    assert len(lb.validators.validators) == min(n_traitors, N_VALS)
    lb.validate_basic(CHAIN)


def _recording(pkg, inner):
    """An honest provider over `inner` that records the evidence reported
    to it."""

    class Recording(pkg.provider.Provider):
        def __init__(self):
            self.reported = []

        def __repr__(self):
            return "Recording"

        def chain_id(self):
            return inner.chain_id()

        async def light_block(self, height):
            return await inner.light_block(height)

        async def report_evidence(self, evidence):
            self.reported.append(evidence)

    return Recording()


def _attack(pkg, chains, serving: str):
    """A lunatic primary forging height 6 and an honest witness: a
    LightClient (or a LightD) syncs to 6. Returns the outcome, the
    evidence the witness got, the heights forged and LightD's
    divergences."""
    vals, keys, chain = chains[id(pkg)]
    cfg = pkg.byz.LunaticConfig((N_HEIGHTS,), seed=5, n_traitors=3)
    primary = pkg.byz.LunaticProvider(pkg.tt.make_list_provider(chain, CHAIN), cfg, vals, keys)
    witness = _recording(pkg, pkg.tt.make_list_provider(chain, CHAIN))
    trust = pkg.client.TrustOptions(LONG_NS, 1, chain[0].header.hash())
    now = chain[-1].header.time_ns + 10**9
    if serving == "client":
        node = pkg.client.LightClient(CHAIN, trust, primary, [witness], **pkg.kw)
        sync = node.verify_light_block_at_height
    else:
        node = pkg.fleet.LightD(CHAIN, trust, primary, [witness], **pkg.kw)
        sync = node.sync

    async def go():
        if serving == "lightd":
            await node.start()
        try:
            await sync(N_HEIGHTS, now)
        except pkg.client.Divergence as e:
            return "Divergence", str(e), [lb.encode() for lb in e.trace], e.challenging.encode()
        finally:
            if serving == "lightd":
                await node.stop()
        return ("ok",)

    out = asyncio.run(go())
    return {
        "outcome": out,
        "evidence": [ev.encode() for ev in witness.reported],
        "forged": list(primary.served_forged),
        "traitors": primary.traitor_addresses(),
        "divergences": node.stats["divergences"] if serving == "lightd" else None,
    }


@pytest.mark.parametrize("serving", ["client", "lightd"])
def test_lunatic_primary_forms_the_reference_evidence(chains, serving):
    """The port's client (or LightD) against a lunatic primary reports the
    evidence the reference's LightClient reports on the same chain."""
    ref = _attack(REF, chains, "client")
    port = _attack(PORT, chains, serving)
    assert ref["outcome"][0] == "Divergence" and ref["evidence"]
    assert port["outcome"] == ref["outcome"]
    assert port["evidence"] == ref["evidence"]
    assert port["forged"] == ref["forged"] == [N_HEIGHTS]
    assert port["traitors"] == ref["traitors"]
    if serving == "lightd":
        assert port["divergences"] == 1
    (data,) = port["evidence"]
    ev = p_ev.decode_evidence(data)
    assert isinstance(ev, p_ev.LightClientAttackEvidence)
    assert ev.encode() == data
    assert j_ev.decode_evidence(data).encode() == data
    assert ev.common_height == 1


def test_the_provider_passes_honest_heights_through(chains):
    vals, keys, chain = chains[id(PORT)]
    cfg = p_byz.LunaticConfig((4,), seed=1)
    prov = p_byz.LunaticProvider(p_tt.make_list_provider(chain, CHAIN), cfg, vals, keys)
    got = [asyncio.run(prov.light_block(h)).encode() for h in (3, 4, 4, 5)]
    assert got[0] == chain[2].encode() and got[3] == chain[4].encode()
    assert got[1] == got[2] != chain[3].encode()  # one forgery, served twice
    assert prov.served_forged == [4, 4]
    asyncio.run(prov.report_evidence("ev"))  # a traitor drops evidence on the floor
