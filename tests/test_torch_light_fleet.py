"""The port's LightD serving layer (light/fleet.py) and LoopWatchdog
against the JAX package's, on the CPU.

Hop proofs: `make_hop_proof` and `HopProof.encode` give the reference's
bytes for the same chain in both schemes, `decode` round-trips across
the packages (`convert.hop_proof`, `convert.to_reference`), and
`verify_hop_proof` gives the reference's verdicts on honest, tampered
and scheme-lying proofs (the outcome, `HopProofError.scheme` and the
message). LightD: the in-process cases of tests/test_light_fleet.py —
verdicts equal to cold clients', same-height coalescing, the busy-shed
and the proof cache — each run in both packages with their stats
compared; LightD reads `LightDConfig` alone (no TMTPU_LIGHTD_* env);
importing the port's production modules never loads a `byzantine`
module. LoopWatchdog: tests/test_libs.py's two cases. Chains are built
in both packages from the same keys (bytes compared); the port runs on
device="cpu", its BLS hops through the plain K7a/K7b. The tolerance is
zero (bytes, integers, messages)."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

import tendermint_tpu.config as j_config
import tendermint_tpu.light.client as j_client
import tendermint_tpu.light.fleet as j_fleet
import tendermint_tpu.light.types as j_lt
import tendermint_tpu.testing as j_tt
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.light.client as p_client
import tendermint_tpu_torch.light.fleet as p_fleet
import tendermint_tpu_torch.light.types as p_lt
import tendermint_tpu_torch.testing as p_tt
from tendermint_tpu_torch import convert

# the plain pairing kernels run on small tensors: one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHAIN = "light-fleet-chain"
LONG_NS = 10 * 365 * 24 * 3600 * 10**9

REF = types.SimpleNamespace(
    fleet=j_fleet, client=j_client, lt=j_lt, tt=j_tt, config=j_config, kw={}
)
PORT = types.SimpleNamespace(
    fleet=p_fleet, client=p_client, lt=p_lt, tt=p_tt, config=p_config,
    kw={"device": "cpu"},
)
PKGS = (REF, PORT)


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is compared, not judged
        return type(e).__name__, getattr(e, "scheme", None), str(e)
    return "ok", out


def _chain(pkg, kind: str, n: int):
    key_types = ("bls12381",) if kind == "bls" else ("ed25519",)
    vals, keys = pkg.tt.make_validator_set(4, key_types=key_types)
    return pkg.tt.make_light_chain(n, vals, keys, CHAIN)


@pytest.fixture(scope="module")
def chains():
    """Per package: a 6-height ed25519 chain and a 3-height bls12381 chain
    of 4 validators (the reference tests' ed_chain / bls_chain)."""
    return {
        id(pkg): {"ed": _chain(pkg, "ed", 6), "bls": _chain(pkg, "bls", 3)}
        for pkg in PKGS
    }


def _trust(pkg, chain):
    return pkg.client.TrustOptions(period_ns=LONG_NS, height=1, hash=chain[0].header.hash())


def _now(chain):
    return chain[-1].header.time_ns + 10**9


def _tamper(pkg, block, **changes):
    commit = dataclasses.replace(block.signed_header.commit, **changes)
    return pkg.lt.LightBlock(pkg.lt.SignedHeader(block.header, commit), block.validators)


# -- hop proofs -------------------------------------------------------------

PROOFS = {
    "per_sig": ("ed", True),
    "aggregate": ("bls", True),
    "bls_unfolded": ("bls", False),
}


@pytest.mark.parametrize("case", sorted(PROOFS))
def test_hop_proof_bytes_match_reference(chains, case):
    kind, fold = PROOFS[case]
    ref, port = (
        pkg.fleet.make_hop_proof(chains[id(pkg)][kind][-1], aggregate_hops=fold) for pkg in PKGS
    )
    assert port.scheme == ref.scheme == (
        p_fleet.SCHEME_AGGREGATE if case == "aggregate" else p_fleet.SCHEME_PER_SIG
    )
    assert port.encode() == ref.encode()
    assert port.wire_bytes() == ref.wire_bytes()
    # decode round-trips within and across the packages
    assert p_fleet.HopProof.decode(port.encode()).encode() == port.encode()
    assert convert.hop_proof(ref).encode() == ref.encode()
    back = convert.to_reference(port, j_fleet.HopProof)
    assert isinstance(back, j_fleet.HopProof)
    assert back.encode() == ref.encode() and back.scheme == ref.scheme


def test_aggregate_proof_is_smaller_and_keeps_the_bitmap(chains):
    chain = chains[id(PORT)]["bls"]
    agg = p_fleet.make_hop_proof(chain[-1])
    commit = agg.block.signed_header.commit
    assert commit.is_aggregate() and len(commit.agg_sig) == 96
    assert all(not cs.signature for cs in commit.signatures)
    assert agg.wire_bytes() < p_fleet.make_hop_proof(chain[-1], aggregate_hops=False).wire_bytes()


def _flip_agg(pkg, proof):
    sig = proof.block.signed_header.commit.agg_sig
    return _tamper(pkg, proof.block, agg_sig=bytes([sig[0] ^ 1]) + sig[1:])


def _flip_sig0(pkg, proof):
    commit = proof.block.signed_header.commit
    s0 = commit.signatures[0]
    bad = dataclasses.replace(s0, signature=bytes([s0.signature[0] ^ 1]) + s0.signature[1:])
    return _tamper(pkg, proof.block, signatures=(bad,) + commit.signatures[1:])


def _verify(pkg, chains, case):
    """One verify_hop_proof case in `pkg`: the verified block's bytes."""
    fl = pkg.fleet
    ed, bls = chains[id(pkg)]["ed"], chains[id(pkg)]["bls"]
    chain = bls if case.startswith(("aggregate", "lie_agg")) else ed
    proof = fl.make_hop_proof(chain[-1])
    if case == "aggregate_tampered":
        proof = fl.HopProof(_flip_agg(pkg, proof), fl.SCHEME_AGGREGATE)
    elif case == "per_sig_tampered":
        proof = fl.HopProof(_flip_sig0(pkg, proof), fl.SCHEME_PER_SIG)
    elif case == "lie_agg_as_per_sig":
        proof = fl.HopProof(proof.block, fl.SCHEME_PER_SIG)
    elif case == "lie_per_sig_as_agg":
        proof = fl.HopProof(proof.block, fl.SCHEME_AGGREGATE)
    elif case == "unknown_scheme":
        proof = fl.HopProof(proof.block, "schnorr")
    elif case == "missing_block":
        proof = fl.HopProof(None, fl.SCHEME_PER_SIG)
    elif case == "decoded_across":
        # the other package's proof, carried over by its bytes
        other = PORT if pkg is REF else REF
        proof = fl.HopProof.decode(other.fleet.make_hop_proof(chains[id(other)]["ed"][-1]).encode())
    got = fl.verify_hop_proof(CHAIN, chain[0], proof, LONG_NS, _now(chain), **pkg.kw)
    return got.encode()


VERIFY_CASES = [
    "aggregate", "aggregate_tampered", "decoded_across", "lie_agg_as_per_sig",
    "lie_per_sig_as_agg", "missing_block", "per_sig", "per_sig_tampered", "unknown_scheme",
]


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_hop_proof_verdicts_match_reference(chains, case):
    ref, port = (_outcome(lambda pkg=pkg: _verify(pkg, chains, case)) for pkg in PKGS)
    assert port == ref
    if case in ("aggregate", "per_sig", "decoded_across"):
        assert port[0] == "ok"
        return
    assert port[0] == "HopProofError"
    if case.endswith("_tampered"):
        scheme = p_fleet.SCHEME_AGGREGATE if case.startswith("aggregate") else p_fleet.SCHEME_PER_SIG
        assert port[1] == scheme and port[2].startswith(f"[{scheme}]")
    if case.startswith("lie"):
        assert "scheme tag" in port[2]


def test_verify_hop_proof_raises_without_a_card_unless_cpu_requested(chains):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    chain = chains[id(PORT)]["ed"]
    proof = p_fleet.make_hop_proof(chain[-1])
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_fleet.verify_hop_proof(CHAIN, chain[0], proof, LONG_NS, _now(chain), **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_fleet.LightD(CHAIN, _trust(PORT, chain), p_tt.make_list_provider(chain, CHAIN), **kw)


# -- LightD -----------------------------------------------------------------


def _gated(pkg, chain):
    """A list provider whose every fetch waits on an event (busy-shed)."""
    prov = pkg.tt.make_list_provider(chain, CHAIN)
    prov.gate = asyncio.Event()
    inner = prov.light_block

    async def gated(height):
        await prov.gate.wait()
        return await inner(height)

    prov.light_block = gated
    return prov


def _lightd(pkg, chain, prov, **cfg):
    kw = {"config": pkg.config.LightDConfig(**cfg)} if cfg else {}
    return pkg.fleet.LightD(CHAIN, _trust(pkg, chain), prov, **kw, **pkg.kw)


async def _fleet_vs_cold(pkg, chain):
    target, now, n_clients = 6, _now(chain), 4
    cold, cold_fetches = [], 0
    for _ in range(n_clients):
        prov = pkg.tt.make_list_provider(chain, CHAIN)
        lc = pkg.client.LightClient(CHAIN, _trust(pkg, chain), prov, **pkg.kw)
        cold.append((await lc.verify_light_block_at_height(target, now)).encode())
        cold_fetches += prov.fetches
    prov = pkg.tt.make_list_provider(chain, CHAIN)
    d = _lightd(pkg, chain, prov)
    await d.start()
    try:
        served = [(await d.sync(target, now_ns=now)).encode() for _ in range(n_clients)]
    finally:
        await d.stop()
    return {"cold": cold, "served": served, "cold_fetches": cold_fetches,
            "fetches": prov.fetches, "stats": dict(d.stats)}


async def _coalesce(pkg, chain):
    prov = _gated(pkg, chain[:4])
    d = _lightd(pkg, chain, prov)
    await d.start()
    try:
        tasks = [asyncio.ensure_future(d.sync(4, now_ns=_now(chain))) for _ in range(5)]
        await asyncio.sleep(0.05)
        prov.gate.set()
        results = await asyncio.gather(*tasks)
    finally:
        await d.stop()
    return {"served": sorted({lb.encode() for lb in results}), "stats": dict(d.stats)}


async def _busy_shed(pkg, chain):
    prov = _gated(pkg, chain)
    d = _lightd(pkg, chain, prov, max_sessions=1)
    now = _now(chain)
    await d.start()
    out = {}
    try:
        t1 = asyncio.ensure_future(d.sync(4, now_ns=now))
        await asyncio.sleep(0.05)  # t1 holds the only session
        try:
            out["shed"] = ("ok", (await d.sync(5, now_ns=now)).height)
        except pkg.fleet.LightDBusyError as e:
            out["shed"] = ("LightDBusyError", str(e))
        prov.gate.set()
        out["t1"] = (await t1).height
        # warm heights never shed: the cache path takes no session
        prov.gate.clear()
        t2 = asyncio.ensure_future(d.sync(6, now_ns=now))
        await asyncio.sleep(0.05)
        out["warm"] = (await d.sync(4, now_ns=now)).height
        prov.gate.set()
        out["t2"] = (await t2).height
    finally:
        await d.stop()
    out["stats"] = dict(d.stats)
    return out


LIGHTD_CASES = {"fleet_vs_cold": _fleet_vs_cold, "coalesce": _coalesce, "busy_shed": _busy_shed}


@pytest.mark.parametrize("case", sorted(LIGHTD_CASES))
def test_lightd_matches_reference(chains, case):
    ref, port = (asyncio.run(LIGHTD_CASES[case](pkg, chains[id(pkg)]["ed"])) for pkg in PKGS)
    assert port == ref
    st = port["stats"]
    if case == "fleet_vs_cold":
        assert port["served"] == port["cold"] and len(set(port["served"])) == 1
        assert st["hops_verified"] == 2 and st["hop_cache_hits"] == 3
        assert port["cold_fetches"] / port["fetches"] >= 3
    elif case == "coalesce":
        assert len(port["served"]) == 1
        assert st["coalesced"] == 4 and st["hops_verified"] == 2
    else:
        assert port["shed"][0] == "LightDBusyError" and "busy" in port["shed"][1]
        assert (port["t1"], port["warm"], port["t2"]) == (4, 4, 6)
        assert st["sheds"] == 1


@pytest.fixture(scope="module")
def proof_cache_runs(chains):
    """The reference test's hop_proof endpoint on the BLS chain: two
    hop_proof(3) calls through one LightD, in each package."""

    async def run(pkg):
        chain = chains[id(pkg)]["bls"]
        d = _lightd(pkg, chain, pkg.tt.make_list_provider(chain, CHAIN))
        await d.start()
        try:
            p1 = await d.hop_proof(3)
            p2 = await d.hop_proof(3)
        finally:
            await d.stop()
        return {"proofs": [p1.encode(), p2.encode()], "scheme": p1.scheme,
                "stats": dict(d.stats)}

    return tuple(asyncio.run(run(pkg)) for pkg in PKGS)


def test_hop_proof_cache_counts_match_reference(proof_cache_runs):
    ref, port = proof_cache_runs
    assert port == ref
    assert port["scheme"] == p_fleet.SCHEME_AGGREGATE
    assert port["proofs"][0] == port["proofs"][1]
    st = port["stats"]
    assert (st["proof_cache_hits"], st["proofs_served"]) == (1, 2)
    assert st["agg_hops"] > 0 and st["per_sig_hops"] == 0


def test_aggregate_sums_live_lightds(chains):
    async def run(pkg):
        chain = chains[id(pkg)]["ed"]
        ds = [_lightd(pkg, chain, pkg.tt.make_list_provider(chain, CHAIN)) for _ in range(2)]
        for d in ds:
            await d.start()
        try:
            await ds[0].sync(4, now_ns=_now(chain))
            await ds[1].sync(4, now_ns=_now(chain))
            await ds[1].sync(4, now_ns=_now(chain))
            stats, (counts, _sum, count) = pkg.fleet.aggregate()
        finally:
            for d in ds:
                await d.stop()
        return stats, sum(counts), count, pkg.fleet.aggregate()

    ref, port = (asyncio.run(run(pkg)) for pkg in PKGS)
    assert port == ref
    assert port[0]["syncs"] == 3 and port[1:3] == (3, 3) and port[3] == (None, None)


def test_lightd_reads_no_env(chains, monkeypatch):
    """The reference's LightD takes TMTPU_LIGHTD_* over its config; the
    port's takes its config alone."""
    monkeypatch.setenv("TMTPU_LIGHTD_SESSIONS", "3")
    monkeypatch.setenv("TMTPU_LIGHTD_PROOF_CACHE", "5")
    monkeypatch.setenv("TMTPU_LIGHTD_AGG_HOPS", "0")
    port, ref = (
        _lightd(pkg, chains[id(pkg)]["ed"], pkg.tt.make_list_provider(chains[id(pkg)]["ed"], CHAIN))
        for pkg in (PORT, REF)
    )
    assert (port.max_sessions, port.proof_cache_size, port.aggregate_hops) == (64, 1024, True)
    assert (ref.max_sessions, ref.proof_cache_size, ref.aggregate_hops) == (3, 5, False)
    assert dataclasses.asdict(p_config.LightDConfig()) == dataclasses.asdict(j_config.LightDConfig())
    assert port.device == torch.device("cpu") and port.client.device == torch.device("cpu")


def test_production_modules_never_load_byzantine():
    """The lunatic provider, the poisoned donor and the consensus traitors
    stay quarantined: importing every other module of the port loads none
    of them, but the scenario harness (consensus/scenarios.py), which is
    where the reference's design lets them in."""
    code = (
        "import importlib, pathlib, sys\n"
        "root = pathlib.Path('tendermint_tpu_torch')\n"
        "mods = sorted('.'.join(p.with_suffix('').parts).removesuffix('.__init__')\n"
        "              for p in root.rglob('*.py') if p.stem not in ('byzantine', 'scenarios'))\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if 'byzantine' in m]\n"
        "assert not bad, f'production wiring reaches {bad}'\n"
        "assert 'tendermint_tpu_torch.light.fleet' in sys.modules\n"
        "print('CONTAINED', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CONTAINED")


# -- LoopWatchdog (tests/test_libs.py's cases) ------------------------------


def test_wedged_loop_dumps_stacks_once(tmp_path):
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.libs.watchdog import LoopWatchdog

    async def main():
        wd = LoopWatchdog(str(tmp_path), threshold_s=0.3, interval_s=0.1)
        wd.start()
        await asyncio.sleep(0.2)  # loop healthy: no report
        assert wd.reports == []
        with trace.span("light", "sync", height=7):
            time.sleep(1.0)  # wedge the loop (blocking sleep inline)
        await asyncio.sleep(0.5)  # recover; watchdog re-arms
        wd.stop()
        return wd.reports

    was = trace.is_enabled()
    trace.configure(enabled=True)
    try:
        reports = asyncio.run(main())
    finally:
        trace.configure(enabled=was)
    assert len(reports) == 1, reports
    text = Path(reports[0]).read_text()
    assert "event loop unresponsive" in text and "--- thread" in text
    assert "time.sleep(1.0)" in text  # the wedging frame is in the stacks
    assert "--- flight recorder" in text


def test_healthy_loop_never_reports(tmp_path):
    from tendermint_tpu_torch.libs.watchdog import LoopWatchdog

    async def main():
        wd = LoopWatchdog(str(tmp_path), threshold_s=0.5, interval_s=0.05)
        wd.start()
        await asyncio.sleep(0.8)
        wd.stop()
        return wd.reports

    assert asyncio.run(main()) == []
    assert list(tmp_path.iterdir()) == []


def test_watchdog_ports_the_loop_watchdog_only():
    """The reference's BackendInitWatchdog bounds the JAX backend's attach;
    the port has no background probe, so it is not ported."""
    import tendermint_tpu.libs.watchdog as j_wd
    import tendermint_tpu_torch.libs.watchdog as p_wd

    assert hasattr(j_wd, "BackendInitWatchdog") and not hasattr(p_wd, "BackendInitWatchdog")
    assert p_wd.LoopWatchdog.__init__.__kwdefaults__ == j_wd.LoopWatchdog.__init__.__kwdefaults__


def test_watchdog_report_lists_the_flight_recorder(tmp_path):
    """The ring's spans go into the wedge report itself, one JSON object a
    line (a wedge also calls `trace.auto_dump`, from the watchdog's
    thread, as the reference's does)."""
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.libs.watchdog import LoopWatchdog

    was = trace.is_enabled()
    trace.configure(enabled=True)
    trace.RECORDER.clear()
    try:
        trace.emit("light", "sync", duration_s=0.25, height=9)
        wd = LoopWatchdog(str(tmp_path))
        wd._loop = asyncio.new_event_loop()
        try:
            wd._report()
        finally:
            wd._loop.close()
    finally:
        trace.configure(enabled=was)
    (path,) = wd.reports
    lines = Path(path).read_text().split("--- flight recorder (1 spans) ---\n")[1].splitlines()
    span = json.loads(lines[0])
    assert (span["subsystem"], span["name"], span["attrs"]) == ("light", "sync", {"height": 9})
