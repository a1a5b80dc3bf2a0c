"""The port's Byzantine strategies and safety auditor
(consensus/byzantine.py) against the JAX package's, on the CPU.

- `_decide` and `_fabricated_block_id` equal the reference's: every
  traitor decision is the same pure function of (seed, strategy,
  coordinates) in both packages. So do `ByzConfig`'s validation and the
  strategy taxonomy.
- The double-sign lifecycle (tests/test_byzantine.py's acceptance test: a
  traitor proposing height 1 double-signs its prevote and withholds its
  precommits over real routers; the frozen clock and the pinned signer
  set make the run deterministic) run by both packages: the chain, the
  app-hash chain, the committed DuplicateVoteEvidence and the signed twin
  are byte-equal, the app sees the misbehavior, the audit is green.
- The 4-validator f-max smoke (`byz_full_taxonomy`: one traitor running
  the whole strategy mix under network chaos) is ok with a green audit,
  and invalid-signature gossip costs the traitor on every honest peer
  manager.
- Containment: no port module but the scenario harness imports
  consensus/byzantine.py, and the production wiring (`node`, `cli`) does
  not reach it in a fresh interpreter.

Every port net runs on device="cpu". Each test bounds its own wall time."""

from __future__ import annotations

import ast
import asyncio
import pathlib
import subprocess
import sys
import time
import types

import pytest

import tendermint_tpu.abci.kvstore as j_kv
import tendermint_tpu.config as j_config
import tendermint_tpu.consensus.byzantine as j_byz
import tendermint_tpu.consensus.harness as j_harness
import tendermint_tpu.consensus.routernet as j_rn
import tendermint_tpu.evidence.pool as j_evpool
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu.state.state as j_state
import tendermint_tpu.types.keys as j_keys
import tendermint_tpu_torch.abci.kvstore as p_kv
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.consensus.byzantine as p_byz
import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.consensus.routernet as p_rn
import tendermint_tpu_torch.evidence.pool as p_evpool
import tendermint_tpu_torch.libs.clock as p_clock
import tendermint_tpu_torch.state.state as p_state
import tendermint_tpu_torch.types.keys as p_keys
from tendermint_tpu_torch.consensus import scenarios as p_sc
from tendermint_tpu_torch.crypto import verify_hub as p_vh

MS = 1_000_000
K_HEIGHTS = 3
REPO = pathlib.Path(__file__).resolve().parents[1]

REF = types.SimpleNamespace(byz=j_byz, harness=j_harness, rn=j_rn, clock=j_clock,
                            config=j_config, kv=j_kv, evpool=j_evpool, state=j_state,
                            keys=j_keys, kw={})
PORT = types.SimpleNamespace(byz=p_byz, harness=p_harness, rn=p_rn, clock=p_clock,
                             config=p_config, kv=p_kv, evpool=p_evpool, state=p_state,
                             keys=p_keys, kw={"device": "cpu"})


def test_strategies_and_byz_config_equal_the_reference():
    assert p_byz.STRATEGIES == j_byz.STRATEGIES
    assert p_byz.MAX_ACTION_LOG == j_byz.MAX_ACTION_LOG
    with pytest.raises(ValueError, match="unknown byzantine strategies"):
        p_byz.ByzConfig(("equivocate", "teleport"))
    cfg = p_byz.ByzConfig(("equivocate",), equiv_heights=(2,),
                          equiv_types=(p_keys.SignedMsgType.PREVOTE,))
    assert cfg.equivocates_at(2, p_keys.SignedMsgType.PREVOTE)
    assert not cfg.equivocates_at(2, p_keys.SignedMsgType.PRECOMMIT)
    assert not cfg.equivocates_at(3, p_keys.SignedMsgType.PREVOTE)


DECIDE_CASES = [
    (0, "withhold", (1, "ab" * 20)), (7, "camp", ("cd" * 20,)),
    (11, "lie_hasvote", (3, 0, 5)), (2**40 + 3, "withhold_part", (9, "peer")),
    (5, "equiv", ()),
]


@pytest.mark.parametrize("seed,tag,coords", DECIDE_CASES)
def test_decide_equals_the_reference(seed, tag, coords):
    got = p_byz._decide(seed, tag, *coords)
    assert got == j_byz._decide(seed, tag, *coords) and 0.0 <= got < 1.0


@pytest.mark.parametrize("seed,tag,coords", [
    (11, "equiv", (1, 0, 1, 2)), (3, "prop", (4, 1, 0)), (9, "badsig", (2, 0, 3)),
    (0, "flood", (5, 7, 1)),
])
def test_fabricated_block_id_equals_the_reference(seed, tag, coords):
    p = p_byz._fabricated_block_id(seed, tag, *coords)
    j = j_byz._fabricated_block_id(seed, tag, *coords)
    assert (p.hash, p.part_set_header.total, p.part_set_header.hash) == (
        j.hash, j.part_set_header.total, j.part_set_header.hash)
    assert p.part_set_header.total == 1 and len(p.hash) == 32


def _generous_config(pkg):
    return pkg.config.ConsensusConfig(
        timeout_propose_ns=3000 * MS, timeout_propose_delta_ns=500 * MS,
        timeout_prevote_ns=2000 * MS, timeout_prevote_delta_ns=500 * MS,
        timeout_precommit_ns=2000 * MS, timeout_precommit_delta_ns=500 * MS,
        timeout_commit_ns=80 * MS, skip_timeout_commit=True,
    )


def _height1_proposer(pkg, n: int) -> int:
    genesis, keys = pkg.harness.make_genesis(n)
    addr = pkg.state.state_from_genesis(genesis).validators.get_proposer().address
    return next(i for i, k in enumerate(keys) if k.pub_key().address() == addr)


async def _double_sign_lifecycle(pkg, seed: int = 11, n: int = 4, target: int = 4):
    """tests/test_byzantine.py::TestDoubleSignLifecycle's run in `pkg`."""
    byz_idx = _height1_proposer(pkg, n)
    observer = (byz_idx + 1) % n
    plan = {byz_idx: pkg.byz.ByzConfig(
        ("equivocate", "withhold_precommits"), seed=seed, equiv_heights=(1,),
        equiv_types=(pkg.keys.SignedMsgType.PREVOTE,))}
    registry: list = []
    misbehavior = []

    class RecordingApp(pkg.kv.KVStoreApp):
        def begin_block(self, req):
            if req.byzantine_validators:
                misbehavior.append((req.header.height, tuple(req.byzantine_validators)))
            return super().begin_block(req)

    net = pkg.rn.RouterNet(
        n, config=_generous_config(pkg),
        base_clock=pkg.clock.ManualClock(pkg.harness.GENESIS_TIME_NS - 500 * MS),
        prepare_hook=pkg.byz.byz_prepare_hook(plan, registry),
        app_factory=lambda i: RecordingApp() if i == observer else None, **pkg.kw)
    try:
        await net.start()
        await net.wait_for_height(target, 60)
        rep = pkg.byz.audit_net(net, registry, k_heights=K_HEIGHTS)
        evidence = pkg.byz.committed_duplicate_vote_evidence(net.nodes[observer])
        byz = registry[0]
        return {
            "blocks": net.block_fingerprints(target, node=observer),
            "apps": net.app_hash_chain(target, node=observer),
            "audit": rep.as_dict(),
            "evidence": {a: (h, ev.encode()) for a, (h, ev) in evidence.items()},
            "twins": [(k[0], k[1], int(k[2]), v.encode()) for k, v in byz.twins.items()],
            "equivocated": byz.action_counts.get("equivocate", 0),
            "withheld": byz.action_counts.get("withhold_precommit", 0),
            "misbehavior": [(h, [(m.type, m.validator_address, m.height) for m in mbs])
                            for h, mbs in misbehavior],
            "byz_addr": byz.address,
        }
    finally:
        await net.stop()


def test_double_sign_lifecycle_is_byte_equal_to_the_reference():
    t0 = time.perf_counter()
    ref = asyncio.run(asyncio.wait_for(_double_sign_lifecycle(REF), 90))
    port = asyncio.run(asyncio.wait_for(_double_sign_lifecycle(PORT), 90))
    addr = port["byz_addr"]
    assert addr in port["evidence"], "the equivocation never reached the chain"
    commit_h, ev_bytes = port["evidence"][addr]
    assert commit_h - 1 <= K_HEIGHTS
    assert port["twins"] and port["equivocated"] == ref["equivocated"] and port["withheld"] > 0
    assert port["misbehavior"] and port["misbehavior"][0][0] == commit_h
    assert port["misbehavior"][0][1][0] == ("duplicate_vote", addr, 1)
    assert port["audit"]["ok"], port["audit"]
    assert port["audit"]["evidence_commit_heights"] == {addr.hex(): commit_h}
    # byte-equal to the reference
    assert all(port["blocks"]) and port["blocks"] == ref["blocks"]
    assert port["apps"] == ref["apps"]
    assert port["evidence"] == ref["evidence"]
    assert port["twins"] == ref["twins"]
    assert port["misbehavior"] == ref["misbehavior"]
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 60.0


def test_f_max_full_taxonomy_4val_smoke():
    """tests/test_byzantine.py's f-max smoke: f = 1 of 4 running the whole
    strategy mix under network chaos; ok, with a green audit and the
    equivocator's evidence committed."""
    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(p_sc.run_scenario(
        "byz_full_taxonomy", n_vals=4, target_height=4, seed=7, timeout_s=120.0,
        stall_s=40.0, device="cpu"), 150))
    d = res.as_dict()
    assert res.ok, d
    assert d["audit"]["ok"], d["audit"]
    assert res.byz_indices == [3]
    assert d["audit"]["evidence_commit_heights"], "the equivocator escaped"
    counts = d["byz_actions"][0]["counts"]
    assert counts.get("equivocate", 0) > 0 and counts.get("invalid_sig", 0) > 0
    assert time.perf_counter() - t0 < 50.0


def test_invalid_sig_gossip_costs_the_peer():
    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(p_sc.run_scenario(
        "byz_invalid_sig", n_vals=4, target_height=4, seed=3, timeout_s=90.0,
        stall_s=30.0, device="cpu"), 120))
    d = res.as_dict()
    assert res.ok, d
    assert d["audit"]["ok"], d["audit"]
    penalties = d["audit"]["peer_penalties"]
    assert penalties and not d["audit"]["unpenalized"]
    assert all(score < 0 for by_node in penalties.values() for score in by_node.values())
    assert time.perf_counter() - t0 < 40.0


def _imports_of(path: pathlib.Path) -> set[str]:
    """Absolute names of the modules `path` imports (relative imports
    resolved against its package)."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = pkg.split(".")
            if node.level:
                base = base[: len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
    return out


def test_containment_only_the_scenario_harness_imports_byzantine():
    target = "tendermint_tpu_torch.consensus.byzantine"
    importers = sorted(
        str(p.relative_to(REPO)) for p in (REPO / "tendermint_tpu_torch").rglob("*.py")
        if target in _imports_of(p))
    assert importers == ["tendermint_tpu_torch/consensus/scenarios.py"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tendermint_tpu_torch.node, tendermint_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.endswith('consensus.byzantine')]\n"
        "assert not bad, bad\n"
        "print('CONTAINED')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CONTAINED" in out.stdout
    assert p_sc.ByzConfig is p_byz.ByzConfig  # the harness is the legal importer
