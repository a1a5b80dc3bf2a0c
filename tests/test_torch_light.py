"""The port's light client against the JAX package's, on the CPU.

Both packages build the same chains from `det_priv_keys` (bytes
compared): `testing.make_light_chain` over one static set, a chain whose
validator set rotates by one validator every four heights (so a long
skip must bisect), and a 12-height kvstore chain with a validator joining
(tests/test_torch_chain.py's) served by `BlockStoreProvider`. Held equal:
every verifier verdict and error message (the `VerificationError` height
of `verify_adjacent_chain` included), the client's sequential, skipping
and backwards runs (what it returns, stores and fetches), expired trust,
a wrong trusted hash, a divergence (the reported evidence's bytes) and a
bad witness dropped, `RetryingProvider` and the `libs.retry` primitives.
One test lowers `MIN_TPU_BATCH` and `_MAX_BUCKET` so that
`verify_adjacent_chain` reaches the plain `kernel_eq` in three chunks,
with the bad signature in the last. The port runs on device="cpu"; the
tolerance is zero."""

from __future__ import annotations

import asyncio
import random
import sys
import types
from dataclasses import replace

import pytest
import torch

import tendermint_tpu.crypto.hashes as j_hashes
import tendermint_tpu.libs.retry as j_retry
import tendermint_tpu.light.client as j_client
import tendermint_tpu.light.provider as j_provider
import tendermint_tpu.light.types as j_ltypes
import tendermint_tpu.light.verifier as j_verifier
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.block as j_block
import tendermint_tpu.types.evidence as j_ev
import tendermint_tpu.types.validator_set as j_vs
import tendermint_tpu_torch.crypto.hashes as p_hashes
import tendermint_tpu_torch.libs.retry as p_retry
import tendermint_tpu_torch.light.client as p_client
import tendermint_tpu_torch.light.provider as p_provider
import tendermint_tpu_torch.light.types as p_ltypes
import tendermint_tpu_torch.light.verifier as p_verifier
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.block as p_block
import tendermint_tpu_torch.types.evidence as p_ev
import tendermint_tpu_torch.types.validation as p_val
import tendermint_tpu_torch.types.validator_set as p_vs
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto.cuda import verify as p_V

# the plain kernel_eq runs on small tensors: one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CHAIN = "light-chain"
N_VALS = 6
N_HEADERS = 16
T0 = 1_700_000_000_000_000_000
SEC = 1_000_000_000
LONG = 10 * 365 * 24 * 3600 * SEC
NOW = T0 + (N_HEADERS + 5) * SEC

REF = types.SimpleNamespace(
    tt=j_tt, verifier=j_verifier, client=j_client, provider=j_provider, lt=j_ltypes,
    block=j_block, vs=j_vs, ev=j_ev, retry=j_retry, sha=j_hashes.sha256, kw={},
)
PORT = types.SimpleNamespace(
    tt=p_tt, verifier=p_verifier, client=p_client, provider=p_provider, lt=p_ltypes,
    block=p_block, vs=p_vs, ev=p_ev, retry=p_retry, sha=p_hashes.sha256,
    kw={"device": "cpu"},
)
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def host_route(monkeypatch):
    """Every batch on the host route (the plain kernel_eq costs ~0.8 s a
    chunk here), but where a test lowers the cutoff itself."""
    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 1 << 30)


def _plain(value):
    """A comparable form of a result: light blocks by their bytes."""
    if hasattr(value, "encode") and hasattr(value, "signed_header"):
        return value.encode()
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is compared, not judged
        return type(e).__name__, str(e)
    return "ok", _plain(out)


def _both(fn):
    """fn(pkg) in each package: (reference outcome, port outcome)."""
    return tuple(_outcome(lambda pkg=pkg: fn(pkg)) for pkg in PKGS)


# -- chains ------------------------------------------------------------------


def _static_chain(pkg, n=N_HEADERS, n_vals=N_VALS):
    vals, keys = pkg.tt.make_validator_set(n_vals)
    return pkg.tt.make_light_chain(n, vals, keys, CHAIN), keys


def _rotating_chain(pkg, n=N_HEADERS, width=4):
    """Heights 1..n; the set at height h is validators (h-1)//4 ..
    (h-1)//4 + width - 1 of one key list, power 10 each: one validator
    leaves and one joins every four heights, and each header pins the
    next height's set."""
    keys = pkg.tt.det_priv_keys(n // 4 + width)

    def vset(h):
        ks = keys[(h - 1) // 4 : (h - 1) // 4 + width]
        vals = pkg.vs.ValidatorSet([pkg.vs.Validator(k.pub_key(), 10) for k in ks])
        return vals, {k.pub_key().address(): k for k in ks}

    b, out, last_bid = pkg.block, [], pkg.block.BlockID()
    for h in range(1, n + 1):
        vals, by_addr = vset(h)
        header = b.Header(
            chain_id=CHAIN, height=h, time_ns=T0 + h * SEC, last_block_id=last_bid,
            last_commit_hash=pkg.sha(b"lc%d" % h), data_hash=pkg.sha(b"data%d" % h),
            validators_hash=vals.hash(), next_validators_hash=vset(h + 1)[0].hash(),
            consensus_hash=pkg.sha(b"consensus"), app_hash=pkg.sha(b"app%d" % h),
            last_results_hash=pkg.sha(b"results"), evidence_hash=b"",
            proposer_address=vals.validators[0].address,
        )
        bid = b.BlockID(header.hash(), b.PartSetHeader(1, pkg.sha(b"p%d" % h)))
        commit = pkg.tt.make_commit(CHAIN, h, 0, bid, vals, by_addr, timestamp_ns=header.time_ns)
        out.append(pkg.lt.LightBlock(pkg.lt.SignedHeader(header, commit), vals))
        last_bid = bid
    return out


CHAINS = {}


def _chain(pkg, kind):
    key = (id(pkg), kind)
    if key not in CHAINS:
        CHAINS[key] = _rotating_chain(pkg) if kind == "rotating" else _static_chain(pkg)[0]
    return CHAINS[key]


def _resign(pkg, lb, keys, **header_fields):
    """`lb` with its header changed and a commit by its set over it."""
    b = pkg.block
    header = replace(lb.header, **header_fields)
    bid = b.BlockID(header.hash(), lb.signed_header.commit.block_id.part_set_header)
    commit = pkg.tt.make_commit(
        CHAIN, header.height, 0, bid, lb.validators, keys,
        timestamp_ns=header.time_ns,
    )
    return pkg.lt.LightBlock(pkg.lt.SignedHeader(header, commit), lb.validators)


def _tamper(pkg, lb, slot=0):
    commit = lb.signed_header.commit
    sigs = list(commit.signatures)
    s = sigs[slot].signature
    sigs[slot] = replace(sigs[slot], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    sh = pkg.lt.SignedHeader(lb.header, replace(commit, signatures=tuple(sigs)))
    return pkg.lt.LightBlock(sh, lb.validators)


@pytest.mark.parametrize("kind", ["static", "rotating"])
def test_chains_are_byte_identical(kind):
    ref, port = _chain(REF, kind), _chain(PORT, kind)
    assert [lb.encode() for lb in port] == [lb.encode() for lb in ref]
    assert [lb.header.hash() for lb in port] == [lb.header.hash() for lb in ref]
    assert [convert.light_block(lb).encode() for lb in ref] == [lb.encode() for lb in port]
    for lb in port:
        lb.validate_basic(CHAIN)
        assert p_ltypes.LightBlock.decode(lb.encode()).encode() == lb.encode()


def test_make_light_chain_options_match_reference():
    out = []
    for pkg in PKGS:
        vals, keys = pkg.tt.make_validator_set(4, power=7)
        chain = pkg.tt.make_light_chain(
            5, vals, keys, "other-chain", start_time_ns=T0 + 3, block_interval_ns=7 * SEC
        )
        out.append([lb.encode() for lb in chain])
    assert out[1] == out[0]


# -- the verifier ------------------------------------------------------------


def _keys(pkg):
    return _static_chain(pkg, n=1)[1]


VERIFIER_CASES = {
    "adjacent": lambda pkg, c: pkg.verifier.verify_adjacent(CHAIN, c[0], c[1], LONG, NOW, **pkg.kw),
    "adjacent, reversed": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[1], c[0], LONG, NOW, **pkg.kw),
    "adjacent, gap": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], c[2], LONG, NOW, **pkg.kw),
    "adjacent, expired": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], c[1], SEC, NOW, **pkg.kw),
    "adjacent, from the future": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], c[1], LONG, T0 - 60 * SEC, **pkg.kw),
    "adjacent, time not after": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], _resign(pkg, c[1], _keys(pkg), time_ns=c[0].header.time_ns), LONG, NOW,
        **pkg.kw),
    "adjacent, validators hash": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, _resign(pkg, c[0], _keys(pkg), next_validators_hash=b"\x05" * 32), c[1], LONG,
        NOW, **pkg.kw),
    "adjacent, bad signature": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], _tamper(pkg, c[1], 2), LONG, NOW, **pkg.kw),
    "adjacent, wrong chain": lambda pkg, c: pkg.verifier.verify_adjacent(
        "other", c[0], c[1], LONG, NOW, **pkg.kw),
    "adjacent, commit for another header": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[0], pkg.lt.LightBlock(
            pkg.lt.SignedHeader(c[1].header, c[2].signed_header.commit), c[1].validators),
        LONG, NOW, **pkg.kw),
    "non-adjacent": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], c[-1], LONG, NOW, **pkg.kw),
    "non-adjacent, adjacent heights": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[3], c[4], LONG, NOW, **pkg.kw),
    "non-adjacent, expired": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], c[-1], SEC, NOW, **pkg.kw),
    "non-adjacent, bad signature": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], _tamper(pkg, c[-1], 1), LONG, NOW, **pkg.kw),
    "verify, adjacent": lambda pkg, c: pkg.verifier.verify(
        CHAIN, c[4], c[5], LONG, NOW, **pkg.kw),
    "verify, skip": lambda pkg, c: pkg.verifier.verify(CHAIN, c[4], c[9], LONG, NOW, **pkg.kw),
    "chain": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:], LONG, NOW, **pkg.kw),
    "chain, gap": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:5] + c[6:], LONG, NOW, **pkg.kw),
    "chain, expired": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:], 3 * SEC, NOW, **pkg.kw),
    "chain, from the future at height 15": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:], LONG, T0 + 5 * SEC, **pkg.kw),
    "chain, bad signature at height 7": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:6] + [_tamper(pkg, c[6], 3)] + c[7:], LONG, NOW, **pkg.kw),
    "chain, bad signature at the top": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:-1] + [_tamper(pkg, c[-1], 0)], LONG, NOW, **pkg.kw),
}

ROTATING_CASES = {
    "rotating, adjacent across a change": lambda pkg, c: pkg.verifier.verify_adjacent(
        CHAIN, c[3], c[4], LONG, NOW, **pkg.kw),
    "rotating, skip 1 of 4 shared": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], c[-1], LONG, NOW, **pkg.kw),
    "rotating, skip 3 of 4 shared": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], c[7], LONG, NOW, **pkg.kw),
    "rotating, skip 2 of 4 shared at level 2/3": lambda pkg, c: pkg.verifier.verify_non_adjacent(
        CHAIN, c[0], c[11], LONG, NOW, trust_level=pkg.verifier.DEFAULT_TRUST_LEVEL * 2,
        **pkg.kw),
    "rotating, verify 1 of 4 shared": lambda pkg, c: pkg.verifier.verify(
        CHAIN, c[0], c[-1], LONG, NOW, **pkg.kw),
    "rotating, chain": lambda pkg, c: pkg.verifier.verify_adjacent_chain(
        CHAIN, c[0], c[1:], LONG, NOW, **pkg.kw),
    "rotating, chain, bad signature at height 9": lambda pkg, c: (
        pkg.verifier.verify_adjacent_chain(
            CHAIN, c[0], c[1:8] + [_tamper(pkg, c[8], 2)] + c[9:], LONG, NOW, **pkg.kw)),
}

WANT = {
    "adjacent": "ok", "non-adjacent": "ok", "non-adjacent, adjacent heights": "ok",
    "verify, adjacent": "ok", "verify, skip": "ok", "chain": "ok",
    "rotating, adjacent across a change": "ok", "rotating, skip 3 of 4 shared": "ok",
    "rotating, chain": "ok", "adjacent, wrong chain": "ValueError",
    "adjacent, commit for another header": "ValueError",
    "rotating, skip 1 of 4 shared": "ErrNewValSetCantBeTrusted",
    "rotating, skip 2 of 4 shared at level 2/3": "ErrNewValSetCantBeTrusted",
    "rotating, verify 1 of 4 shared": "ErrNewValSetCantBeTrusted",
    # the trusting check meets the bad signature first
    "non-adjacent, bad signature": "ErrNewValSetCantBeTrusted",
}


@pytest.mark.parametrize("case", sorted(VERIFIER_CASES) + sorted(ROTATING_CASES))
def test_verifier_verdicts_match_reference(case):
    fn = VERIFIER_CASES.get(case) or ROTATING_CASES[case]
    kind = "rotating" if case in ROTATING_CASES else "static"
    ref, port = _both(lambda pkg: fn(pkg, _chain(pkg, kind)))
    assert port == ref
    assert port[0] == WANT.get(case, "VerificationError")
    if "bad signature at height" in case:
        assert f"at height {case.rsplit(' ', 1)[1]}:" in port[1]
    if case.endswith("at the top"):
        assert f"at height {N_HEADERS}:" in port[1]


def test_adjacent_chain_attributes_the_last_of_three_plain_kernel_eq_chunks(monkeypatch):
    """MIN_TPU_BATCH 8 and _MAX_BUCKET 24: the 11 commits' 66 light-tally
    signatures (6 of 8 validators each) go to the plain kernel_eq in three
    chunks (24, 24, 18); a bad signature in commit 11 (the last chunk)
    fails that chunk alone, kernel_sig attributes it there, and the
    per-commit search names height 11, as the reference does."""
    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 8)
    monkeypatch.setattr(p_V, "_MAX_BUCKET", 24)
    calls = {"kernel_eq": [], "kernel_sig": 0}
    real_eq, real_sig = p_V.kernel_eq, p_V.kernel_sig

    def kernel_eq(*ops):
        out = real_eq(*ops)
        calls["kernel_eq"].append(bool(out[1]))
        return out

    def kernel_sig(*ops):
        calls["kernel_sig"] += 1
        return real_sig(*ops)

    monkeypatch.setattr(p_V, "kernel_eq", kernel_eq)
    monkeypatch.setattr(p_V, "kernel_sig", kernel_sig)
    routes = []
    real_verify = p_batch.AdaptiveBatchVerifier.verify

    def recording_verify(bv):
        out = real_verify(bv)
        routes.append((len(bv._items), bv.last_route))
        return out

    monkeypatch.setattr(p_batch.AdaptiveBatchVerifier, "verify", recording_verify)

    def run(pkg):
        c, _ = _static_chain(pkg, n=12, n_vals=8)
        chain = c[1:10] + [_tamper(pkg, c[10], 2)] + c[11:]
        return pkg.verifier.verify_adjacent_chain(CHAIN, c[0], chain, LONG, NOW, **pkg.kw)

    ref, port = _both(run)
    assert port == ref
    assert port[0] == "VerificationError" and "at height 11:" in port[1]
    assert calls["kernel_eq"] == [True, True, False] and calls["kernel_sig"] == 1
    # the range on the card's route, then the per-commit search on the host
    assert routes[0] == (66, "cuda") and {r for _n, r in routes[1:]} == {"cpu"}


# -- the client --------------------------------------------------------------


def _recording(pkg, inner, forged=None, garbage_from=None):
    """A provider over `inner` that records the evidence reported to it;
    `forged` maps a height to the block it serves there instead, and from
    `garbage_from` on it serves headers whose commit signs another."""

    class Recording(pkg.provider.Provider):
        def __init__(self):
            self.reported = []
            self.fetches = 0

        def __repr__(self):
            return "Recording"

        def chain_id(self):
            return inner.chain_id()

        async def light_block(self, height):
            self.fetches += 1
            if forged and height in forged:
                return forged[height]
            lb = await inner.light_block(height)
            if garbage_from is not None and lb.height >= garbage_from:
                evil = replace(lb.header, app_hash=b"\xbb" * 32)
                return pkg.lt.LightBlock(
                    pkg.lt.SignedHeader(evil, lb.signed_header.commit), lb.validators
                )
            return lb

        async def report_evidence(self, evidence):
            self.reported.append(evidence)

    return Recording()


def _run_client(pkg, kind, target, *, trust_height=1, trust_hash=None, sequential=False,
                now=NOW, period=LONG, witnesses=(), trust_level=None):
    chain = _chain(pkg, kind)
    primary = _recording(pkg, pkg.tt.make_list_provider(chain, CHAIN))
    opts = pkg.client.TrustOptions(
        period, trust_height, trust_hash or chain[trust_height - 1].header.hash()
    )
    kw = dict(sequential=sequential, **pkg.kw)
    if trust_level is not None:
        kw["trust_level"] = trust_level
    client = pkg.client.LightClient(
        CHAIN, opts, primary, [w(pkg, chain) for w in witnesses], **kw
    )

    async def go():
        got = await client.verify_light_block_at_height(target, now)
        again = await client.verify_light_block_at_height(target, now)  # from the store
        assert again.encode() == got.encode()
        return got

    got = _outcome(lambda: asyncio.run(go()))
    stored = [h for h in range(1, len(chain) + 1) if client.store.get(h) is not None]
    return {
        "result": got,
        "stored": stored,
        "latest": _plain(client.store.latest()),
        "lowest": _plain(client.store.lowest()),
        "fetches": primary.fetches,
        "reported": [ev.encode() for ev in primary.reported],
        "witnesses": len(client.witnesses),
    }


def _compare_clients(**kw):
    ref, port = (_run_client(pkg, **kw) for pkg in PKGS)
    assert port == ref
    return port


def test_sequential_client_matches_reference():
    out = _compare_clients(kind="static", target=N_HEADERS, sequential=True)
    assert out["result"][0] == "ok" and out["stored"] == list(range(1, N_HEADERS + 1))


def test_skipping_client_bisects_as_the_reference():
    out = _compare_clients(kind="rotating", target=N_HEADERS)
    assert out["result"][0] == "ok"
    assert 1 < len(out["stored"]) < N_HEADERS  # bisected: some heights, not all


def test_skipping_client_jumps_a_static_set_in_one_step():
    out = _compare_clients(kind="static", target=N_HEADERS)
    assert out["stored"] == [1, N_HEADERS]


def test_sequential_client_across_rotations_matches_reference():
    out = _compare_clients(kind="rotating", target=N_HEADERS, sequential=True)
    assert out["stored"] == list(range(1, N_HEADERS + 1))


def test_backwards_client_matches_reference():
    out = _compare_clients(kind="static", target=3, trust_height=12)
    assert out["result"][0] == "ok" and out["stored"] == list(range(3, 13))


def test_expired_trust_matches_reference():
    out = _compare_clients(kind="static", target=N_HEADERS, period=2 * SEC, sequential=True)
    assert out["result"][0] == "VerificationError" and "expired" in out["result"][1]


def test_wrong_trusted_hash_matches_reference():
    out = _compare_clients(kind="static", target=N_HEADERS, trust_hash=b"\x00" * 32)
    assert out["result"][0] == "VerificationError" and "hash mismatch" in out["result"][1]
    assert out["stored"] == []


def _forging_witness(pkg, chain, height=N_HEADERS - 1):
    """A witness that serves, at `height`, a header with another app hash,
    validly signed by the same keys."""
    keys = _keys(pkg)
    forged = _resign(pkg, chain[height - 1], keys, app_hash=b"\xde\xad" * 16)
    return _recording(pkg, pkg.tt.make_list_provider(chain, CHAIN), forged={height: forged})


def _honest_witness(pkg, chain):
    return _recording(pkg, pkg.tt.make_list_provider(chain, CHAIN))


def _garbage_witness(pkg, chain):
    return _recording(pkg, pkg.tt.make_list_provider(chain, CHAIN), garbage_from=2)


@pytest.mark.parametrize("sequential", [False, True])
def test_divergence_and_its_evidence_match_reference(sequential):
    out = _compare_clients(kind="static", target=N_HEADERS - 1, sequential=sequential,
                           witnesses=[_forging_witness, _honest_witness])
    assert out["result"][0] == "Divergence"
    assert out["stored"] == [1]  # nothing the primary served was kept
    (data,) = out["reported"]
    ev = p_ev.decode_evidence(data)
    assert isinstance(ev, p_ev.LightClientAttackEvidence)
    assert ev.common_height == 1 and ev.conflicting_block.height == N_HEADERS - 1
    assert len(ev.byzantine_validators) == N_VALS  # lunatic: every signer
    assert j_ev.decode_evidence(data).encode() == data


def test_bad_witness_dropped_as_in_the_reference():
    out = _compare_clients(kind="static", target=5, witnesses=[_garbage_witness, _honest_witness])
    assert out["result"][0] == "ok" and out["witnesses"] == 1


def test_every_commit_verification_runs_on_the_clients_device(monkeypatch):
    """initialize's and the cross-check's lazily imported
    verify_commit_light, the windows' verify_commit_range and the skips'
    trusting verification all get the client's device."""
    seen = []
    real_resolve = p_val.resolve

    def resolve(device="cuda"):
        seen.append((sys._getframe(1).f_code.co_name, device))
        return real_resolve(device)

    monkeypatch.setattr(p_val, "resolve", resolve)
    for kw in (dict(kind="static", sequential=True), dict(kind="rotating"),
               dict(kind="static", witnesses=[_forging_witness])):
        _run_client(PORT, target=N_HEADERS - 1, **kw)
    assert {name for name, _ in seen} == {
        "verify_commit_light", "verify_commit_range", "verify_commit_light_trusting"
    }
    assert {dev for _, dev in seen} == {torch.device("cpu")}


# -- providers and retry -----------------------------------------------------


class _Flaky:
    """An inner provider failing its first `fails` calls (a transport
    error), then serving `lb`; height 99 is definitively absent."""

    def __init__(self, pkg, lb, fails):
        self.pkg, self.lb, self.fails, self.calls = pkg, lb, fails, 0

    def __repr__(self):
        return "Flaky"

    def chain_id(self):
        return CHAIN

    async def light_block(self, height):
        self.calls += 1
        if height == 99:
            raise self.pkg.provider.LightBlockNotFoundError("99")
        if self.calls <= self.fails:
            raise ConnectionError(f"drop {self.calls}")
        return self.lb

    async def report_evidence(self, ev):
        pass


def _retrying(pkg, fails, heights):
    inner = _Flaky(pkg, _chain(pkg, "static")[2], fails)
    clock = [0.0]
    breaker = pkg.retry.CircuitBreaker(failure_threshold=2, reset_timeout=5.0,
                                       clock=lambda: clock[0], name="p")
    prov = pkg.provider.RetryingProvider(
        inner, policy=pkg.retry.BackoffPolicy(base=0.0, max_attempts=3), breaker=breaker,
        rng=random.Random(7),
    )
    out = []
    for h in heights:
        if h == "tick":
            clock[0] += 6.0
            continue
        out.append(_outcome(lambda h=h: asyncio.run(prov.light_block(h))))
        out.append((breaker.state, inner.calls))
    return out


@pytest.mark.parametrize("fails", [0, 2, 3, 7])
def test_retrying_provider_matches_reference(fails):
    heights = [3, 99, 3, 3, "tick", 3, 3]
    ref, port = (_retrying(pkg, fails, heights) for pkg in PKGS)
    assert port == ref


def test_retry_primitives_match_reference():
    out = []
    for pkg in PKGS:
        r = pkg.retry
        pol = r.BackoffPolicy(base=0.5, cap=3.0, max_attempts=6)
        sleeps = list(pol.sleeps(random.Random(11)))
        calls = []

        async def failing():
            calls.append(1)
            raise OSError("down")

        exhausted = _outcome(lambda: asyncio.run(
            r.retry(failing, r.BackoffPolicy(base=0.0, max_attempts=4), rng=random.Random(1))))
        give_up = _outcome(lambda: asyncio.run(
            r.retry(failing, r.BackoffPolicy(base=0.0, max_attempts=4), give_up_on=(OSError,))))
        t = [0.0]
        br = r.CircuitBreaker(failure_threshold=2, reset_timeout=1.0, max_reset_timeout=3.0,
                              clock=lambda: t[0])
        states = []
        for step in ("f", "f", "allow", "t1", "allow", "allow", "f", "t1", "allow", "t2",
                     "allow", "s", "allow"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step.startswith("t"):
                t[0] += float(step[1:])
            else:
                states.append(br.allow())
            states.append((br.state, br.opens, br.half_opens))
        guarded = []
        for _ in range(3):
            try:
                with br.guard():
                    raise KeyError("x")
            except (KeyError, r.CircuitOpenError) as e:
                guarded.append(type(e).__name__)
        out.append((sleeps, exhausted, len(calls), give_up, states, guarded))
    assert out[1] == out[0]


def test_block_store_provider_matches_reference():
    """Light blocks served from a kvstore chain's stores (a validator joins
    at height 5, effective at 7): the same bytes at every height, the tip
    at height 0, the same refusal past it, and a client over each
    verifying across the change."""
    from test_torch_chain import (
        build_reference_chain,
        chain_txs,
        fixed_tx_mempool,
        keys_and_joiner,
        reference_genesis,
    )
    from tendermint_tpu_torch.mempool import Mempool as PMempool

    keys, joiner = keys_and_joiner()
    genesis = reference_genesis(keys)
    txs = chain_txs(joiner.pub_key().bytes())
    rstore, rsstore, _conns, _st = asyncio.run(build_reference_chain(genesis, keys + [joiner], txs))
    pstore, psstore, _pconns, _pst = asyncio.run(p_tt.build_kvstore_chain(
        convert.genesis(genesis), keys + [joiner], rstore.height(),
        mempool=fixed_tx_mempool(PMempool, txs), device="cpu"))
    chain_id = genesis.chain_id
    provs = (j_provider.BlockStoreProvider(chain_id, rstore, rsstore),
             p_provider.BlockStoreProvider(chain_id, pstore, psstore))
    tip = rstore.height()
    for h in [*range(1, tip + 1), 0, tip + 1]:
        ref, port = (_outcome(lambda p=p: asyncio.run(p.light_block(h))) for p in provs)
        assert port == ref
        assert ref[0] == ("ok" if h <= tip else "LightBlockNotFoundError")
    results = []
    for pkg, prov in zip(PKGS, provs):
        lb1 = asyncio.run(prov.light_block(1))
        now = asyncio.run(prov.light_block(0)).header.time_ns + SEC
        for sequential in (False, True):
            client = pkg.client.LightClient(
                chain_id, pkg.client.TrustOptions(LONG, 1, lb1.header.hash()), prov,
                sequential=sequential, **pkg.kw)
            got = _outcome(lambda c=client: asyncio.run(c.verify_light_block_at_height(tip, now)))
            results.append((got, [h for h in range(1, tip + 1) if client.store.get(h)]))
        asyncio.run(prov.report_evidence("ev"))
        results.append(prov.reported)
    assert results[3:] == results[:3]
    assert results[0][0][0] == "ok"
