"""The port's trusting verification and LightClientAttackEvidence against
the JAX package's, on the CPU.

`verify_commit_light_trusting` (validators looked up by address in the
trusted set, `trust_level` of its power): same verdicts and error
messages for rotated sets, a double vote, unknown signers, the trust
level's bounds, a bad signature, and a mixed ed25519 + secp256k1 set
(the one-by-one path); the index-lookup entry points keep their verdicts
on a commit whose addresses the trusted lookup would skip.
`LightClientAttackEvidence`: the lunatic, equivocation and amnesia
attributions, the encoding (both ways across the packages), hashes,
`decode_evidence` and `validate_basic` errors, and the light blocks'
`validate_basic` errors. Every block is built in both packages from the
same keys (bytes compared); the port runs on device="cpu". The tolerance
is zero (bytes, integers, messages)."""

from __future__ import annotations

import types
from dataclasses import replace
from fractions import Fraction

import pytest
import torch

import tendermint_tpu.crypto.hashes as j_hashes
import tendermint_tpu.light.types as j_ltypes
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.block as j_block
import tendermint_tpu.types.evidence as j_ev
import tendermint_tpu.types.validation as j_val
import tendermint_tpu.types.validator_set as j_vs
import tendermint_tpu_torch.crypto.hashes as p_hashes
import tendermint_tpu_torch.light.types as p_ltypes
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.block as p_block
import tendermint_tpu_torch.types.evidence as p_ev
import tendermint_tpu_torch.types.validation as p_val
import tendermint_tpu_torch.types.validator_set as p_vs
from tendermint_tpu.types.keys import SignedMsgType
from tendermint_tpu.types.vote import Vote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as p_batch

# the plain kernel_eq runs on small tensors: one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CHAIN = "lc-port-chain"
TS = 1_700_000_000_000_000_000

REF = types.SimpleNamespace(
    tt=j_tt, val=j_val, vs=j_vs, ev=j_ev, lt=j_ltypes, block=j_block, sha=j_hashes.sha256,
    kw={},
)
PORT = types.SimpleNamespace(
    tt=p_tt, val=p_val, vs=p_vs, ev=p_ev, lt=p_ltypes, block=p_block, sha=p_hashes.sha256,
    kw={"device": "cpu"},
)
PKGS = (REF, PORT)


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is compared, not judged
        return type(e).__name__, str(e)
    return "ok", out


def _both(fn):
    """fn(pkg) in each package: (reference outcome, port outcome)."""
    return tuple(_outcome(lambda pkg=pkg: fn(pkg)) for pkg in PKGS)


def _header(pkg, vals, height=10, **fields):
    b = pkg.block
    kw = dict(
        chain_id=CHAIN,
        height=height,
        time_ns=TS,
        last_block_id=b.BlockID(pkg.sha(b"prev"), b.PartSetHeader(1, pkg.sha(b"pp"))),
        last_commit_hash=pkg.sha(b"lc"),
        data_hash=b"\x02" * 32,
        validators_hash=vals.hash(),
        next_validators_hash=vals.hash(),
        consensus_hash=pkg.sha(b"consensus"),
        app_hash=b"\x01" * 32,
        last_results_hash=pkg.sha(b"results"),
        evidence_hash=b"",
        proposer_address=vals.validators[0].address,
    )
    kw.update(fields)
    return b.Header(**kw)


def _signed(pkg, vals, keys, header, round_=0):
    b = pkg.block
    bid = b.BlockID(header.hash(), b.PartSetHeader(1, pkg.sha(b"parts")))
    commit = pkg.tt.make_commit(CHAIN, header.height, round_, bid, vals, keys)
    return pkg.lt.LightBlock(pkg.lt.SignedHeader(header, commit), vals)


def _window_set(pkg, lo, hi):
    """Validators lo..hi-1 of one deterministic key list (power 10 each):
    two windows share exactly the validators their ranges share."""
    keys = pkg.tt.det_priv_keys(hi)[lo:]
    vals = pkg.vs.ValidatorSet([pkg.vs.Validator(k.pub_key(), 10) for k in keys])
    return vals, {k.pub_key().address(): k for k in keys}


# -- verify_commit_light_trusting ------------------------------------------


def _commit_by(pkg, signer_window, height=10):
    vals, keys = _window_set(pkg, *signer_window)
    lb = _signed(pkg, vals, keys, _header(pkg, vals, height))
    return lb.signed_header.commit


TRUSTING_CASES = {
    # (trusted window, signing window, trust level)
    "same set": ((0, 4), (0, 4), Fraction(1, 3)),
    "rotated, 2 of 4 shared": ((0, 4), (2, 6), Fraction(1, 3)),
    "rotated, 1 of 4 shared": ((0, 4), (3, 7), Fraction(1, 3)),
    "disjoint": ((0, 4), (4, 8), Fraction(1, 3)),
    "rotated, 2 of 4 shared, level 2/3": ((0, 4), (2, 6), Fraction(2, 3)),
    # the tally must exceed trust_level of the power: at 1 nothing passes
    "same set, level 1": ((0, 4), (0, 4), Fraction(1, 1)),
    "bigger signing set": ((0, 4), (0, 8), Fraction(1, 3)),
    "level 1/4": ((0, 4), (0, 4), Fraction(1, 4)),
    "level 4/3": ((0, 4), (0, 4), Fraction(4, 3)),
}


@pytest.mark.parametrize("case", sorted(TRUSTING_CASES))
def test_trusting_verdicts_match_reference(case):
    trusted_w, signing_w, level = TRUSTING_CASES[case]

    def run(pkg):
        trusted, _ = _window_set(pkg, *trusted_w)
        pkg.val.verify_commit_light_trusting(
            CHAIN, trusted, _commit_by(pkg, signing_w), level, **pkg.kw
        )

    ref, port = _both(run)
    assert port == ref
    want = {
        "same set": "ok", "rotated, 2 of 4 shared": "ok", "bigger signing set": "ok",
        "same set, level 1": "InvalidCommitError", "rotated, 1 of 4 shared": "InvalidCommitError",
        "disjoint": "InvalidCommitError", "rotated, 2 of 4 shared, level 2/3": "InvalidCommitError",
        "level 1/4": "ValueError", "level 4/3": "ValueError",
    }[case]
    assert port[0] == want


def _double_vote(pkg):
    """A commit of the 4-set whose slot 1 repeats slot 0's signature (same
    validator address twice, before the tally reaches the trust level)."""
    commit = _commit_by(pkg, (0, 4))
    sigs = list(commit.signatures)
    sigs[1] = sigs[0]
    return replace(commit, signatures=tuple(sigs))


def _tampered(pkg, slot=1):
    commit = _commit_by(pkg, (0, 4))
    sigs = list(commit.signatures)
    s = sigs[slot].signature
    sigs[slot] = replace(sigs[slot], signature=s[:7] + bytes([s[7] ^ 4]) + s[8:])
    return replace(commit, signatures=tuple(sigs))


def _unknown_signer(pkg):
    """Slot 0 claims the address of a validator outside the set; its
    signature is the real slot-0 signature (sign bytes hold no address)."""
    commit = _commit_by(pkg, (0, 4))
    outsider, _ = _window_set(pkg, 9, 10)
    sigs = list(commit.signatures)
    sigs[0] = replace(sigs[0], validator_address=outsider.validators[0].address)
    return replace(commit, signatures=tuple(sigs))


@pytest.mark.parametrize("build", [_double_vote, _tampered, _unknown_signer])
def test_trusting_address_lookup_matches_reference(build):
    def trusting(pkg):
        trusted, _ = _window_set(pkg, 0, 4)
        pkg.val.verify_commit_light_trusting(CHAIN, trusted, build(pkg), **pkg.kw)

    ref, port = _both(trusting)
    assert port == ref
    if build is _double_vote:
        assert port == ("InvalidCommitError", "double vote from same address")
    if build is _tampered:
        assert port == ("InvalidCommitError", "invalid signature at index 1")


@pytest.mark.parametrize("entry", ["verify_commit", "verify_commit_light", "verify_commit_range"])
@pytest.mark.parametrize("build", [_double_vote, _unknown_signer])
def test_index_lookup_entry_points_unchanged(entry, build):
    """verify_commit, verify_commit_light and verify_commit_range look
    validators up by index, as before: a repeated or foreign address is
    not what they check."""

    def run(pkg):
        vals, _ = _window_set(pkg, 0, 4)
        commit = build(pkg)
        if entry == "verify_commit_range":
            pkg.val.verify_commit_range(CHAIN, [(vals, commit.block_id, 10, commit)], **pkg.kw)
        else:
            getattr(pkg.val, entry)(CHAIN, vals, commit.block_id, 10, commit, **pkg.kw)

    ref, port = _both(run)
    assert port == ref


def test_trusting_on_a_mixed_set_matches_reference():
    """ed25519 + secp256k1: no batch, every signature through verify_one
    with address lookup. The reference's commit is carried across."""
    rvals, rkeys = j_tt.make_validator_set(4, key_types=("ed25519", "secp256k1"))
    rlb = _signed(REF, rvals, rkeys, _header(REF, rvals))
    rc = rlb.signed_header.commit
    pvals, pc = convert.valset(rvals), convert.commit(rc)
    assert pc.encode() == rc.encode()
    for level in (Fraction(1, 3), Fraction(2, 3)):
        want = _outcome(lambda: j_val.verify_commit_light_trusting(CHAIN, rvals, rc, level))
        got = _outcome(
            lambda: p_val.verify_commit_light_trusting(CHAIN, pvals, pc, level, device="cpu")
        )
        assert got == want == ("ok", None)


def test_trusting_reaches_the_plain_kernel_eq_below_a_lowered_cutoff(monkeypatch):
    """With MIN_TPU_BATCH at 2 the trusted tally's signatures go through
    the plain kernel_eq (route "cuda"), with the reference's verdicts."""
    routes = []
    real_verify = p_batch.AdaptiveBatchVerifier.verify

    def recording_verify(bv):
        out = real_verify(bv)
        routes.append(bv.last_route)
        return out

    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 2)
    monkeypatch.setattr(p_batch.AdaptiveBatchVerifier, "verify", recording_verify)
    for build in (lambda pkg: _commit_by(pkg, (2, 6)), _tampered):
        def run(pkg, build=build):
            trusted, _ = _window_set(pkg, 0, 4)
            pkg.val.verify_commit_light_trusting(CHAIN, trusted, build(pkg), **pkg.kw)

        ref, port = _both(run)
        assert port == ref
    assert routes == ["cuda", "cuda"]


# -- LightClientAttackEvidence ---------------------------------------------


def _net(pkg):
    vals, keys = pkg.tt.make_validator_set(4)
    return vals, keys, _signed(pkg, vals, keys, _header(pkg, vals))


def _evidence(pkg, conflicting, vals, byz=(), common_height=5, tvp=None):
    return pkg.ev.LightClientAttackEvidence(
        conflicting_block=conflicting,
        common_height=common_height,
        byzantine_validators=tuple(byz),
        total_voting_power=vals.total_voting_power() if tvp is None else tvp,
        timestamp_ns=TS,
    )


def _attack(pkg, kind):
    """(evidence, common validator set, trusted signed header) for one
    attack kind."""
    vals, keys, trusted = _net(pkg)
    if kind == "lunatic":
        conflicting = _signed(pkg, vals, keys, _header(pkg, vals, app_hash=b"\xff" * 32))
    elif kind == "lunatic, other set":
        ovals, okeys = pkg.tt.make_validator_set(4, seed=b"other")
        conflicting = _signed(pkg, ovals, okeys, _header(pkg, ovals, app_hash=b"\xff" * 32))
        return _evidence(pkg, conflicting, ovals), vals, trusted.signed_header
    elif kind == "equivocation":
        conflicting = _signed(pkg, vals, keys, _header(pkg, vals, data_hash=b"\xaa" * 32))
    elif kind == "amnesia":
        conflicting = _signed(pkg, vals, keys, _header(pkg, vals, data_hash=b"\xaa" * 32), 1)
    elif kind == "equivocation, partial":
        # the conflicting commit lacks slot 2's signature
        conflicting = _signed(pkg, vals, keys, _header(pkg, vals, data_hash=b"\xaa" * 32))
        commit = conflicting.signed_header.commit
        sigs = list(commit.signatures)
        sigs[2] = pkg.block.CommitSig.absent()
        conflicting = pkg.lt.LightBlock(
            pkg.lt.SignedHeader(conflicting.header, replace(commit, signatures=tuple(sigs))),
            vals,
        )
    return _evidence(pkg, conflicting, vals), vals, trusted.signed_header


ATTACKS = ["amnesia", "equivocation", "equivocation, partial", "lunatic", "lunatic, other set"]


@pytest.mark.parametrize("kind", ATTACKS)
def test_attribution_matches_reference(kind):
    out = []
    for pkg in PKGS:
        ev, vals, trusted_sh = _attack(pkg, kind)
        byz = ev.get_byzantine_validators(vals, trusted_sh)
        out.append((
            ev.conflicting_header_is_invalid(trusted_sh.header),
            [(v.address, v.voting_power) for v in byz],
            ev.hash(),
            ev.encode(),
        ))
    assert out[1] == out[0]
    n_byz = {"amnesia": 0, "equivocation": 4, "equivocation, partial": 3, "lunatic": 4,
             "lunatic, other set": 0}[kind]
    assert len(out[1][1]) == n_byz


@pytest.mark.parametrize("kind", ATTACKS)
def test_evidence_bytes_cross_both_ways(kind):
    """The reference's evidence decodes in the port and back to the same
    bytes; the port's decodes in the reference likewise; hashes agree."""
    rev, rvals, rsh = _attack(REF, kind)
    rev = replace(rev, byzantine_validators=tuple(rev.get_byzantine_validators(rvals, rsh)))
    pev = convert.evidence(rev)
    assert isinstance(pev, p_ev.LightClientAttackEvidence)
    assert pev.encode() == rev.encode()
    assert pev.hash() == rev.hash()
    assert (pev.height, pev.conflicting_height) == (rev.height, rev.conflicting_height)
    back = convert.evidence_to(pev, j_ev.decode_evidence)
    assert isinstance(back, j_ev.LightClientAttackEvidence)
    assert back.encode() == rev.encode() and back.hash() == rev.hash()
    pev.validate_basic()
    # the port's own evidence, carried to the reference
    own, pvals, psh = _attack(PORT, kind)
    own = replace(own, byzantine_validators=tuple(own.get_byzantine_validators(pvals, psh)))
    assert own.encode() == rev.encode()
    assert convert.evidence_to(own, j_ev.decode_evidence).encode() == own.encode()
    assert p_ev.evidence_hash((own,)) == j_ev.evidence_hash((rev,))


def test_hash_ignores_attribution():
    for pkg in PKGS:
        ev, vals, _ = _attack(pkg, "lunatic")
        assert ev.hash() == replace(ev, byzantine_validators=tuple(vals.validators[:1])).hash()
    assert _attack(PORT, "lunatic")[0].hash() == _attack(REF, "lunatic")[0].hash()


def test_duplicate_vote_and_mixed_evidence_list_cross():
    """decode_evidence still takes DuplicateVoteEvidence, and a list
    holding both kinds hashes alike in both packages."""
    rvals, rkeys = j_tt.make_validator_set(4)
    key = rkeys[rvals.validators[0].address]
    votes = []
    for tag in (b"a", b"b"):
        bid = j_tt.make_block_id(tag)
        v = Vote(SignedMsgType.PRECOMMIT, 10, 0, bid, TS, rvals.validators[0].address, 0)
        votes.append(replace(v, signature=key.sign(v.sign_bytes(CHAIN))))
    dve = j_ev.DuplicateVoteEvidence.from_votes(votes[0], votes[1], TS, rvals)
    lca, _, _ = _attack(REF, "lunatic")
    pdve, plca = convert.evidence(dve), convert.evidence(lca)
    assert isinstance(pdve, p_ev.DuplicateVoteEvidence)
    assert pdve.encode() == dve.encode()
    assert p_ev.evidence_hash((pdve, plca)) == j_ev.evidence_hash((dve, lca))


def _bad_evidence(pkg, what):
    vals, keys, _ = _net(pkg)
    conflicting = _signed(pkg, vals, keys, _header(pkg, vals, app_hash=b"\xff" * 32))
    if what == "no conflicting block":
        return _evidence(pkg, None, vals)
    if what == "no signed header":
        return _evidence(pkg, pkg.lt.LightBlock(None, vals), vals)
    if what == "no validator set":
        return _evidence(pkg, pkg.lt.LightBlock(conflicting.signed_header, None), vals)
    if what == "common height 0":
        return _evidence(pkg, conflicting, vals, common_height=0)
    if what == "common height beyond":
        return _evidence(pkg, conflicting, vals, common_height=conflicting.height + 1)
    if what == "no voting power":
        return _evidence(pkg, conflicting, vals, tvp=0)
    return _evidence(pkg, conflicting, vals)


BAD_EVIDENCE = ["common height 0", "common height beyond", "no conflicting block",
                "no signed header", "no validator set", "no voting power", "valid"]


@pytest.mark.parametrize("what", BAD_EVIDENCE)
def test_evidence_validate_basic_matches_reference(what):
    ref, port = _both(lambda pkg: _bad_evidence(pkg, what).validate_basic())
    assert port == ref
    assert port[0] == ("ok" if what == "valid" else "ValueError")


def test_decode_evidence_refuses_what_the_reference_refuses():
    for data in (b"", b"\x08\x07", b"\x12\x00"):
        ref, port = (_outcome(lambda m=m: m.decode_evidence(data)) for m in (j_ev, p_ev))
        assert port[0] == ref[0] != "ok"


# -- light blocks ----------------------------------------------------------


def _bad_light_block(pkg, what):
    vals, keys, lb = _net(pkg)
    sh = lb.signed_header
    if what == "wrong chain id":
        return lb, "other-chain"
    if what == "commit height":
        return pkg.lt.LightBlock(
            pkg.lt.SignedHeader(sh.header, replace(sh.commit, height=9)), vals
        ), CHAIN
    if what == "commit for another header":
        other = _signed(pkg, vals, keys, _header(pkg, vals, data_hash=b"\x09" * 32))
        return pkg.lt.LightBlock(
            pkg.lt.SignedHeader(sh.header, other.signed_header.commit), vals
        ), CHAIN
    if what == "validators hash":
        ovals, _ = pkg.tt.make_validator_set(4, seed=b"other")
        return pkg.lt.LightBlock(sh, ovals), CHAIN
    if what == "no validators":
        return pkg.lt.LightBlock(sh, None), CHAIN
    if what == "no commit":
        return pkg.lt.LightBlock(pkg.lt.SignedHeader(sh.header, None), vals), CHAIN
    return lb, CHAIN


BAD_LIGHT_BLOCKS = ["commit for another header", "commit height", "no commit",
                    "no validators", "valid", "validators hash", "wrong chain id"]


@pytest.mark.parametrize("what", BAD_LIGHT_BLOCKS)
def test_light_block_validate_basic_matches_reference(what):
    def run(pkg):
        lb, chain_id = _bad_light_block(pkg, what)
        lb.validate_basic(chain_id)
        return lb.encode(), lb.signed_header.encode()

    ref, port = _both(run)
    assert port == ref
    assert port[0] == ("ok" if what == "valid" else "ValueError")


def test_light_block_bytes_cross():
    rlb, plb = _net(REF)[2], _net(PORT)[2]
    assert plb.encode() == rlb.encode()
    assert convert.light_block(rlb).encode() == rlb.encode()
    assert convert.signed_header(rlb.signed_header).encode() == rlb.signed_header.encode()
    assert p_ltypes.LightBlock.decode(rlb.encode()).header.hash() == rlb.header.hash()
