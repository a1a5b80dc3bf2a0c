"""BLS12-381 on the port, on device="cpu" (the kernels' plain versions), held
against the reference package: the pairing path against bls_math, keys and
aggregates byte for byte, aggregate commits through the four verify_commit*
entry points with the reference's verdicts and messages, the hub's scheme
partition, the proof-of-possession gates, and the wire round trip of BLS
validator sets, aggregate commits and genesis docs.

Budget: a check that reaches a pairing runs the plain final exponentiation
(~1,900 dependent Fq12 products, a few seconds here). Five tests reach one;
they share a 4-validator committee built once per module, and every
rejection the reference makes before pairing is tested as such (no pairing
runs).
"""

from dataclasses import replace

import pytest
import torch

from tendermint_tpu import testing as ref_testing
from tendermint_tpu.abci import types as ref_abci
from tendermint_tpu.abci.kvstore import KVStoreApp as RefKVStoreApp
from tendermint_tpu.crypto import bls as ref_bls
from tendermint_tpu.crypto import bls_math as RM
from tendermint_tpu.crypto.tpu import bls_pairing as RP
from tendermint_tpu.state.execution import (
    validator_updates_to_validators as ref_updates_to_validators,
)
from tendermint_tpu.types import block as ref_block
from tendermint_tpu.types import genesis as ref_genesis
from tendermint_tpu.types import validation as ref_validation
from tendermint_tpu.types.params import ConsensusParams as RefParams
from tendermint_tpu.types.params import ValidatorParams as RefValidatorParams
from tendermint_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.kvstore import KVStoreApp
from tendermint_tpu_torch.crypto import bls, pubkey_from_proto, pubkey_to_proto, verify_hub
from tendermint_tpu_torch.crypto import bls_math as M
from tendermint_tpu_torch.crypto.cuda import bls_field as F
from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
from tendermint_tpu_torch.state.execution import validator_updates_to_validators
from tendermint_tpu_torch.types import validation
from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, Commit, aggregate_commit
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.params import ConsensusParams, ValidatorParams
from tendermint_tpu_torch.types.validation import InvalidCommitError
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

torch.set_num_threads(1)

CHAIN = "bls-chain"
CPU = torch.device("cpu")


@pytest.fixture
def pairings(monkeypatch):
    """The (items, pairs) shape of every final exponentiation run."""
    shapes = []
    real = BP._final_exp_plain

    def counted(f):
        shapes.append(tuple(f.shape[:2]))
        return real(f)

    monkeypatch.setattr(BP, "_final_exp_plain", counted)
    return shapes


@pytest.fixture(scope="module")
def committee():
    """A 4-validator BLS set and one commit at height 5 with a nil vote at
    index 2, in both packages (same seeds, so the same keys and bytes)."""
    vals, keys = tt.make_validator_set(4, key_types=("bls12381",))
    rvals, rkeys = ref_testing.make_validator_set(4, key_types=("bls12381",))
    bid, rbid = tt.make_block_id(b"agg"), ref_testing.make_block_id(b"agg")
    nil = frozenset({2})
    commit = tt.make_commit(CHAIN, 5, 0, bid, vals, keys, nil_indices=nil)
    rcommit = ref_testing.make_commit(CHAIN, 5, 0, rbid, rvals, rkeys, nil_indices=nil)
    assert commit.encode() == rcommit.encode()
    return {
        "vals": vals, "keys": keys, "bid": bid, "commit": commit,
        "agg": aggregate_commit(commit, vals),
        "rvals": rvals, "rkeys": rkeys, "rbid": rbid,
        "ragg": ref_block.aggregate_commit(rcommit, rvals),
    }


def _resign(c, *, port: bool, index: int, msg: bytes):
    """The committee's commit aggregated with validator `index`'s signature
    over `msg` instead of its vote (a valid G2 point, the wrong message)."""
    vals, keys, commit = (
        (c["vals"], c["keys"], c["agg"]) if port else (c["rvals"], c["rkeys"], c["ragg"])
    )
    mod = bls if port else ref_bls
    full = tt.make_commit if port else ref_testing.make_commit
    per_sig = full(CHAIN, 5, 0, c["bid"] if port else c["rbid"], vals, keys,
                   nil_indices=frozenset({2}))
    sigs = [cs.signature for cs in per_sig.signatures]
    sigs[index] = keys[vals.validators[index].address].sign(msg)
    return replace(commit, agg_sig=mod.aggregate_signatures(sigs))


def _raises_same(port_call, ref_call) -> str:
    with pytest.raises(ref_validation.InvalidCommitError) as ref_err:
        ref_call()
    with pytest.raises(InvalidCommitError) as err:
        port_call()
    assert str(err.value) == str(ref_err.value)
    return str(err.value)


# -- the pairing path --------------------------------------------------------


def test_pairing_path_matches_bls_math(pairings):
    """Both kernels' plain versions on a (2 items, 2 pairs) bucket: every
    lane's Miller value equals bls_math.miller_loop, item 0 equals
    bls_math.pairing, item 1 (e(-g1, 3 Q) e(3 g1, Q)) multi_pairing = 1."""
    p1, q1 = M.g1_mul(M.G1_GEN, 5), M.hash_to_point_g2(b"pairing-a")
    q2 = M.hash_to_point_g2(b"pairing-b")
    items = [[(p1, q1)], [(M.NEG_G1_GEN, M.g2_mul(q2, 3)), (M.g1_mul(M.G1_GEN, 3), q2)]]
    ok, f12, lanes, n = BP._run(items, 2, 2, CPU)
    assert n == 2 and pairings == [(2, 2)]

    def ints(t):
        return tuple(F.limbs_to_int(t[i, j]) for i in range(6) for j in range(2))

    assert ints(lanes[0, 0]) == RM.miller_loop(p1, RM.prepare_lines(q1))
    assert ints(lanes[0, 1]) == M.F12_ONE  # the pad pair
    for j, (p, q) in enumerate(items[1]):
        assert ints(lanes[1, j]) == RM.miller_loop(p, RM.prepare_lines(q))
    assert ints(f12[0]) == RM.pairing(p1, q1)
    assert ints(f12[1]) == RM.multi_pairing(items[1]) == M.F12_ONE
    assert ok.tolist() == [False, True]


def test_bucket_guard_and_operand_checks():
    for n in (1, 2, 3, 5, 100, 256, 300):
        assert BP.bucket_items(n) == RP.bucket_items(n)
        assert BP.bucket_pairs(n) == RP.bucket_pairs(n)
    item = [(M.G1_GEN, M.G2_GEN)]
    with pytest.raises(ValueError, match="non-bucket"):
        BP.verify_pairs_batch([item], pad_to=3, pair_pad=2, device="cpu")
    with pytest.raises(ValueError, match="non-bucket"):
        BP.verify_pairs_batch([item], pad_to=2, pair_pad=3, device="cpu")
    arrays = [torch.from_numpy(a) for a in BP.prepare_pairing_batch([item], 2, 2)[0]]
    with pytest.raises(ValueError, match="int32"):
        BP.miller(arrays[0].long(), *arrays[1:])
    with pytest.raises(ValueError, match="line arrays"):
        BP.miller(*arrays[:2], arrays[2][:5].contiguous(), *arrays[3:])
    with pytest.raises(ValueError, match="final_exp takes"):
        BP.final_exp(torch.zeros((2, 2, 6, 2, 48), dtype=torch.int32))


# -- keys and aggregates -----------------------------------------------------


def test_keys_pops_and_aggregates_equal_reference():
    seeds = [bytes([i]) * 32 for i in (3, 4, 5)]
    keys = [bls.BLSPrivKey(s) for s in seeds]
    rkeys = [ref_bls.BLSPrivKey(s) for s in seeds]
    sigs = []
    for i, (k, rk) in enumerate(zip(keys, rkeys)):
        msg = b"vote-%d" % i
        assert k.pub_key().bytes() == rk.pub_key().bytes()
        assert k.sign(msg) == rk.sign(msg)
        assert k.pop_prove() == rk.pop_prove()
        assert k.pub_key().pop_verify(k.pop_prove())
        sigs.append(k.sign(msg))
        pub = pubkey_from_proto(pubkey_to_proto(k.pub_key()))
        assert pub == k.pub_key() and pub.TYPE == "bls12381"
    assert keys[0].pub_key().verify_signature(b"vote-0", sigs[0])
    assert not keys[0].pub_key().verify_signature(b"vote-1", sigs[0])
    assert not keys[0].pub_key().pop_verify(keys[1].pop_prove())
    agg = bls.aggregate_signatures(sigs)
    assert agg == ref_bls.aggregate_signatures(sigs)
    pubs, msgs = [k.pub_key() for k in keys], [b"vote-%d" % i for i in range(3)]
    assert bls.aggregate_verify(pubs, msgs, agg)
    assert not bls.aggregate_verify(pubs, msgs[::-1], agg)
    with pytest.raises(ValueError, match="zero signatures"):
        bls.aggregate_signatures([])


def test_aggregate_commit_wire_equals_reference(committee):
    agg, ragg = committee["agg"], committee["ragg"]
    assert agg.encode() == ragg.encode() and agg.hash() == ragg.hash()
    assert Commit.decode(agg.encode()) == agg
    agg.validate_basic()
    assert all(cs.signature == b"" for cs in agg.signatures) and len(agg.agg_sig) == 96


# -- aggregate commits through the entry points ------------------------------


def test_aggregate_commit_entry_points(committee, pairings):
    """The four entry points inside a hub on the CPU: one pairing, then
    the verdict cache; a tampered aggregate (a signer's signature over other
    bytes) fails the pairing in a range at failed_index 1 and under
    verify_commit, with the reference's message."""
    c = committee
    vals, bid, agg = c["vals"], c["bid"], c["agg"]
    rvals, rbid, ragg = c["rvals"], c["rbid"], c["ragg"]
    ref_validation.verify_commit(CHAIN, rvals, rbid, 5, ragg)
    ref_validation.verify_commit_light_trusting(CHAIN, rvals, ragg)
    bad = _resign(c, port=True, index=1, msg=b"other bytes")
    rbad = _resign(c, port=False, index=1, msg=b"other bytes")
    assert bad.encode() == rbad.encode()
    hub = verify_hub.acquire_hub(device="cpu")
    try:
        validation.verify_commit(CHAIN, vals, bid, 5, agg, device="cpu")
        validation.verify_commit_light(CHAIN, vals, bid, 5, agg, device="cpu")
        validation.verify_commit_light_trusting(CHAIN, vals, agg, device="cpu")
        validation.verify_commit_range(CHAIN, [(vals, bid, 5, agg)], device="cpu")
        assert pairings == [(2, 8)] and hub.stats()["cache_hits"] == 3
        with pytest.raises(InvalidCommitError) as err:
            validation.verify_commit_range(
                CHAIN, [(vals, bid, 5, agg), (vals, bid, 5, bad)], device="cpu"
            )
        assert err.value.failed_index == 1
        msg = _raises_same(
            lambda: validation.verify_commit(CHAIN, vals, bid, 5, bad, device="cpu"),
            lambda: ref_validation.verify_commit(CHAIN, rvals, rbid, 5, rbad),
        )
        assert msg == "aggregate signature verification failed" == str(err.value)
        assert pairings == [(2, 8), (2, 8)]
    finally:
        verify_hub.release_hub()
    assert verify_hub.running_hub() is None


def test_absent_signer_forgery_rejected(committee, pairings):
    """An aggregate built without validator 3's signature cannot claim
    index 3 signed (reference test_bls.py's forgery)."""
    c = committee
    out = []
    for port in (True, False):
        vals, keys = (c["vals"], c["keys"]) if port else (c["rvals"], c["rkeys"])
        bid = c["bid"] if port else c["rbid"]
        make = tt.make_commit if port else ref_testing.make_commit
        agg_of = aggregate_commit if port else ref_block.aggregate_commit
        agg = agg_of(make(CHAIN, 5, 0, bid, vals, keys, absent_indices=frozenset({3})), vals)
        sigs = list(agg.signatures)
        sigs[3] = replace(sigs[0], validator_address=vals.validators[3].address)
        out.append((vals, bid, replace(agg, signatures=tuple(sigs))))
    (vals, bid, forged), (rvals, rbid, rforged) = out
    assert forged.encode() == rforged.encode()
    _raises_same(
        lambda: validation.verify_commit(CHAIN, vals, bid, 5, forged, device="cpu"),
        lambda: ref_validation.verify_commit(CHAIN, rvals, rbid, 5, rforged),
    )
    assert pairings == [(2, 8)]


def test_rejections_before_pairing(committee, pairings):
    c = committee
    vals, keys, bid, agg = c["vals"], c["keys"], c["bid"], c["agg"]
    rvals, rkeys, rbid, ragg = c["rvals"], c["rkeys"], c["rbid"], c["ragg"]
    # insufficient power: three of four absent
    absent = frozenset({1, 2, 3})
    low = aggregate_commit(tt.make_commit(CHAIN, 5, 0, bid, vals, keys, absent_indices=absent), vals)
    rlow = ref_block.aggregate_commit(
        ref_testing.make_commit(CHAIN, 5, 0, rbid, rvals, rkeys, absent_indices=absent), rvals
    )
    msg = _raises_same(
        lambda: validation.verify_commit(CHAIN, vals, bid, 5, low, device="cpu"),
        lambda: ref_validation.verify_commit(CHAIN, rvals, rbid, 5, rlow),
    )
    assert msg.startswith("insufficient voting power")
    # a non-BLS key in an included slot
    ed_vals, _ = tt.make_validator_set(4, seed=b"other")
    red_vals, _ = ref_testing.make_validator_set(4, seed=b"other")
    msg = _raises_same(
        lambda: validation.verify_commit(CHAIN, ed_vals, bid, 5, agg, device="cpu"),
        lambda: ref_validation.verify_commit(CHAIN, red_vals, rbid, 5, ragg),
    )
    assert "non-BLS signer" in msg
    # trusting: a signer the trusted set does not know
    trusted = ValidatorSet([Validator(v.pub_key, v.voting_power) for v in vals.validators[:3]])
    rtrusted = RefValidatorSet(
        [type(v)(v.pub_key, v.voting_power) for v in rvals.validators[:3]]
    )
    msg = _raises_same(
        lambda: validation.verify_commit_light_trusting(CHAIN, trusted, agg, device="cpu"),
        lambda: ref_validation.verify_commit_light_trusting(CHAIN, rtrusted, ragg),
    )
    assert "unknown to the trusted validator set" in msg
    # a per-validator signature smuggled into the aggregate form
    sig0 = c["commit"].signatures[0].signature
    smuggled = replace(agg, signatures=(replace(agg.signatures[0], signature=sig0),)
                       + agg.signatures[1:])
    rsmuggled = replace(ragg, signatures=(replace(ragg.signatures[0], signature=sig0),)
                        + ragg.signatures[1:])
    msg = _raises_same(
        lambda: validation.verify_commit(CHAIN, vals, bid, 5, smuggled, device="cpu"),
        lambda: ref_validation.verify_commit(CHAIN, rvals, rbid, 5, rsmuggled),
    )
    assert "per-validator signature" in msg
    # aggregation itself refuses a non-BLS signer
    mixed, mkeys = tt.make_validator_set(2, key_types=("bls12381", "ed25519"))
    with pytest.raises(ValueError, match="not bls12381"):
        aggregate_commit(tt.make_commit(CHAIN, 9, 0, bid, mixed, mkeys), mixed)
    assert pairings == []


def test_hub_partitions_mixed_per_signature_batch(pairings):
    """A mixed batch in one hub dispatch: the two ed25519 signatures take
    the "edwards" partition (on the host, below the cutoff), the two
    bls12381 ones the "bls" partition (one (2, 2) pairing batch); a BLS
    signature over other bytes is False, as the reference's verify says."""
    vals, keys = tt.make_validator_set(4, key_types=("bls12381", "ed25519"))
    bid = tt.make_block_id(b"hubmix")
    commit = tt.make_commit(CHAIN, 8, 0, bid, vals, keys)
    items = [
        (vals.get_by_index(i).pub_key, commit.vote_sign_bytes(CHAIN, i), cs.signature)
        for i, cs in enumerate(commit.signatures)
    ]
    bls_at = [i for i, (pk, _m, _s) in enumerate(items) if pk.TYPE == "bls12381"]
    pk, msg, _sig = items[bls_at[1]]
    items[bls_at[1]] = (pk, msg, keys[pk.address()].sign(b"other bytes"))
    want = [
        ref_bls.BLSPubKey(pk.bytes()).verify_signature(m, s) if pk.TYPE == "bls12381"
        else pk.verify_signature(m, s)
        for pk, m, s in items
    ]
    assert want == [i != bls_at[1] for i in range(4)]
    hub = verify_hub.acquire_hub(device="cpu", window_ms=1.0)
    try:
        assert hub.verify_many(items) == want
        stats = hub.stats()
    finally:
        verify_hub.release_hub()
    assert (stats["dispatches"], stats["scheme_bls_sigs"], stats["scheme_edwards_sigs"]) == (1, 2, 2)
    assert pairings == [(2, 2)]


# -- proof-of-possession gates -----------------------------------------------


def test_genesis_pop_gate():
    k = bls.BLSPrivKey(b"\x66" * 32)
    doc = GenesisDoc(chain_id=CHAIN, validators=[GenesisValidator(k.pub_key(), 10, "v0",
                                                                   pop=k.pop_prove())])
    doc.validate_basic()
    assert len(doc.validator_set()) == 1
    rk = ref_bls.BLSPrivKey(b"\x66" * 32)
    rogue_pop = bls.BLSPrivKey(b"\x67" * 32).pop_prove()
    for pop, match in ((b"", "missing proof of possession"),
                       (rogue_pop, "invalid proof of possession")):
        with pytest.raises(ValueError, match=match) as err:
            GenesisDoc(chain_id=CHAIN, validators=[GenesisValidator(k.pub_key(), 10, "v0",
                                                                    pop=pop)]).validate_basic()
        with pytest.raises(ValueError) as ref_err:
            ref_genesis.GenesisDoc(chain_id=CHAIN, validators=[
                ref_genesis.GenesisValidator(rk.pub_key(), 10, "v0", pop=pop)]).validate_basic()
        assert str(err.value) == str(ref_err.value)


def test_executor_and_kvstore_pop_gates():
    k = bls.BLSPrivKey(b"\x69" * 32)
    pub, pop = k.pub_key().bytes(), k.pop_prove()
    rogue = bls.BLSPrivKey(b"\x6a" * 32).pop_prove()
    params = ConsensusParams(validator=ValidatorParams(pub_key_types=("ed25519", "bls12381")))
    rparams = RefParams(validator=RefValidatorParams(pub_key_types=("ed25519", "bls12381")))
    out = validator_updates_to_validators((abci.ValidatorUpdate("bls12381", pub, 10, pop),), params)
    assert out[0].pub_key == k.pub_key()
    assert validator_updates_to_validators(
        (abci.ValidatorUpdate("bls12381", pub, 0),), params)[0].voting_power == 0
    for bad in (b"", rogue):
        with pytest.raises(ValueError, match="proof of possession") as err:
            validator_updates_to_validators((abci.ValidatorUpdate("bls12381", pub, 10, bad),), params)
        with pytest.raises(ValueError) as ref_err:
            ref_updates_to_validators((ref_abci.ValidatorUpdate("bls12381", pub, 10, bad),), rparams)
        assert str(err.value) == str(ref_err.value)
    tx = b"val:bls12381:" + pub.hex().encode() + b"!10!" + pop.hex().encode()
    assert KVStoreApp._parse_validator_tx(tx) == abci.ValidatorUpdate("bls12381", pub, 10, pop)
    assert RefKVStoreApp._parse_validator_tx(tx).encode() == abci.ValidatorUpdate(
        "bls12381", pub, 10, pop).encode()
    for bad_tx in (b"val:bls12381:" + pub.hex().encode() + b"!10",
                   b"val:bls12381:" + pub.hex().encode() + b"!10!" + rogue.hex().encode()):
        with pytest.raises(ValueError, match="proof of possession") as err:
            KVStoreApp._parse_validator_tx(bad_tx)
        with pytest.raises(ValueError) as ref_err:
            RefKVStoreApp._parse_validator_tx(bad_tx)
        assert str(err.value) == str(ref_err.value)


# -- the wire, both ways -----------------------------------------------------


def test_convert_round_trips_bls_sets_aggregates_and_genesis(committee):
    c = committee
    vals = convert.valset(c["rvals"])
    assert vals.encode() == c["vals"].encode()
    assert convert.to_reference(vals, RefValidatorSet).encode() == c["rvals"].encode()
    agg = convert.commit(c["ragg"])
    assert agg == c["agg"]
    assert convert.to_reference(agg, ref_block.Commit).encode() == c["ragg"].encode()
    rkeys = [ref_bls.BLSPrivKey(bytes([i]) * 32) for i in (7, 8)]
    rdoc = ref_genesis.GenesisDoc(chain_id=CHAIN, validators=[
        ref_genesis.GenesisValidator(k.pub_key(), 10, f"v{i}", pop=k.pop_prove())
        for i, k in enumerate(rkeys)
    ])
    doc = convert.genesis(rdoc)
    doc.validate_basic()
    assert [gv.pop for gv in doc.validators] == [gv.pop for gv in rdoc.validators]
    assert doc.validator_set().encode() == rdoc.validator_set().encode()
    back = convert.to_reference(doc, ref_genesis.GenesisDoc)
    assert back.to_json() == rdoc.to_json()
