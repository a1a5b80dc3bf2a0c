"""The port's consensus types against the JAX package's, on the CPU:
`Proposal` and `Vote` (types/vote.py), `VoteSet` (types/vote_set.py), the
round state's `HeightVoteSet` (consensus/types.py), the ticker, the
per-peer `PeerState`, the private validators (privval.py), every message
frame (consensus/messages.py) and the WAL (consensus/wal.py).

Each scenario runs the same script in both packages on the same seeded
keys and compares what comes out: encodings and sign-bytes, add results
and errors, majorities, `pol_info`, commits, bit arrays, signatures,
files. The tolerance is zero (bytes, verdicts, error types)."""

from __future__ import annotations

import asyncio
import os
import types

import pytest

import tendermint_tpu.consensus.messages as j_m
import tendermint_tpu.consensus.peer_state as j_ps
import tendermint_tpu.consensus.ticker as j_ticker
import tendermint_tpu.consensus.types as j_ctypes
import tendermint_tpu.consensus.wal as j_wal
import tendermint_tpu.libs.bits as j_bits
import tendermint_tpu.privval as j_pv
import tendermint_tpu.testing as j_tt
import tendermint_tpu.types.block as j_block
import tendermint_tpu.types.keys as j_keys
import tendermint_tpu.types.part_set as j_parts
import tendermint_tpu.types.vote as j_vote
import tendermint_tpu.types.vote_set as j_vs
import tendermint_tpu_torch.consensus.messages as p_m
import tendermint_tpu_torch.consensus.peer_state as p_ps
import tendermint_tpu_torch.consensus.ticker as p_ticker
import tendermint_tpu_torch.consensus.types as p_ctypes
import tendermint_tpu_torch.consensus.wal as p_wal
import tendermint_tpu_torch.libs.bits as p_bits
import tendermint_tpu_torch.privval as p_pv
import tendermint_tpu_torch.testing as p_tt
import tendermint_tpu_torch.types.block as p_block
import tendermint_tpu_torch.types.keys as p_keys
import tendermint_tpu_torch.types.part_set as p_parts
import tendermint_tpu_torch.types.vote as p_vote
import tendermint_tpu_torch.types.vote_set as p_vs
from tendermint_tpu_torch import convert

CHAIN = "cs-types-chain"
N_VALS = 4
TS = 1_700_000_000_000_000_000

REF = types.SimpleNamespace(
    m=j_m, ps=j_ps, ticker=j_ticker, ctypes=j_ctypes, wal=j_wal, bits=j_bits, pv=j_pv,
    tt=j_tt, block=j_block, keys=j_keys, parts=j_parts, vote=j_vote, vs=j_vs,
)
PORT = types.SimpleNamespace(
    m=p_m, ps=p_ps, ticker=p_ticker, ctypes=p_ctypes, wal=p_wal, bits=p_bits, pv=p_pv,
    tt=p_tt, block=p_block, keys=p_keys, parts=p_parts, vote=p_vote, vs=p_vs,
)
PKGS = (REF, PORT)


def _valset(pkg):
    vals, keys = pkg.tt.make_validator_set(N_VALS)
    return vals, [keys[v.address] for v in vals.validators]


def _bid(pkg, tag: bytes):
    return pkg.tt.make_block_id(tag)


def _vote(pkg, vals, keys, idx, *, round_=0, type_=None, tag=b"blk", nil=False, ts=0):
    type_ = type_ if type_ is not None else pkg.keys.SignedMsgType.PREVOTE
    bid = pkg.block.NIL_BLOCK_ID if nil else _bid(pkg, tag)
    return pkg.tt.make_vote(CHAIN, keys[idx], idx, 1, round_, type_, bid, TS + ts)


def _outcome(fn):
    """(result, None) or (None, exception class name)."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return None, type(e).__name__


def _msgs(pkg):
    """One of every consensus message type, with the same fields in both
    packages."""
    vals, keys = _valset(pkg)
    T = pkg.keys.SignedMsgType
    bid = _bid(pkg, b"msg")
    vote = _vote(pkg, vals, keys, 1, round_=2, type_=T.PRECOMMIT, tag=b"msg")
    nil_vote = _vote(pkg, vals, keys, 3, round_=2, nil=True)
    ba = pkg.bits.BitArray.from_indices(8, [1, 5])
    proposal = pkg.vote.Proposal(4, 2, 1, bid, TS + 7, b"\x05" * 64)
    block = convert.block(_ref_block()) if pkg is PORT else _ref_block()
    part = block.make_part_set().get_part(0)
    m = pkg.m
    return [
        m.NewRoundStepMessage(4, 2, 3, 17, -1),
        m.NewRoundStepMessage(1, 0, 1, 0, 0),
        m.NewValidBlockMessage(4, 2, (3, b"\x01" * 32), ba, True),
        m.ProposalMessage(proposal),
        m.ProposalPOLMessage(4, 1, ba),
        m.BlockPartMessage(1, 0, part),
        m.VoteMessage(vote),
        m.VoteMessage(nil_vote),
        m.VoteBatchMessage((vote, nil_vote)),
        m.HasVoteMessage(4, 2, T.PREVOTE, 1),
        m.HasVoteBatchMessage((m.HasVoteMessage(4, 2, T.PREVOTE, 1),
                               m.HasVoteMessage(4, 2, T.PRECOMMIT, 3))),
        m.VoteSetMaj23Message(4, 2, T.PREVOTE, bid),
        m.VoteSetBitsMessage(4, 2, T.PRECOMMIT, bid, ba),
    ]


_BLOCK = []


def _ref_block():
    """A real block (the reference's chain of 4 validators, height 2) for
    the BlockPart frames."""
    if not _BLOCK:
        bstore, _ss, _conns, _genesis, _by_addr = asyncio.run(
            j_tt.build_kvstore_chain(2, N_VALS, CHAIN))
        _BLOCK.append(bstore.load_block(2))
    return _BLOCK[0]


# -- votes and proposals -------------------------------------------------------


def test_vote_and_proposal_bytes_equal_the_reference():
    out = []
    for pkg in PKGS:
        vals, keys = _valset(pkg)
        T = pkg.keys.SignedMsgType
        rows = []
        for idx in range(N_VALS):
            for type_ in (T.PREVOTE, T.PRECOMMIT):
                v = _vote(pkg, vals, keys, idx, round_=idx, type_=type_, nil=idx == 2, ts=idx)
                rows.append((v.encode(), v.sign_bytes(CHAIN), v.signature,
                             pkg.vote.Vote.decode(v.encode()) == v))
        for pol in (-1, 0, 2):
            p = pkg.vote.Proposal(5, 3, pol, _bid(pkg, b"prop"), TS + pol, b"")
            sig = keys[0].sign(p.sign_bytes(CHAIN))
            p = pkg.vote.Proposal(5, 3, pol, p.block_id, p.timestamp_ns, sig)
            rows.append((p.encode(), p.sign_bytes(CHAIN), sig,
                         pkg.vote.Proposal.decode(p.encode()) == p))
            rows.append(_outcome(p.validate_basic))
        bad = pkg.vote.Proposal(5, 3, 3, _bid(pkg, b"prop"), TS, b"\x01")
        rows.append(_outcome(bad.validate_basic))
        out.append(rows)
    assert out[0] == out[1]
    # every vote and proposal decodes back equal, but for the reference's
    # proposal at POL round 0: the zero sfixed64 is not written, so it
    # decodes as -1 (held in the port, as the bytes must be the same)
    assert [r[3] for r in out[1] if len(r) == 4] == [True] * 8 + [True, False, True]
    # the reference's bytes decode to the port's equal objects, and back
    vals, keys = _valset(REF)
    v = _vote(REF, vals, keys, 1, tag=b"x")
    assert convert.vote(v).encode() == v.encode()
    p = j_vote.Proposal(5, 3, -1, _bid(REF, b"p"), TS, b"\x07" * 64)
    assert convert.to_reference(convert.proposal(p), j_vote.Proposal) == p


def test_canonical_strip_timestamp_equals_the_reference():
    import tendermint_tpu.types.canonical as j_can
    import tendermint_tpu_torch.types.canonical as p_can

    out = []
    for can, pkg in ((j_can, REF), (p_can, PORT)):
        bid = _bid(pkg, b"s")
        vsb = can.vote_sign_bytes(CHAIN, pkg.keys.SignedMsgType.PREVOTE, 3, 1, bid, TS + 9)
        psb = can.proposal_sign_bytes(CHAIN, 3, 1, 0, bid, TS + 11)
        out.append((vsb, psb, can.strip_timestamp(vsb), can.strip_timestamp(psb, field=6)))
    assert out[0] == out[1]


# -- vote sets -----------------------------------------------------------------


def _vote_set_script(pkg):
    """Adds, duplicates, conflicts, bad signatures and majorities on one
    VoteSet and on a HeightVoteSet (rounds, catch-up rounds, pol_info)."""
    vals, keys = _valset(pkg)
    T = pkg.keys.SignedMsgType
    out = []
    vs = pkg.vs.VoteSet(CHAIN, 1, 0, T.PREVOTE, vals)
    a = [_vote(pkg, vals, keys, i, tag=b"A") for i in range(N_VALS)]
    b1 = _vote(pkg, vals, keys, 1, tag=b"B")
    bad = pkg.vote.Vote(**{**a[3].__dict__, "signature": b"\x01" * 64})
    wrong_addr = pkg.vote.Vote(**{**a[2].__dict__, "validator_index": 0})
    for v in (a[0], a[0], b1, a[1], a[2], wrong_addr, bad, a[3]):
        res, err = _outcome(lambda v=v: vs.add_vote(v))
        out.append((res, err, vs.two_thirds_majority(), vs.has_two_thirds_any(),
                    vs.has_all(), vs.sum, str(vs.votes_bit_array)))
    try:
        vs.add_vote(a[1])
    except pkg.vs.ConflictingVoteError as e:
        out.append((e.existing.encode(), e.new.encode()))
    out.append(str(vs.bit_array_by_block_id(a[0].block_id)))
    # a pre-verified add skips the signature check, never the identity one
    vs2 = pkg.vs.VoteSet(CHAIN, 1, 0, T.PREVOTE, vals)
    out.append(_outcome(lambda: vs2.add_vote(bad, verified=True)))
    out.append(_outcome(lambda: vs2.add_vote(wrong_addr, verified=True)))
    # precommits to a commit: make_commit's bytes
    pc = pkg.vs.VoteSet(CHAIN, 1, 0, T.PRECOMMIT, vals)
    for i in range(N_VALS - 1):
        pc.add_vote(_vote(pkg, vals, keys, i, type_=T.PRECOMMIT, tag=b"C", ts=i))
    pc.add_vote(_vote(pkg, vals, keys, N_VALS - 1, type_=T.PRECOMMIT, nil=True, ts=9))
    out.append(pc.make_commit().encode())
    # the height's rounds: set_round, unwanted rounds, catch-up claims
    hvs = pkg.ctypes.HeightVoteSet(CHAIN, 1, vals)
    far = _vote(pkg, vals, keys, 0, round_=5, tag=b"F")
    out.append((hvs.add_vote(a[0]), hvs.wanted(far, "p1"), hvs.add_vote(far, "p1")))
    hvs.set_peer_maj23(5, T.PREVOTE, "p1", far.block_id)
    hvs.set_peer_maj23(6, T.PREVOTE, "p1")
    hvs.set_peer_maj23(7, T.PREVOTE, "p1")  # a third catch-up round: over budget
    out.append((hvs.wanted(far, "p1"), hvs.add_vote(far, "p1"),
                hvs.wanted(_vote(pkg, vals, keys, 1, round_=7), "p1")))
    hvs.set_round(2)
    for i in range(3):
        hvs.add_vote(_vote(pkg, vals, keys, i, round_=2, tag=b"P"))
    out.append(hvs.pol_info())
    out.append(_outcome(lambda: hvs.set_round(1)))
    out.append(sorted(hvs._round_vote_sets))
    return out


def test_vote_sets_equal_the_reference():
    ref, port = (_vote_set_script(pkg) for pkg in PKGS)
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert repr(r) == repr(p) or r == p, f"step {i}: {r!r} != {p!r}"


# -- ticker and peer state -----------------------------------------------------


@pytest.mark.asyncio
async def test_ticker_fires_and_replaces_as_the_reference():
    fired = []
    for pkg in PKGS:
        RS = pkg.ctypes.RoundStep
        TI = pkg.ticker.TimeoutInfo
        t = pkg.ticker.TimeoutTicker()
        t.schedule(TI(10_000_000, 1, 0, RS.PROPOSE))
        t.schedule(TI(5_000_000, 1, 1, RS.PROPOSE))  # a later HRS replaces
        first = await asyncio.wait_for(t.tock.get(), 1.0)
        t.schedule(TI(5_000_000, 2, 0, RS.PREVOTE_WAIT))
        t.schedule(TI(60_000_000_000, 1, 0, RS.PROPOSE))  # stale: ignored
        second = await asyncio.wait_for(t.tock.get(), 1.0)
        t.stop()
        fired.append([(ti.height, ti.round, int(ti.step)) for ti in (first, second)])
    assert fired[0] == fired[1]
    assert [f[:2] for f in fired[1]] == [(1, 1), (2, 0)]


def _peer_state_script(pkg):
    vals, keys = _valset(pkg)
    T = pkg.keys.SignedMsgType
    m = pkg.m
    ps = pkg.ps.PeerState("peer-1")
    out = []
    ps.apply_new_round_step(m.NewRoundStepMessage(1, 0, 3, 0, -1))
    vs = pkg.vs.VoteSet(CHAIN, 1, 0, T.PREVOTE, vals)
    for i in range(N_VALS):
        vs.add_vote(_vote(pkg, vals, keys, i, tag=b"G"))
    ps.set_has_vote(1, 0, T.PREVOTE, 2)
    ps.apply_has_vote(m.HasVoteMessage(1, 0, T.PREVOTE, 0))
    out.append([v.validator_index for v in ps.pick_votes_to_send(vs, 8)])
    out.append(ps.pick_vote_to_send(vs).validator_index)
    ba = pkg.bits.BitArray.from_indices(N_VALS, [3])
    ps.apply_vote_set_bits(m.VoteSetBitsMessage(1, 0, T.PREVOTE, _bid(pkg, b"G"), ba),
                           vs.bit_array_by_block_id(_bid(pkg, b"G")))
    out.append([v.validator_index for v in ps.pick_votes_to_send(vs, 8)])
    ps.apply_new_round_step(m.NewRoundStepMessage(2, 0, 1, 0, 0))
    prs = ps.prs
    out.append((prs.height, prs.round, prs.step, prs.last_commit_round,
                str(prs.last_commit) if prs.last_commit is not None else None))
    ps.ensure_catchup_commit(1, 0, N_VALS)
    out.append(str(prs.catchup_commit))
    ps.apply_new_valid_block(m.NewValidBlockMessage(2, 0, (2, b"\x03" * 32),
                                                    pkg.bits.BitArray.from_indices(2, [1]), False))
    out.append((prs.proposal_block_parts_header, str(prs.proposal_block_parts)))
    return out


def test_peer_state_bits_and_picks_equal_the_reference():
    ref, port = (_peer_state_script(pkg) for pkg in PKGS)
    assert [repr(x) for x in ref] == [repr(x) for x in port]


# -- private validators --------------------------------------------------------


def _pv_script(pkg, pv):
    T = pkg.keys.SignedMsgType
    bid = _bid(pkg, b"pv")

    def vote(h, r, type_, ts, b=bid):
        return pkg.vote.Vote(type_, h, r, b, TS + ts, pv.get_pub_key().address(), 0)

    out = []
    for v in (vote(1, 0, T.PREVOTE, 0), vote(1, 0, T.PREVOTE, 0),  # idempotent re-sign
              vote(1, 0, T.PREVOTE, 5),  # timestamp only: the old signature, the old time
              vote(1, 0, T.PREVOTE, 0, _bid(pkg, b"other")),  # conflicting: refused
              vote(1, 0, T.PRECOMMIT, 1), vote(1, 0, T.PREVOTE, 2),  # regression: refused
              vote(2, 0, T.PREVOTE, 3)):
        res, err = _outcome(lambda v=v: pv.sign_vote(CHAIN, v))
        out.append((res.signature, res.timestamp_ns) if res else err)
    prop = pkg.vote.Proposal(3, 0, -1, bid, TS, b"")
    for p in (prop, pkg.vote.Proposal(3, 0, -1, bid, TS + 4, b""),
              pkg.vote.Proposal(3, 0, -1, _bid(pkg, b"x"), TS, b"")):
        res, err = _outcome(lambda p=p: pv.sign_proposal(CHAIN, p))
        out.append((res.signature, res.timestamp_ns) if res else err)
    return out


def test_private_validators_sign_and_refuse_as_the_reference(tmp_path):
    seed = bytes(range(32))
    import tendermint_tpu.crypto.ed25519 as j_ed
    import tendermint_tpu_torch.crypto.ed25519 as p_ed

    outs, files = [], []
    for pkg, ed, name in ((REF, j_ed, "ref"), (PORT, p_ed, "port")):
        mock = pkg.pv.MockPV(ed.Ed25519PrivKey(seed), guard=True)
        d = tmp_path / name
        fpv = pkg.pv.FilePV(ed.Ed25519PrivKey(seed), str(d / "key.json"), str(d / "state.json"))
        fpv.save()
        outs.append((_pv_script(pkg, mock), _pv_script(pkg, fpv)))
        files.append(((d / "key.json").read_bytes(), (d / "state.json").read_bytes()))
    assert outs[0] == outs[1]
    # the vote guard is the same in both signers (MockPV guards no proposal)
    assert outs[1][0][:7] == outs[1][1][:7]
    assert "DoubleSignError" in outs[1][1]
    assert files[0] == files[1]  # key and state files byte-equal
    # each package loads the other's files and keeps refusing
    for pkg, other in ((REF, "port"), (PORT, "ref")):
        d = tmp_path / other
        pv = pkg.pv.FilePV.load(str(d / "key.json"), str(d / "state.json"))
        assert pv.last_sign_state.height == 3
        v = pkg.vote.Vote(pkg.keys.SignedMsgType.PREVOTE, 2, 0, _bid(pkg, b"pv"), TS,
                          pv.get_pub_key().address(), 0)
        with pytest.raises(pkg.pv.DoubleSignError):
            pv.sign_vote(CHAIN, v)


# -- message frames ------------------------------------------------------------


def test_every_message_frame_equals_the_references_under_both_codecs():
    port_msgs = _msgs(PORT)
    port_frames = [p_m.encode_message(x) for x in port_msgs]
    assert not p_m.wiregen_active()
    was = j_m.wiregen_active()
    try:
        for generated in (True, False):
            assert j_m.use_wiregen(generated) == generated
            ref_frames = [j_m.encode_message(x) for x in _msgs(REF)]
            assert ref_frames == port_frames
            for frame, msg in zip(ref_frames, port_msgs):
                assert p_m.decode_message(frame) == msg
                assert j_m.decode_message(p_m.encode_message(msg)).__class__.__name__ == \
                    type(msg).__name__
    finally:
        j_m.use_wiregen(was)
    # the WAL wrapping: a message with its peer, and a timeout
    ti = p_ticker.TimeoutInfo(1_000_000, 5, 1, p_ctypes.RoundStep.PREVOTE_WAIT)
    jti = j_ticker.TimeoutInfo(1_000_000, 5, 1, j_ctypes.RoundStep.PREVOTE_WAIT)
    assert p_m.encode_wal_message(ti) == j_m.encode_wal_message(jti)
    for msg, jmsg in zip(port_msgs, _msgs(REF)):
        raw = j_m.encode_wal_message(jmsg, "peer-9")
        assert p_m.encode_wal_message(msg, "peer-9") == raw
        assert p_m.decode_wal_message(raw) == (msg, "peer-9")


def test_use_wiregen_true_raises_until_the_generator_is_ported():
    with pytest.raises(NotImplementedError, match="item 17"):
        p_m.use_wiregen(True)
    assert p_m.use_wiregen(False) is False
    assert not p_m.wiregen_active()
    assert p_m.encode_message is p_m.encode_message_py


# -- the WAL -------------------------------------------------------------------


def _wal_writes(pkg, wal):
    T = pkg.keys.SignedMsgType
    vals, keys = _valset(pkg)
    for h in (1, 2, 3):
        for i in range(N_VALS):
            v = _vote(pkg, vals, keys, i, type_=T.PRECOMMIT, tag=b"w%d" % h, ts=h)
            wal.write(pkg.m.encode_wal_message(pkg.m.VoteMessage(v), f"peer{i}"), time_ns=h)
        wal.write_sync(pkg.m.encode_wal_message(
            pkg.ticker.TimeoutInfo(5_000_000, h, 0, pkg.ctypes.RoundStep.PROPOSE)))
        wal.write_end_height(h)


def _wal_files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_wal_files_repair_and_cross_reads_equal_the_reference(tmp_path):
    dirs = {}
    for pkg, name in ((REF, "ref"), (PORT, "port")):
        d = str(tmp_path / name)
        # a small head forces rotations: wal.000, wal.001, ... and the head
        wal = pkg.wal.WAL(d, head_size_limit=1024)
        _wal_writes(pkg, wal)
        wal.close()
        dirs[name] = d
    ref_files, port_files = _wal_files(dirs["ref"]), _wal_files(dirs["port"])
    assert len(ref_files) > 2 and ref_files == port_files
    # each package reads the other's records, and finds the same heights
    for pkg, other in ((REF, "port"), (PORT, "ref")):
        mine = pkg.wal.WAL(dirs["ref" if other == "port" else "port"])
        theirs = pkg.wal.WAL(convert.wal_dir(dirs[other], str(tmp_path / f"copy-{other}")))
        a = [(r.kind, r.time_ns, r.data, r.height) for r in mine.iter_records(strict=True)]
        b = [(r.kind, r.time_ns, r.data, r.height) for r in theirs.iter_records(strict=True)]
        assert a == b and len(a) == 18
        assert [x.data for x in theirs.search_for_end_height(2)] == \
            [x.data for x in mine.search_for_end_height(2)]
        assert theirs.search_for_end_height(7) is None
        mine.close()
        theirs.close()
    # a torn tail: both repair() at the same point, the tail set aside
    repairs = {}
    for pkg, name in ((REF, "ref"), (PORT, "port")):
        head = os.path.join(dirs[name], "wal")
        with open(head, "ab") as f:
            f.write(b"\x07\x00\x00\x00\x40\x00\x00\x00garbage")
        wal = pkg.wal.WAL(dirs[name])
        repairs[name] = [(os.path.basename(r.path), r.valid_end, r.file_size, r.n_records,
                          os.path.basename(r.tail_path), r.reason) for r in wal.last_repair]
        wal.close()
    assert repairs["ref"] == repairs["port"] and len(repairs["port"]) == 1
    assert _wal_files(dirs["ref"]) == _wal_files(dirs["port"])
