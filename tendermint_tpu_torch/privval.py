"""Private validator — signs votes and proposals, guards against
double-signing (reference privval/file.go; the port's copy of
tendermint_tpu/privval.py, whose key and state files it writes byte for
byte).

`PrivValidator` is the signing interface consumed by the consensus state
machine (reference types/priv_validator.go:28). `FilePV` persists the key
and the last-sign-state to disk; the last-sign-state file is written
*before* a signature is released so a crashed-and-restarted validator can
never sign conflicting votes for the same (height, round, step)
(reference privval/file.go:152, signVote/signProposal guards).

The remote-signer endpoints (the reference's privval_remote.py) wait for
the port of the node (ROADMAP item 17).
"""

from __future__ import annotations

import json
import os
import tempfile

from .crypto import ed25519, pubkey_from_type_and_bytes
from .types.keys import SignedMsgType
from .types.vote import Proposal, Vote

# sign-state steps (reference privval/file.go:33-37)
STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_TO_STEP = {
    SignedMsgType.PREVOTE: STEP_PREVOTE,
    SignedMsgType.PRECOMMIT: STEP_PRECOMMIT,
}


class DoubleSignError(RuntimeError):
    pass


class PrivValidator:
    """Signing interface (reference types/priv_validator.go:28)."""

    def get_pub_key(self):
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        """Sign and return the vote with its signature (and possibly the
        timestamp of a previously-signed identical vote) filled in."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        raise NotImplementedError


class MockPV(PrivValidator):
    """In-memory signer without persistence — the test double (reference
    types/priv_validator.go MockPV). No double-sign protection unless
    `guard` is set."""

    def __init__(self, priv_key=None, *, guard: bool = False):
        self.priv_key = priv_key or ed25519.Ed25519PrivKey.generate()
        self._guard = _SignState() if guard else None

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        sb = vote.sign_bytes(chain_id)
        if self._guard is not None:
            reuse = self._guard.check_vote(vote, sb)
            if reuse is not None:
                sig, ts = reuse
                return Vote(
                    **{**vote.__dict__, "signature": sig, "timestamp_ns": ts}
                )
        sig = self.priv_key.sign(sb)
        if self._guard is not None:
            self._guard.record(
                vote.height, vote.round, _VOTE_TO_STEP[vote.type], sb, sig
            )
        return Vote(**{**vote.__dict__, "signature": sig})

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        sb = proposal.sign_bytes(chain_id)
        sig = self.priv_key.sign(sb)
        return Proposal(**{**proposal.__dict__, "signature": sig})


class _SignState:
    """Last-sign-state with the three-way outcome of the reference's
    CheckHRS (privval/file.go:86): new HRS → sign; same HRS + same
    sign-bytes → return the old signature (idempotent re-sign after a
    crash); same HRS + different sign-bytes → double-sign panic."""

    def __init__(self):
        self.height = 0
        self.round = 0
        self.step = STEP_NONE
        self.sign_bytes: bytes = b""
        self.signature: bytes = b""

    def _cmp(self, height: int, round_: int, step: int) -> int:
        mine = (self.height, self.round, self.step)
        theirs = (height, round_, step)
        return (theirs > mine) - (theirs < mine)

    def check_vote(self, vote: Vote, sb: bytes) -> tuple[bytes, int] | None:
        """Returns (signature, timestamp_ns) of a previous signing to
        reuse — the caller must emit the vote with THAT timestamp, since
        the signature covers it — or None to sign fresh. Raises
        DoubleSignError on a conflicting regression."""
        step = _VOTE_TO_STEP[vote.type]
        c = self._cmp(vote.height, vote.round, step)
        if c > 0:
            return None
        if c == 0:
            if sb == self.sign_bytes and self.signature:
                return self.signature, vote.timestamp_ns
            # same HRS, differing only in timestamp is also a legal
            # re-sign: reuse the old signature AND its timestamp
            if self.signature:
                old_ts = _timestamp_only_diff(self.sign_bytes, sb, field=5)
                if old_ts is not None:
                    return self.signature, old_ts
            raise DoubleSignError(
                f"conflicting vote at height/round/step "
                f"{vote.height}/{vote.round}/{step}"
            )
        raise DoubleSignError(
            f"sign-state regression: have {self.height}/{self.round}/{self.step}, "
            f"asked to sign {vote.height}/{vote.round}/{step}"
        )

    def check_proposal(self, proposal: Proposal, sb: bytes) -> tuple[bytes, int] | None:
        c = self._cmp(proposal.height, proposal.round, STEP_PROPOSE)
        if c > 0:
            return None
        if c == 0:
            if sb == self.sign_bytes and self.signature:
                return self.signature, proposal.timestamp_ns
            if self.signature:
                old_ts = _timestamp_only_diff(self.sign_bytes, sb, field=6)
                if old_ts is not None:
                    return self.signature, old_ts
            raise DoubleSignError(
                f"conflicting proposal at {proposal.height}/{proposal.round}"
            )
        raise DoubleSignError("proposal sign-state regression")

    def record(self, height: int, round_: int, step: int, sb: bytes, sig: bytes):
        self.height, self.round, self.step = height, round_, step
        self.sign_bytes, self.signature = sb, sig


def _timestamp_only_diff(old_sb: bytes, new_sb: bytes, *, field: int) -> int | None:
    """If the two canonical sign-bytes differ only in their timestamp
    field, return the OLD timestamp (whose signature is reusable), else
    None (reference privval/file.go checkVotesOnlyDifferByTimestamp /
    checkProposalsOnlyDifferByTimestamp)."""
    from .types import canonical

    try:
        a, old_ts = canonical.strip_timestamp(old_sb, field=field)
        b, _ = canonical.strip_timestamp(new_sb, field=field)
    except Exception:
        return None
    return old_ts if a == b else None


class FilePV(PrivValidator):
    """File-backed validator key + last-sign-state (reference
    privval/file.go:152). Two JSON files, like the reference's
    priv_validator_key.json / priv_validator_state.json."""

    def __init__(self, priv_key, key_path: str, state_path: str):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        self.last_sign_state = _SignState()

    # -- construction ----------------------------------------------------

    @classmethod
    def generate(
        cls, key_path: str, state_path: str, *, key_type: str = "ed25519"
    ) -> "FilePV":
        if key_type == "ed25519":
            priv = ed25519.Ed25519PrivKey.generate()
        elif key_type == "secp256k1":
            from .crypto import secp256k1

            priv = secp256k1.Secp256k1PrivKey.generate()
        else:
            raise ValueError(f"unsupported validator key type {key_type!r}")
        pv = cls(priv, key_path, state_path)
        pv.save()
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            kd = json.load(f)
        key_type = kd.get("type", "ed25519")
        if key_type == "ed25519":
            priv = ed25519.Ed25519PrivKey(bytes.fromhex(kd["priv_key"])[:32])
        else:
            from .crypto import secp256k1

            priv = secp256k1.Secp256k1PrivKey(bytes.fromhex(kd["priv_key"]))
        pv = cls(priv, key_path, state_path)
        if os.path.exists(state_path):
            with open(state_path) as f:
                sd = json.load(f)
            ss = pv.last_sign_state
            ss.height = sd.get("height", 0)
            ss.round = sd.get("round", 0)
            ss.step = sd.get("step", STEP_NONE)
            ss.sign_bytes = bytes.fromhex(sd.get("sign_bytes", ""))
            ss.signature = bytes.fromhex(sd.get("signature", ""))
        return pv

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        return cls.generate(key_path, state_path)

    # -- persistence -----------------------------------------------------

    def save(self) -> None:
        self._atomic_write(
            self.key_path,
            {
                "address": self.priv_key.pub_key().address().hex(),
                "pub_key": self.priv_key.pub_key().bytes().hex(),
                "priv_key": self.priv_key.bytes().hex(),
                "type": "ed25519"
                if isinstance(self.priv_key, ed25519.Ed25519PrivKey)
                else "secp256k1",
            },
        )
        self._save_state()

    def _save_state(self) -> None:
        ss = self.last_sign_state
        self._atomic_write(
            self.state_path,
            {
                "height": ss.height,
                "round": ss.round,
                "step": ss.step,
                "sign_bytes": ss.sign_bytes.hex(),
                "signature": ss.signature.hex(),
            },
        )

    @staticmethod
    def _atomic_write(path: str, obj: dict) -> None:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".pv-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(obj, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    # -- signing ---------------------------------------------------------

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        sb = vote.sign_bytes(chain_id)
        reuse = self.last_sign_state.check_vote(vote, sb)
        if reuse is not None:
            sig, ts = reuse
            return Vote(**{**vote.__dict__, "signature": sig, "timestamp_ns": ts})
        sig = self.priv_key.sign(sb)
        # persist the sign-state BEFORE releasing the signature
        self.last_sign_state.record(
            vote.height, vote.round, _VOTE_TO_STEP[vote.type], sb, sig
        )
        self._save_state()
        return Vote(**{**vote.__dict__, "signature": sig})

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        sb = proposal.sign_bytes(chain_id)
        reuse = self.last_sign_state.check_proposal(proposal, sb)
        if reuse is not None:
            sig, ts = reuse
            return Proposal(
                **{**proposal.__dict__, "signature": sig, "timestamp_ns": ts}
            )
        sig = self.priv_key.sign(sb)
        self.last_sign_state.record(
            proposal.height, proposal.round, STEP_PROPOSE, sb, sig
        )
        self._save_state()
        return Proposal(**{**proposal.__dict__, "signature": sig})
