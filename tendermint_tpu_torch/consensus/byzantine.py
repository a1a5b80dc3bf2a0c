"""ByzNet — Byzantine validator strategies over RouterNet (the port's copy
of tendermint_tpu/consensus/byzantine.py: every decision draws from the
same seeded digests, so a traitor takes the same actions in either
package).

Eleven PRs of chaos exercised crash, network, storage and clock faults;
this module finally tests the "B" in BFT: a validator that *lies*. A
`ByzantineNode` turns one RouterNode into a seeded, deterministic
traitor by wrapping exactly two seams — the node's signer
(`TraitorSigner` replaces the MockPV) and the consensus reactor's send
path (`ConsensusReactor._send_nowait`, overridden on the INSTANCE) — so
no honest code changes and production wiring is structurally unable to
reach this module (only the scenario harness and tests may import it;
tests/test_torch_byzantine.py scans the port's modules for that).

Strategies (compose freely via `ByzConfig.strategies`):

  equivocate            double-sign prevotes/precommits: the honest vote
                        plus a properly-signed twin for a fabricated
                        conflicting block id at the same (H,R,S). In
                        ``both`` mode every peer receives the pair
                        back-to-back (deterministic local detection →
                        DuplicateVoteEvidence on every honest node); in
                        ``split`` mode half the peers get the twin
                        instead, so detection must happen where honest
                        relay gossip intersects.
  conflicting_proposal  as proposer, serve a signed conflicting proposal
                        (fabricated block id) to a seeded camp of peers.
  amnesia               ignore the lock: prevote the CURRENT proposal
                        (or nil) even while locked on an earlier block.
  withhold_votes        starve a seeded fraction of peers of our own
                        votes (honest relays may still heal them).
  withhold_precommits   never send our own precommits to anyone — the
                        committee must commit on honest votes alone
                        (this also pins the commit signer set, the
                        bit-reproducibility construction at f=1).
  withhold_parts        drop outbound block parts to the withheld peers.
  invalid_sig           gossip a vote with a garbage signature once per
                        (height, peer): stage-1 ingest disproves it and
                        the peer charges US (PeerError → score/ban —
                        audited, the accountability half).
  future_round_flood    broadcast properly-signed votes for far-future
                        rounds: the `HeightVoteSet.wanted` DoS guard
                        must drop them without burning verify capacity.
  lying_frames          lie on the state channel: NewRoundStep claims a
                        height behind ours (baiting donors into catch-up
                        service — what per-peer catch-up pacing bounds)
                        and HasVote claims votes that don't exist
                        (starvation that VoteSetBits reconciliation and
                        the stall-refresh must heal).

Every decision is a pure function of (seed, strategy, coordinates) —
never of arrival order or wall time — so two same-seed byz runs take
bit-identical actions, and with the RouterNet determinism construction
(frozen clock + pinned signer set) produce bit-identical block AND
evidence bytes (tests/test_byzantine.py).

`audit_net` is the cross-node safety auditor every byz scenario runs:
no two honest nodes may ever commit different block ids at any height,
app-hash chains must agree, every equivocator must yield
DuplicateVoteEvidence committed on chain within K heights, and
invalid-signature gossip must have cost the traitor (peer score/ban on
some honest node).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field

from ..crypto.hashes import sha256
from ..p2p.types import Envelope
from ..privval import PrivValidator
from ..types.block import BlockID, PartSetHeader
from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.keys import SignedMsgType
from ..types.vote import Proposal, Vote
from . import messages as m
from .reactor import DATA_CHANNEL, STATE_CHANNEL, VOTE_CHANNEL

log = logging.getLogger("byzantine")

#: the full strategy taxonomy (ByzConfig.strategies ⊆ this)
STRATEGIES = frozenset(
    {
        "equivocate",
        "conflicting_proposal",
        "amnesia",
        "withhold_votes",
        "withhold_precommits",
        "withhold_parts",
        "invalid_sig",
        "future_round_flood",
        "lying_frames",
    }
)

#: bounded per-node action log (wedge dumps carry it; a runaway traitor
#: must not OOM the harness)
MAX_ACTION_LOG = 4096


@dataclass(frozen=True)
class ByzConfig:
    """One traitor's plan. All knobs deterministic in `seed`."""

    strategies: tuple[str, ...]
    seed: int = 0
    #: heights at which to equivocate / serve conflicting proposals
    #: (None = every height)
    equiv_heights: tuple[int, ...] | None = None
    #: vote types to double-sign
    equiv_types: tuple[SignedMsgType, ...] = (
        SignedMsgType.PREVOTE,
        SignedMsgType.PRECOMMIT,
    )
    #: False → every peer gets (honest, twin) back-to-back; True → a
    #: seeded half of the peers receives ONLY the twin
    equiv_split: bool = False
    #: fraction of peers starved by withhold_votes / withhold_parts
    withhold_frac: float = 0.5
    #: future_round_flood: votes per burst and how far ahead they claim
    flood_votes: int = 4
    flood_round_offset: int = 3
    #: lying_frames: how far behind NewRoundStep claims to be
    lie_behind: int = 2

    def __post_init__(self):
        unknown = set(self.strategies) - STRATEGIES
        if unknown:
            raise ValueError(f"unknown byzantine strategies: {sorted(unknown)}")

    def active(self, name: str) -> bool:
        return name in self.strategies

    def equivocates_at(self, height: int, type_: SignedMsgType) -> bool:
        if not self.active("equivocate"):
            return False
        if type_ not in self.equiv_types:
            return False
        return self.equiv_heights is None or height in self.equiv_heights


def _decide(seed: int, tag: str, *coords) -> float:
    """Deterministic decision draw in [0, 1): a pure function of the
    seed + coordinates, independent of arrival order and wall time —
    the same-seed bit-identity contract."""
    h = hashlib.sha256(
        f"tmtpu-byz:{seed}:{tag}:{coords!r}".encode()
    ).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def _fabricated_block_id(seed: int, tag: str, *coords) -> BlockID:
    """A structurally-complete BlockID that can never match a real
    block: hash and part-set hash are seeded digests, total=1."""
    base = hashlib.sha256(f"tmtpu-byz-block:{seed}:{tag}:{coords!r}".encode())
    h1 = base.digest()
    h2 = sha256(h1)
    return BlockID(h1, PartSetHeader(1, h2))


class TraitorSigner(PrivValidator):
    """The traitor's signer: signs whatever the strategy calls for —
    the honest vote, an amnesiac rewrite, and (on demand) the
    equivocating twin — with NO double-sign guard. The sign-state
    protection is precisely what a Byzantine validator doesn't run."""

    def __init__(self, priv_key, owner: "ByzantineNode"):
        self.priv_key = priv_key
        self.owner = owner

    def get_pub_key(self):
        return self.priv_key.pub_key()

    # -- votes ----------------------------------------------------------

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        owner = self.owner
        cfg = owner.cfg
        if cfg.active("amnesia") and vote.type == SignedMsgType.PREVOTE:
            vote = self._amnesia_rewrite(vote)
        sig = self.priv_key.sign(vote.sign_bytes(chain_id))
        signed = Vote(**{**vote.__dict__, "signature": sig})
        if cfg.equivocates_at(vote.height, vote.type):
            self._make_twin(chain_id, signed)
        return signed

    def _amnesia_rewrite(self, vote: Vote) -> Vote:
        """Ignore the lock: while locked on block A, prevote whatever
        block is currently proposed (or nil) instead of re-confirming
        the lock — the classic amnesia deviation."""
        rs = self.owner.rs()
        if rs is None or rs.locked_round < 0 or vote.is_nil():
            return vote
        locked_hash = rs.locked_block.hash() if rs.locked_block else b""
        if vote.block_id.hash != locked_hash:
            return vote  # not a lock re-confirmation; nothing to forget
        if (
            rs.proposal_block is not None
            and rs.proposal_block.hash() != locked_hash
            and rs.proposal_block_parts is not None
        ):
            new_bid = BlockID(
                rs.proposal_block.hash(), rs.proposal_block_parts.header
            )
        else:
            from ..types.block import NIL_BLOCK_ID

            new_bid = NIL_BLOCK_ID
        self.owner.record(
            "amnesia", vote.height, vote.round, type=int(vote.type)
        )
        return Vote(**{**vote.__dict__, "block_id": new_bid})

    def _make_twin(self, chain_id: str, honest: Vote) -> None:
        """Sign the conflicting twin for the SAME (height, round, step)
        and park it for the send path. Same timestamp as the honest
        vote, so under a frozen clock the evidence pair is a pure
        function of (seed, height, round, type) — bit-identical across
        same-seed runs."""
        key = (honest.height, honest.round, honest.type)
        if key in self.owner.twins:
            return
        bid = _fabricated_block_id(
            self.owner.cfg.seed, "equiv", *key, self.owner.index
        )
        if bid == honest.block_id:  # can't happen, but never emit a dup
            return
        twin = Vote(**{**honest.__dict__, "block_id": bid, "signature": b""})
        sig = self.priv_key.sign(twin.sign_bytes(chain_id))
        self.owner.twins[key] = Vote(**{**twin.__dict__, "signature": sig})
        self.owner.record(
            "equivocate", honest.height, honest.round, type=int(honest.type)
        )

    # -- proposals ------------------------------------------------------

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        sig = self.priv_key.sign(proposal.sign_bytes(chain_id))
        signed = Proposal(**{**proposal.__dict__, "signature": sig})
        cfg = self.owner.cfg
        if cfg.active("conflicting_proposal") and (
            cfg.equiv_heights is None or proposal.height in cfg.equiv_heights
        ):
            key = (proposal.height, proposal.round)
            if key not in self.owner.proposal_twins:
                bid = _fabricated_block_id(
                    cfg.seed, "prop", *key, self.owner.index
                )
                twin = Proposal(
                    **{**proposal.__dict__, "block_id": bid, "signature": b""}
                )
                tsig = self.priv_key.sign(twin.sign_bytes(chain_id))
                self.owner.proposal_twins[key] = Proposal(
                    **{**twin.__dict__, "signature": tsig}
                )
                self.owner.record(
                    "conflicting_proposal", proposal.height, proposal.round
                )
        return signed


class ByzantineNode:
    """One traitor: wraps a prepared RouterNode (signer + reactor send
    path). Install happens between `RouterNode.prepare()` and `go()`,
    the same window node.py uses to attach reactors before the SM —
    no honest vote is ever signed by the original MockPV."""

    def __init__(self, net, index: int, cfg: ByzConfig):
        self.net = net
        self.index = index
        self.cfg = cfg
        self.node = None  # RouterNode, set by install()
        self.priv_key = net.keys[index]
        self.address = self.priv_key.pub_key().address()
        self.chain_id = net.genesis.chain_id
        self.twins: dict[tuple, Vote] = {}
        self.proposal_twins: dict[tuple, Proposal] = {}
        self.actions: list[dict] = []
        self.action_counts: dict[str, int] = {}
        self._flood_sent: set[tuple] = set()
        self._badsig_sent: set[tuple] = set()
        self._signer: TraitorSigner | None = None

    # -- install ---------------------------------------------------------

    def install(self, rnode) -> None:
        if rnode.index != self.index:
            raise ValueError("byzantine install on the wrong node")
        self.node = rnode
        self._signer = TraitorSigner(self.priv_key, self)
        rnode.inner.priv_val = self._signer
        rnode.inner.cs.priv_validator = self._signer
        reactor = rnode.reactor
        orig = reactor._send_nowait

        def byz_send(ch, env, _orig=orig):
            for c, e in self._rewrite(ch, env):
                _orig(c, e)

        # instance attribute shadows the class method: honest reactors
        # (and this reactor's honest *receive* half) are untouched
        reactor._send_nowait = byz_send

    def rs(self):
        cs = self.node.cs if self.node is not None else None
        return cs.rs if cs is not None else None

    @property
    def node_id(self) -> str:
        return self.node.node_id if self.node is not None else ""

    def record(self, action: str, height: int = 0, round_: int = 0, **detail):
        self.action_counts[action] = self.action_counts.get(action, 0) + 1
        if len(self.actions) < MAX_ACTION_LOG:
            entry = {"action": action, "height": height, "round": round_}
            entry.update(detail)
            self.actions.append(entry)

    def log_summary(self) -> dict:
        return {
            "index": self.index,
            "strategies": list(self.cfg.strategies),
            "seed": self.cfg.seed,
            "counts": dict(self.action_counts),
            "actions": self.actions[-256:],
        }

    # -- the send-path interceptor ---------------------------------------

    def _rewrite(self, ch, env: Envelope):
        """Map one outbound (channel, envelope) to zero or more — the
        entire byzantine wire behavior lives here. Unrecognized traffic
        passes through untouched."""
        msg = env.message
        try:
            if env.channel_id == VOTE_CHANNEL and isinstance(
                msg, (m.VoteMessage, m.VoteBatchMessage)
            ):
                return self._rewrite_votes(ch, env)
            if env.channel_id == DATA_CHANNEL and isinstance(
                msg, m.ProposalMessage
            ):
                return self._rewrite_proposal(ch, env)
            if env.channel_id == DATA_CHANNEL and isinstance(
                msg, m.BlockPartMessage
            ):
                return self._rewrite_part(ch, env)
            if env.channel_id == STATE_CHANNEL and isinstance(
                msg, m.NewRoundStepMessage
            ):
                return self._rewrite_round_step(ch, env)
            if env.channel_id == STATE_CHANNEL and isinstance(
                msg, (m.HasVoteMessage, m.HasVoteBatchMessage)
            ):
                return self._rewrite_has_votes(ch, env)
        except Exception:  # noqa: BLE001 — a buggy strategy must not
            # kill the gossip task; fall through to honest behavior
            log.exception("byzantine rewrite failed; sending honestly")
        return [(ch, env)]

    def _withheld(self, tag: str, height: int, peer_id: str) -> bool:
        return (
            _decide(self.cfg.seed, tag, height, peer_id)
            < self.cfg.withhold_frac
        )

    def _camp_b(self, height: int, round_: int, peer_id: str) -> bool:
        # camps are stable PER PEER (a traitor maintains one story per
        # neighbor): conflicting votes reach disjoint camps every
        # height, and detection must come from honest relay gossip
        # crossing the camp boundary
        del height, round_
        return _decide(self.cfg.seed, "camp", peer_id) < 0.5

    def _rewrite_votes(self, ch, env: Envelope):
        cfg = self.cfg
        votes = (
            env.message.votes
            if isinstance(env.message, m.VoteBatchMessage)
            else (env.message.vote,)
        )
        keep: list[Vote] = []
        extra: list[Vote] = []
        for v in votes:
            if v.validator_address != self.address:
                keep.append(v)  # relaying someone else's vote: honest
                continue
            if (
                cfg.active("withhold_precommits")
                and v.type == SignedMsgType.PRECOMMIT
            ):
                self.record("withhold_precommit", v.height, v.round)
                continue
            if (
                cfg.active("withhold_votes")
                and env.to
                and self._withheld("withhold", v.height, env.to)
            ):
                self.record(
                    "withhold_vote", v.height, v.round, peer=env.to[:8]
                )
                continue
            twin = self.twins.get((v.height, v.round, v.type))
            if twin is not None:
                if cfg.equiv_split and env.to and self._camp_b(
                    v.height, v.round, env.to
                ):
                    # camp B sees ONLY the twin; honest relays must
                    # bring the two halves together
                    keep.append(twin)
                    continue
                if not cfg.equiv_split:
                    # honest first, twin immediately after: FIFO per
                    # link means every receiver detects the conflict
                    # deterministically
                    extra.append(twin)
            keep.append(v)
        if (
            cfg.active("invalid_sig")
            and env.to
            and any(v.validator_address == self.address for v in votes)
        ):
            bad = self._bad_sig_vote(votes, env.to)
            if bad is not None:
                extra.append(bad)
        out = []
        if keep:
            out.append((ch, self._vote_env(keep, env)))
        for v in extra:
            out.append((ch, self._vote_env([v], env)))
        return out

    def _vote_env(self, votes: list[Vote], like: Envelope) -> Envelope:
        msg = (
            m.VoteMessage(votes[0])
            if len(votes) == 1
            else m.VoteBatchMessage(tuple(votes))
        )
        return Envelope(
            like.channel_id, msg, to=like.to, broadcast=like.broadcast
        )

    def _bad_sig_vote(self, votes, peer_id: str) -> Vote | None:
        """One garbage-signature vote per (height, peer): enough to
        prove the accountability path (stage-1 disproof → PeerError →
        score/ban) without turning the run into a disconnect storm."""
        own = next(v for v in votes if v.validator_address == self.address)
        key = (own.height, peer_id)
        if key in self._badsig_sent:
            return None
        self._badsig_sent.add(key)
        bid = _fabricated_block_id(
            self.cfg.seed, "badsig", own.height, own.round, self.index
        )
        garbage = hashlib.sha256(
            f"tmtpu-byz-badsig:{self.cfg.seed}:{key!r}".encode()
        ).digest() * 2  # 64 bytes, passes validate_basic, never verifies
        self.record("invalid_sig", own.height, own.round, peer=peer_id[:8])
        return Vote(
            **{**own.__dict__, "block_id": bid, "signature": garbage}
        )

    def _rewrite_proposal(self, ch, env: Envelope):
        msg = env.message
        twin = self.proposal_twins.get((msg.proposal.height, msg.proposal.round))
        if (
            twin is not None
            and env.to
            and self._camp_b(msg.proposal.height, msg.proposal.round, env.to)
        ):
            self.record(
                "serve_conflicting_proposal",
                msg.proposal.height,
                msg.proposal.round,
                peer=env.to[:8],
            )
            return [(ch, Envelope(env.channel_id, m.ProposalMessage(twin), to=env.to))]
        return [(ch, env)]

    def _rewrite_part(self, ch, env: Envelope):
        msg = env.message
        if (
            self.cfg.active("withhold_parts")
            and env.to
            and self._withheld("withhold_part", msg.height, env.to)
        ):
            self.record(
                "withhold_part", msg.height, msg.round, part=msg.part.index
            )
            return []
        return [(ch, env)]

    def _rewrite_round_step(self, ch, env: Envelope):
        out = []
        msg = env.message
        if self.cfg.active("lying_frames") and msg.height > 1:
            lied = m.NewRoundStepMessage(
                height=max(1, msg.height - self.cfg.lie_behind),
                round=0,
                step=1,
                seconds_since_start_time=msg.seconds_since_start_time,
                last_commit_round=0,
            )
            self.record("lie_round_step", msg.height, msg.round)
            out.append(
                (ch, Envelope(env.channel_id, lied, to=env.to, broadcast=env.broadcast))
            )
        else:
            out.append((ch, env))
        if self.cfg.active("future_round_flood"):
            out.extend(self._flood(ch, msg))
        return out

    def _flood(self, ch, step_msg):
        """Properly-signed votes for rounds far beyond round+1: the
        receiver's `HeightVoteSet.wanted` guard must shed them without
        spending signature verifications (the unwanted-round DoS drop
        the ingest pipeline mirrors)."""
        h = step_msg.height
        if (h,) in self._flood_sent:
            return []
        self._flood_sent.add((h,))
        rs = self.rs()
        base_round = (rs.round if rs is not None else 0) + self.cfg.flood_round_offset
        votes = []
        for i in range(self.cfg.flood_votes):
            r = base_round + i
            bid = _fabricated_block_id(self.cfg.seed, "flood", h, r, self.index)
            v = Vote(
                type=SignedMsgType.PREVOTE,
                height=h,
                round=r,
                block_id=bid,
                timestamp_ns=self.net.genesis.genesis_time_ns,
                validator_address=self.address,
                validator_index=self.index,
            )
            sig = self.priv_key.sign(v.sign_bytes(self.chain_id))
            votes.append(Vote(**{**v.__dict__, "signature": sig}))
        self.record("future_round_flood", h, base_round, n=len(votes))
        msg = (
            m.VoteBatchMessage(tuple(votes))
            if len(votes) > 1
            else m.VoteMessage(votes[0])
        )
        return [
            (
                self.node.reactor.vote_ch,
                Envelope(VOTE_CHANNEL, msg, broadcast=True),
            )
        ]

    def _rewrite_has_votes(self, ch, env: Envelope):
        if not self.cfg.active("lying_frames"):
            return [(ch, env)]
        msg = env.message
        entries = (
            list(msg.entries)
            if isinstance(msg, m.HasVoteBatchMessage)
            else [msg]
        )
        first = entries[0]
        n = len(self.net.keys)
        lies = []
        for idx in range(n):
            if _decide(
                self.cfg.seed, "lie_hasvote", first.height, first.round, idx
            ) < 0.5:
                lies.append(
                    m.HasVoteMessage(first.height, first.round, first.type, idx)
                )
        if lies:
            self.record(
                "lie_has_vote", first.height, first.round, n=len(lies)
            )
            entries.extend(lies)
        out_msg = (
            entries[0]
            if len(entries) == 1
            else m.HasVoteBatchMessage(tuple(entries[:m.MAX_BATCH_VOTES]))
        )
        return [
            (ch, Envelope(env.channel_id, out_msg, to=env.to, broadcast=env.broadcast))
        ]


def byz_prepare_hook(plan: dict[int, ByzConfig], registry: list | None = None):
    """RouterNet `prepare_hook` factory: wrap the planned indices as
    they come up (including crash→restart rebuilds — the traitor stays
    a traitor across its own crashes). `registry` collects the live
    ByzantineNode handles for the auditor; on a restart the fresh
    handle replaces its predecessor."""

    def hook(rnode) -> None:
        cfg = plan.get(rnode.index)
        if cfg is None:
            return
        bn = ByzantineNode(rnode.net, rnode.index, cfg)
        bn.install(rnode)
        if registry is not None:
            registry[:] = [b for b in registry if b.index != rnode.index]
            registry.append(bn)

    return hook


# -- the cross-node safety auditor ------------------------------------------


@dataclass
class AuditReport:
    """Structured verdict of `audit_net` — every byz scenario runs it."""

    ok: bool = True
    checked_height: int = 0
    honest: list[int] = field(default_factory=list)
    byzantine: list[int] = field(default_factory=list)
    conflicting_commits: list[dict] = field(default_factory=list)
    app_hash_mismatches: list[dict] = field(default_factory=list)
    #: equivocator address hex -> height its evidence committed at
    evidence_commit_heights: dict[str, int] = field(default_factory=dict)
    #: equivocator address hex -> commit height − equivocation height
    #: (the time-to-evidence-commit figure, in heights)
    evidence_lag_heights: dict[str, int] = field(default_factory=dict)
    missing_evidence: list[int] = field(default_factory=list)
    late_evidence: list[dict] = field(default_factory=list)
    #: light-client-attack accountability (the LightFleet axis):
    #: attributed signer address hex -> height its LCA evidence
    #: committed at, and commit height − conflicting height (the
    #: time-to-evidence-commit figure for light attacks)
    lca_commit_heights: dict[str, int] = field(default_factory=dict)
    lca_lag_heights: dict[str, int] = field(default_factory=dict)
    #: expected lunatic signers whose attack never reached the chain
    missing_lca: list[str] = field(default_factory=list)
    #: byz index -> {honest index: peer score} where penalized
    peer_penalties: dict[int, dict] = field(default_factory=dict)
    unpenalized: list[int] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checked_height": self.checked_height,
            "honest": self.honest,
            "byzantine": self.byzantine,
            "conflicting_commits": self.conflicting_commits,
            "app_hash_mismatches": self.app_hash_mismatches,
            "evidence_commit_heights": dict(self.evidence_commit_heights),
            "evidence_lag_heights": dict(self.evidence_lag_heights),
            "missing_evidence": self.missing_evidence,
            "late_evidence": self.late_evidence,
            "lca_commit_heights": dict(self.lca_commit_heights),
            "lca_lag_heights": dict(self.lca_lag_heights),
            "missing_lca": self.missing_lca,
            "peer_penalties": {
                str(k): v for k, v in self.peer_penalties.items()
            },
            "unpenalized": self.unpenalized,
            "notes": self.notes,
        }


def committed_duplicate_vote_evidence(node) -> dict[bytes, tuple[int, object]]:
    """Scan one node's committed chain for DuplicateVoteEvidence:
    equivocator address -> (first height committed at, the evidence)."""
    out: dict[bytes, tuple[int, object]] = {}
    store = node.block_store
    for h in range(1, store.height() + 1):
        blk = store.load_block(h)
        if blk is None:
            continue
        for ev in blk.evidence:
            if isinstance(ev, DuplicateVoteEvidence):
                addr = ev.vote_a.validator_address
                if addr not in out:
                    out[addr] = (h, ev)
    return out


def committed_light_client_attack_evidence(
    node,
) -> dict[bytes, tuple[int, object]]:
    """Scan one node's committed chain for LightClientAttackEvidence:
    attributed (byzantine) signer address -> (first height its evidence
    committed at, the evidence)."""
    out: dict[bytes, tuple[int, object]] = {}
    store = node.block_store
    for h in range(1, store.height() + 1):
        blk = store.load_block(h)
        if blk is None:
            continue
        for ev in blk.evidence:
            if isinstance(ev, LightClientAttackEvidence):
                for val in ev.byzantine_validators:
                    out.setdefault(val.address, (h, ev))
    return out


def audit_net(
    net,
    byz_nodes: list[ByzantineNode] | None = None,
    *,
    k_heights: int = 3,
    require_evidence: bool = True,
    expect_lca: tuple[bytes, ...] = (),
) -> AuditReport:
    """The safety + accountability audit (module docstring): agreement
    over every committed height, evidence accountability for every
    equivocator that actually produced a twin, and peer-level cost for
    invalid-signature gossip. Pure observation — reads stores and peer
    managers, never mutates the net."""
    byz_nodes = byz_nodes or []
    byz_idx = {b.index for b in byz_nodes}
    rep = AuditReport(
        honest=[n.index for n in net.nodes if n.index not in byz_idx],
        byzantine=sorted(byz_idx),
    )
    honest = [n for n in net.nodes if n.index not in byz_idx]
    if not honest:
        rep.ok = False
        rep.notes.append("no honest nodes to audit")
        return rep

    # 1+2: commit + app-hash agreement at every height any two honest
    # nodes share (a laggard legitimately misses the tip)
    max_h = max(n.block_store.height() for n in honest)
    rep.checked_height = max_h
    for h in range(1, max_h + 1):
        seen: dict[bytes, list[int]] = {}
        apps: dict[bytes, list[int]] = {}
        for n in honest:
            blk = n.block_store.load_block(h)
            if blk is None:
                continue
            seen.setdefault(blk.hash(), []).append(n.index)
            apps.setdefault(blk.header.app_hash, []).append(n.index)
        if len(seen) > 1:
            rep.conflicting_commits.append(
                {"height": h, "hashes": {k.hex()[:16]: v for k, v in seen.items()}}
            )
        if len(apps) > 1:
            rep.app_hash_mismatches.append(
                {"height": h, "hashes": {k.hex()[:16]: v for k, v in apps.items()}}
            )

    # 3: accountability — every equivocator that actually double-signed
    # must be committed on chain within K heights of the equivocation
    # the evidence attributes (a traitor double-signing every height is
    # measured against the height its COMMITTED pair came from).
    # `require_evidence=False` is for split-camp strategies where
    # detection rides probabilistic relay timing: safety and promptness
    # still bind; complete escape merely stops being an audit failure.
    best = max(honest, key=lambda n: n.block_store.height())
    committed = committed_duplicate_vote_evidence(best)
    for b in byz_nodes:
        if not b.twins:
            continue  # never actually equivocated (strategy inactive/idle)
        hit = committed.get(b.address)
        if hit is None:
            if require_evidence:
                rep.missing_evidence.append(b.index)
            else:
                rep.notes.append(
                    f"equivocator {b.index} escaped (best-effort detection)"
                )
            continue
        commit_h, ev = hit
        rep.evidence_commit_heights[b.address.hex()] = commit_h
        rep.evidence_lag_heights[b.address.hex()] = commit_h - ev.height
        if commit_h - ev.height > k_heights:
            rep.late_evidence.append(
                {
                    "index": b.index,
                    "equivocated_at": ev.height,
                    "committed_at": commit_h,
                    "k": k_heights,
                }
            )

    # 3b: light-client-attack accountability — every expected lunatic
    # signer (addresses from the scenario's LunaticProvider plan) must
    # appear in a committed LightClientAttackEvidence's attribution
    # within K heights of the conflicting (forged) height
    if expect_lca:
        lca = committed_light_client_attack_evidence(best)
        for addr in expect_lca:
            hit = lca.get(addr)
            if hit is None:
                rep.missing_lca.append(addr.hex())
                continue
            commit_h, ev = hit
            rep.lca_commit_heights[addr.hex()] = commit_h
            lag = commit_h - ev.conflicting_height
            rep.lca_lag_heights[addr.hex()] = lag
            if lag > k_heights:
                rep.late_evidence.append(
                    {
                        "lca_signer": addr.hex(),
                        "forged_at": ev.conflicting_height,
                        "committed_at": commit_h,
                        "k": k_heights,
                    }
                )

    # 4: invalid-signature gossip must have COST the traitor on at
    # least one honest node (score drop or ban — the PeerError path)
    for b in byz_nodes:
        if b.action_counts.get("invalid_sig", 0) == 0:
            continue
        penalties = {}
        for n in honest:
            score = n.shell.peer_manager.peer_score(b.node_id)
            if score is not None and score < 0:
                penalties[n.index] = score
        if penalties:
            rep.peer_penalties[b.index] = penalties
        else:
            rep.unpenalized.append(b.index)

    rep.ok = not (
        rep.conflicting_commits
        or rep.app_hash_mismatches
        or rep.missing_evidence
        or rep.late_evidence
        or rep.missing_lca
        or rep.unpenalized
    )
    return rep
