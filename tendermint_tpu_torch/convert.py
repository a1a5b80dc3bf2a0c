"""Carry operands across from the JAX package to the port, and back.

The reference's device steps take numpy operands (its host prep returns
numpy); the port's take torch tensors on a device. These helpers move
exactly the same values across, so both packages compute on identical
inputs:

  batch_eq_operands   the 7-tuple of prepare_batch_eq → `kernel_eq`
  resolved_operands   the 5-tuple of prepare_resolved → `kernel_sig`
  limbs / point       (..., 32) limb arrays and 4-coordinate points
  to_numpy / point_to_numpy   back to numpy
  validator_set       [(pubkey bytes, power), ...] → ValidatorSet

and the chain's state from the reference's types to the port's, through
the wire encodings both packages share (the reference's bytes decoded by
the port), so a chain built by one package replays in the other:

  block, commit, valset, state   Block, Commit, ValidatorSet, State
  genesis                        GenesisDoc (through its JSON)
  block_store                    every block and commit of a BlockStore
  state_store                    every key of a StateStore (sets by height)
  light_block, signed_header     LightBlock, SignedHeader
  hop_proof                      a LightD HopProof (aggregate or per-sig)
  evidence                       DuplicateVote / LightClientAttack evidence
  vote, proposal                 Vote, Proposal
  wal_dir                        a consensus WAL directory (a plain copy:
                                 both packages write the same bytes)

and back: `to_reference(obj, ref_cls)` for any of those types (with the
reference's class passed in), `evidence_to(ev, decode_evidence)` for
evidence (with the other package's decoder), so this module imports
nothing of the reference. Every key type crosses, bls12381 validator
sets, aggregate commits and genesis docs with proofs of possession
included.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.cuda.curve import Point
from .crypto.cuda.verify import _to_device
from .device import DEFAULT_DEVICE, resolve


def batch_eq_operands(ops, device=DEFAULT_DEVICE) -> tuple[torch.Tensor, ...]:
    """(ua_bytes, r_bytes, ga_digits, r_digits, zs_digits, s_valid, gidx)."""
    if len(ops) != 7:
        raise ValueError("prepare_batch_eq gives 7 operands")
    dev = resolve(device)
    return _to_device(ops, dev)


def resolved_operands(ops, device=DEFAULT_DEVICE) -> tuple[torch.Tensor, ...]:
    """(a_bytes, r_bytes, s_digits, h_digits, s_valid)."""
    if len(ops) != 5:
        raise ValueError("prepare_resolved gives 5 operands")
    dev = resolve(device)
    return _to_device(ops, dev)


def limbs(a, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(..., 32) limb array → int32 tensor."""
    return _to_device([np.asarray(a, dtype=np.int32)], resolve(device))[0]


def point(p, device=DEFAULT_DEVICE) -> Point:
    """A 4-coordinate point (any sequence of limb arrays) → Point."""
    return Point(*(limbs(c, device) for c in p))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def point_to_numpy(p: Point) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(c) for c in p)


def validator_set(pairs):
    """[(ed25519 pubkey bytes, voting power), ...] → the port's
    ValidatorSet (which orders them as the reference does)."""
    from .crypto.ed25519 import Ed25519PubKey
    from .types.validator_set import Validator, ValidatorSet

    return ValidatorSet([Validator(Ed25519PubKey(pk), power) for pk, power in pairs])


def block(ref_block):
    """The reference's Block → the port's (decoded from its encoding)."""
    from .types.block import Block

    return Block.decode(ref_block.encode())


def commit(ref_commit):
    from .types.block import Commit

    return Commit.decode(ref_commit.encode())


def valset(ref_vals):
    """The reference's ValidatorSet → the port's, proposer priorities and
    the current proposer included."""
    from .types.validator_set import ValidatorSet

    return ValidatorSet.decode(ref_vals.encode())


def state(ref_state):
    from .state.state import State

    return State.decode(ref_state.encode())


def genesis(ref_genesis):
    from .types.genesis import GenesisDoc

    return GenesisDoc.from_json(ref_genesis.to_json())


def block_store(ref_store, db=None):
    """Every block of the reference's BlockStore, with its part set and
    its seen commit, saved into a new port BlockStore (on `db`, a MemDB
    by default)."""
    from .store.blockstore import BlockStore
    from .store.db import MemDB

    out = BlockStore(db if db is not None else MemDB())
    for h in range(ref_store.base(), ref_store.height() + 1):
        b = block(ref_store.load_block(h))
        out.save_block(b, b.make_part_set(), commit(ref_store.load_seen_commit(h)))
    return out


def state_store(ref_store, db=None):
    """The reference's StateStore → the port's: every key of its DB (the
    state blob, validator sets, params and ABCI responses by height, whose
    bytes both packages share) copied into a new port StateStore (on
    `db`, a MemDB by default)."""
    from .state.store import StateStore
    from .store.db import MemDB

    out = StateStore(db if db is not None else MemDB())
    for key, value in ref_store.db.iterate():
        out.db.set(key, value)
    return out


def light_block(ref_lb):
    """The reference's LightBlock → the port's."""
    from .light.types import LightBlock

    return LightBlock.decode(ref_lb.encode())


def signed_header(ref_sh):
    from .light.types import SignedHeader

    return SignedHeader.decode(ref_sh.encode())


def hop_proof(ref_proof):
    """The reference's light.fleet.HopProof → the port's, so that the
    port re-verifies a proof the reference's LightD served."""
    from .light.fleet import HopProof

    return HopProof.decode(ref_proof.encode())


def evidence(ref_ev):
    """The reference's evidence (either kind) → the port's."""
    from .types.evidence import decode_evidence

    return decode_evidence(ref_ev.encode())


def vote(ref_vote):
    """The reference's Vote → the port's."""
    from .types.vote import Vote

    return Vote.decode(ref_vote.encode())


def proposal(ref_proposal):
    """The reference's Proposal → the port's."""
    from .types.vote import Proposal

    return Proposal.decode(ref_proposal.encode())


def wal_dir(src: str, dst: str) -> str:
    """Copy the consensus WAL in directory `src` (the reference's node
    wrote it) to `dst`, file for file: both packages write and read the
    same WAL bytes, so a port node started on `dst` replays it."""
    import os
    import shutil

    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        path = os.path.join(src, name)
        if os.path.isfile(path):
            shutil.copyfile(path, os.path.join(dst, name))
    return dst


def evidence_to(ev, decode_evidence):
    """Evidence of one package → the other's, through the shared wire
    bytes: `decode_evidence` is the receiving package's decoder (the
    reference's `types.evidence.decode_evidence` to carry the port's
    evidence back)."""
    return decode_evidence(ev.encode())


def to_reference(obj, ref_cls):
    """One of the port's wire types (Block, Commit, ValidatorSet, State,
    LightBlock, SignedHeader, HopProof, Vote, Proposal; GenesisDoc through
    its JSON) -> the
    reference's `ref_cls`, decoded from the bytes both packages share."""
    if hasattr(ref_cls, "from_json"):
        return ref_cls.from_json(obj.to_json())
    return ref_cls.decode(obj.encode())
