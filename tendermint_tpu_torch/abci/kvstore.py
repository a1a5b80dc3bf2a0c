"""Example kvstore application (reference abci/example/kvstore/kvstore.go:66
and persistent_kvstore.go:38, plus the snapshot support of the e2e app
test/e2e/app/{app,snapshots}.go).

Tx format: `key=value` stores a pair; `val:<hex ed25519 pubkey>!<power>`
(or typed: `val:<keytype>:<hex pubkey>!<power>[!<hex pop>]`) requests a
validator-set change at EndBlock (power 0 removes; bls12381 joins must
carry a valid proof of possession or the tx is rejected). App hash is
the SHA-256 of the deterministic encoding of the full kv state, so two
replicas agree iff their states agree. Snapshots serialize the state into
fixed-size chunks keyed by (height, format, chunk). The port's copy of
tendermint_tpu/abci/kvstore.py."""

from __future__ import annotations

import json

from ..crypto.hashes import sha256
from ..store.db import DB, MemDB
from . import types as abci
from .application import BaseApplication

VALIDATOR_TX_PREFIX = b"val:"
SNAPSHOT_CHUNK_SIZE = 65536
SNAPSHOT_FORMAT = 1

_STATE_KEY = b"__kvstore_state__"


def _sorted_leaves(items: dict[bytes, bytes]) -> list[bytes]:
    from ..crypto import merkle

    return [merkle.kv_leaf(k, v) for k, v in sorted(items.items())]


def _state_hash(items: dict[bytes, bytes]) -> bytes:
    """RFC 6962 merkle root over the sorted (key, value) pairs — so
    `abci_query(prove=True)` can return an inclusion proof that the light
    RPC client checks against a verified header's app_hash. Deliberately
    NOT height-salted: an empty block must leave the app hash unchanged,
    or consensus's needProofBlock would force a proof block after every
    empty block (reference kvstore hashes tree size, same property)."""
    from ..crypto import merkle

    return merkle.hash_from_byte_slices(_sorted_leaves(items))


class KVStoreApp(BaseApplication):
    def __init__(
        self,
        db: DB | None = None,
        *,
        retain_blocks: int = 0,
        snapshot_interval: int = 10,
    ):
        self.db = db or MemDB()
        self.retain_blocks = retain_blocks
        self.snapshot_interval = max(1, snapshot_interval)
        self.items: dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b""
        self.initial_height = 1
        self._staged: dict[bytes, bytes] = {}
        self._val_updates: list[abci.ValidatorUpdate] = []
        self.validators: dict[bytes, int] = {}  # pubkey -> power
        self._snapshots: list[abci.Snapshot] = []
        self._snapshot_data: dict[tuple[int, int], bytes] = {}
        self._restore_chunks: list[bytes] | None = None
        self._restore_target: abci.Snapshot | None = None
        self._proof_cache: dict[bytes, object] | None = None
        self._load()

    # -- persistence ------------------------------------------------------

    def _load(self) -> None:
        raw = self.db.get(_STATE_KEY)
        if raw is None:
            return
        d = json.loads(raw)
        self.items = {bytes.fromhex(k): bytes.fromhex(v) for k, v in d["items"].items()}
        self.height = d["height"]
        self.app_hash = bytes.fromhex(d["app_hash"])
        self.validators = {
            bytes.fromhex(k): p for k, p in d.get("validators", {}).items()
        }

    def _save(self) -> None:
        self.db.set(
            _STATE_KEY,
            json.dumps(
                {
                    "items": {k.hex(): v.hex() for k, v in self.items.items()},
                    "height": self.height,
                    "app_hash": self.app_hash.hex(),
                    "validators": {k.hex(): p for k, p in self.validators.items()},
                }
            ).encode(),
        )

    # -- info/query -------------------------------------------------------

    def info(self, req):
        return abci.ResponseInfo(
            data=json.dumps({"size": len(self.items)}),
            version="kvstore-tpu/1",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req):
        if req.path == "/val":
            power = self.validators.get(req.data, 0)
            return abci.ResponseQuery(key=req.data, value=str(power).encode())
        value = self.items.get(req.data)
        if value is None:
            return abci.ResponseQuery(code=1, key=req.data, log="does not exist")
        proof_ops: tuple = ()
        if req.prove:
            from ..crypto import merkle

            if self._proof_cache is None:
                # built once per committed height (commit() invalidates),
                # not per query — a proven point lookup is then O(1)
                keys = sorted(self.items)
                _, proofs = merkle.proofs_from_byte_slices(
                    _sorted_leaves(self.items)
                )
                self._proof_cache = dict(zip(keys, proofs))
            proof_ops = (merkle.value_op(req.data, self._proof_cache[req.data]),)
        return abci.ResponseQuery(
            key=req.data, value=value, height=self.height, proof_ops=proof_ops
        )

    # -- mempool ----------------------------------------------------------

    def check_tx(self, req):
        if req.tx.startswith(VALIDATOR_TX_PREFIX):
            try:
                self._parse_validator_tx(req.tx)
            except ValueError as e:
                return abci.ResponseCheckTx(code=2, log=str(e))
            return abci.ResponseCheckTx(gas_wanted=1)
        if not req.tx or req.tx.count(b"=") > 1:
            return abci.ResponseCheckTx(code=1, log="tx must be key=value")
        return abci.ResponseCheckTx(gas_wanted=1)

    # -- consensus --------------------------------------------------------

    def init_chain(self, req):
        self.initial_height = req.initial_height
        for vu in req.validators:
            self.validators[vu.pub_key] = vu.power
        if req.app_state_bytes and req.app_state_bytes != b"{}":
            for k, v in json.loads(req.app_state_bytes).items():
                self.items[k.encode()] = v.encode()
        self._save()
        return abci.ResponseInitChain()

    def begin_block(self, req):
        self._staged = {}
        self._val_updates = []
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req):
        if req.tx.startswith(VALIDATOR_TX_PREFIX):
            try:
                vu = self._parse_validator_tx(req.tx)
            except ValueError as e:
                return abci.ResponseDeliverTx(code=2, log=str(e))
            self._val_updates.append(vu)
            return abci.ResponseDeliverTx(
                events=(
                    abci.Event(
                        "val_update",
                        (abci.EventAttribute("power", str(vu.power), True),),
                    ),
                )
            )
        if b"=" in req.tx:
            key, value = req.tx.split(b"=", 1)
        else:
            key = value = req.tx
        self._staged[key] = value
        ev = abci.Event(
            "app",
            (
                abci.EventAttribute("creator", "kvstore", True),
                abci.EventAttribute("key", key.decode(errors="replace"), True),
            ),
        )
        return abci.ResponseDeliverTx(data=value, events=(ev,))

    def end_block(self, req):
        self.height = req.height
        for vu in self._val_updates:
            if vu.power == 0:
                self.validators.pop(vu.pub_key, None)
            else:
                self.validators[vu.pub_key] = vu.power
        return abci.ResponseEndBlock(validator_updates=tuple(self._val_updates))

    def commit(self):
        self.items.update(self._staged)
        self._staged = {}
        self._proof_cache = None
        self.app_hash = _state_hash(self.items)
        self._save()
        self._take_snapshot()
        retain = 0
        if self.retain_blocks and self.height >= self.retain_blocks:
            retain = self.height - self.retain_blocks + 1
        return abci.ResponseCommit(data=self.app_hash, retain_height=retain)

    @staticmethod
    def _parse_validator_tx(tx: bytes) -> abci.ValidatorUpdate:
        """`val:<hex pubkey>!<power>` (legacy, ed25519) or
        `val:<keytype>:<hex pubkey>!<power>[!<hex pop>]`.

        bls12381 joins (power > 0) MUST carry a valid proof of
        possession: rejecting the rogue key HERE — CheckTx keeps it out
        of mempools, DeliverTx returns code 2 — is what keeps the
        state/execution.validator_updates_to_validators backstop from
        ever firing inside apply_block (where a raise would wedge every
        replica). The app layer is the live PoP-on-update defense; the
        execution check is the invariant of last resort."""
        body = tx[len(VALIDATOR_TX_PREFIX) :]
        if b"!" not in body:
            raise ValueError("validator tx must be val:<hex pubkey>!<power>")
        key_part, _, rest = body.partition(b"!")
        if b":" in key_part:
            type_b, _, pk_hex = key_part.partition(b":")
            key_type = type_b.decode(errors="replace")
        else:
            key_type, pk_hex = "ed25519", key_part
        power_s, _, pop_hex = rest.partition(b"!")
        try:
            pub_key = bytes.fromhex(pk_hex.decode())
            power = int(power_s)
            pop = bytes.fromhex(pop_hex.decode()) if pop_hex else b""
        except Exception:
            raise ValueError("bad validator tx encoding") from None
        if power < 0:
            raise ValueError("negative power")
        from .. import crypto

        try:
            pub = crypto.pubkey_from_type_and_bytes(key_type, pub_key)
        except Exception as e:
            raise ValueError(f"bad validator pubkey: {e}") from None
        if power > 0 and key_type == "bls12381":
            if not pop or not pub.pop_verify(pop):
                raise ValueError(
                    "bls12381 validator join without a valid proof of "
                    "possession"
                )
        return abci.ValidatorUpdate(key_type, pub_key, power, pop)

    # -- snapshots --------------------------------------------------------

    def _take_snapshot(self) -> None:
        if self.height % self.snapshot_interval != 0:  # snapshot cadence
            return
        blob = json.dumps(
            {
                "items": {k.hex(): v.hex() for k, v in self.items.items()},
                "height": self.height,
                "validators": {k.hex(): p for k, p in self.validators.items()},
            }
        ).encode()
        chunks = [
            blob[i : i + SNAPSHOT_CHUNK_SIZE]
            for i in range(0, max(len(blob), 1), SNAPSHOT_CHUNK_SIZE)
        ]
        snap = abci.Snapshot(
            height=self.height,
            format=SNAPSHOT_FORMAT,
            chunks=len(chunks),
            hash=sha256(blob),
        )
        self._snapshots.append(snap)
        for i, c in enumerate(chunks):
            self._snapshot_data[(self.height, i)] = c
        for evicted in self._snapshots[:-5]:
            for i in range(evicted.chunks):
                self._snapshot_data.pop((evicted.height, i), None)
        self._snapshots = self._snapshots[-5:]

    def list_snapshots(self):
        return abci.ResponseListSnapshots(tuple(self._snapshots))

    def offer_snapshot(self, req):
        if req.snapshot.format != SNAPSHOT_FORMAT:
            return abci.ResponseOfferSnapshot(
                abci.OfferSnapshotResult.REJECT_FORMAT
            )
        self._restore_target = req.snapshot
        self._restore_chunks = []
        return abci.ResponseOfferSnapshot(abci.OfferSnapshotResult.ACCEPT)

    def load_snapshot_chunk(self, req):
        if req.format != SNAPSHOT_FORMAT:
            return abci.ResponseLoadSnapshotChunk(b"")
        return abci.ResponseLoadSnapshotChunk(
            self._snapshot_data.get((req.height, req.chunk), b"")
        )

    def apply_snapshot_chunk(self, req):
        assert self._restore_chunks is not None and self._restore_target is not None
        self._restore_chunks.append(req.chunk)
        if len(self._restore_chunks) < self._restore_target.chunks:
            return abci.ResponseApplySnapshotChunk(
                abci.ApplySnapshotChunkResult.ACCEPT
            )
        blob = b"".join(self._restore_chunks)
        if sha256(blob) != self._restore_target.hash:
            self._restore_chunks = None
            self._restore_target = None
            return abci.ResponseApplySnapshotChunk(
                abci.ApplySnapshotChunkResult.REJECT_SNAPSHOT
            )
        d = json.loads(blob)
        self.items = {bytes.fromhex(k): bytes.fromhex(v) for k, v in d["items"].items()}
        self.height = d["height"]
        self.validators = {bytes.fromhex(k): p for k, p in d["validators"].items()}
        self.app_hash = _state_hash(self.items)
        self._proof_cache = None
        self._save()
        self._restore_chunks = None
        self._restore_target = None
        return abci.ResponseApplySnapshotChunk(abci.ApplySnapshotChunkResult.ACCEPT)
