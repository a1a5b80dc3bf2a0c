"""Byzantine statesync donors — the BootFleet fault axis (the port's copy
of tendermint_tpu/statesync/byzantine.py).

Mirrors the containment pattern of `light/byzantine.py` and
`consensus/byzantine.py`: the strategy layer lives HERE and is injected
into a net from the outside (scenario app_factory / test fixture);
nothing under `statesync/` imports it on the serving or joining path.

`PoisonedSnapshotApp` models the donor the restore pipeline must
survive: its chain, its snapshot OFFERS (heights/hashes/metadata) and
its light blocks are all honest — only the chunk BYTES it serves are
corrupted. That is the worst case for a joiner: the offer passes light
verification (the app hash really is pinned by the verified header at
h+1), every frame decodes, and the fraud is only detectable when the
app's whole-blob hash check rejects the restored state. The reactor
must then cost the serving peer a `PeerError(ban=True)` and move to the
next candidate snapshot — never wedge, never bootstrap from the
poisoned state."""

from __future__ import annotations

import random

from ..abci import types as abci
from ..abci.kvstore import KVStoreApp


class PoisonedSnapshotApp(KVStoreApp):
    """KVStore donor that serves corrupted snapshot chunks.

    `corrupt_rate` poisons that fraction of served chunks (1.0 = every
    chunk), drawn from a generator seeded with (seed, height, chunk) so
    two same-seed runs poison the same chunks. Corruption flips one
    byte mid-chunk: the frame still decodes, the length still matches —
    only the restored state hash can catch it."""

    def __init__(self, *args, seed: int = 0, corrupt_rate: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = seed
        self.corrupt_rate = corrupt_rate
        self.poisoned_served = 0

    def load_snapshot_chunk(self, req):
        res = super().load_snapshot_chunk(req)
        chunk = res.chunk
        if not chunk:
            return res
        rng = random.Random(f"poison:{self.seed}:{req.height}:{req.chunk}")
        if rng.random() >= self.corrupt_rate:
            return res
        pos = rng.randrange(len(chunk))
        poisoned = chunk[:pos] + bytes([chunk[pos] ^ 0x5A]) + chunk[pos + 1 :]
        self.poisoned_served += 1
        return abci.ResponseLoadSnapshotChunk(poisoned)
