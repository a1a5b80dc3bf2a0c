"""Node configuration — the port's copy of the one section of
tendermint_tpu/config.py that it reads so far: `VerifyHubConfig`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VerifyHubConfig:
    """VerifyHub — the node-wide micro-batching signature-verification
    scheduler (crypto/verify_hub.py): the defaults of its constructor.
    The reference's TMTPU_VERIFYHUB_* env overrides wait for the node
    config that reads them; its `enabled`, `mesh_scale` and
    `verifyd_sock` wait for the node, the mesh and the verifyd sidecar,
    which are not ported."""

    max_batch: int = 512  # dispatch target (sigs queued)
    window_ms: float = 2.0  # micro-batch window ceiling (adaptive below it)
    cache_size: int = 8192  # verified-(pubkey,msg,sig) LRU entries
