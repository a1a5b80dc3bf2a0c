"""The device registry of the sharded verifier: the devices that
`verify._select_kernels` may shard a batch over.

The port of tendermint_tpu/crypto/tpu/mesh.py without its breakers. The
registry enumerates the CUDA devices once (`torch.cuda.device_count()`,
capped by TMTPU_MESH_MAX_DEVICES as the reference reads it: 0 or unset
keeps them all) and logs the count.
There is no per-device breaker, no recovery probe and no degrade to a
smaller mesh: a device that fails its shard makes the dispatch raise.

`_devices` is the cached enumeration. A list set there by hand stands in
for it, as XLA's virtual CPU devices stand in for chips in the
reference's tests: `[torch.device("cuda:0")] * 4` runs four logical
shards on one card, `[torch.device("cpu")] * 8` eight on the host.
Repeats are allowed. `reset()` forgets it.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

logger = logging.getLogger("crypto.mesh")

_lock = threading.Lock()
#: the mesh's devices: the CUDA enumeration, or logical shards set by hand
_devices: list[torch.device] | None = None


def _max_devices() -> int:
    return int(os.environ.get("TMTPU_MESH_MAX_DEVICES", "0"))


def _enumerate() -> list[torch.device]:
    """The CUDA devices, capped (cached; callers hold _lock). Empty, and
    not cached, on a machine without CUDA."""
    global _devices
    if _devices is None:
        if not torch.cuda.is_available():
            return []
        raw_total = torch.cuda.device_count()
        devs = [torch.device("cuda", i) for i in range(raw_total)]
        cap = _max_devices()
        if cap > 0:
            devs = devs[:cap]
        _devices = devs
        logger.info("device mesh: %d device(s) visible, %d in the mesh", raw_total, len(devs))
    return _devices


def device_list() -> list[torch.device]:
    """The mesh: every device a sharded dispatch may span."""
    with _lock:
        return list(_enumerate())


def active_count() -> int:
    return len(device_list())


def devices_for(device: torch.device) -> list[torch.device]:
    """The mesh when all of its devices are of `device`'s type, else [].
    A CPU caller reads only logical CPU shards set by hand and never
    enumerates CUDA; a CUDA caller never gets CPU shards."""
    with _lock:
        devs = list(_devices or []) if device.type == "cpu" else list(_enumerate())
    return devs if all(d.type == device.type for d in devs) else []


def reset() -> None:
    """Forget the enumeration (and any logical shards set by hand)."""
    global _devices
    with _lock:
        _devices = None
