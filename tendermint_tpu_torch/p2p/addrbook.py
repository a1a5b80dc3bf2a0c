"""Persistent peer address book (reference internal/p2p/pex/addrbook.go,
simplified: the reference's old/new bucket scheme with hashed bucket
selection collapses to one scored table — the PeerManager already owns
live scoring/backoff state, so the book's job here is durability:
addresses learned via PEX survive restarts, which is what makes a seed
node useful after a reboot).

File format: JSON {"addrs": [{"addr", "persistent", "good", "attempts",
"last_success_ms"}...]}, written atomically (tmp + rename) and debounced. The port's copy of
tendermint_tpu/p2p/addrbook.py: the same file, byte for byte.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time

from .types import NodeAddress

logger = logging.getLogger("addrbook")


class AddressBook:
    def __init__(self, path: str):
        self.path = path
        self._dirty = False
        self._last_save = 0.0

    def load(self) -> list[dict]:
        """Returns entries: {"address": NodeAddress, "persistent": bool,
        "good": bool} — malformed entries are skipped, a corrupt file is
        treated as empty (matching the reference's tolerant loadFromFile)."""
        if not os.path.exists(self.path):
            return []
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("address book unreadable (%r); starting empty", e)
            return []
        out = []
        for rec in doc.get("addrs", []):
            try:
                out.append(
                    {
                        "address": NodeAddress.parse(rec["addr"]),
                        "persistent": bool(rec.get("persistent", False)),
                        "good": bool(rec.get("good", False)),
                    }
                )
            except (ValueError, KeyError, TypeError):
                continue
        return out

    def save(self, entries: list[dict]) -> None:
        """entries: {"address": NodeAddress, "persistent", "good",
        "attempts", "last_success_ms"}."""
        doc = {
            "addrs": [
                {
                    "addr": str(e["address"]),
                    "persistent": bool(e.get("persistent", False)),
                    "good": bool(e.get("good", False)),
                    "attempts": int(e.get("attempts", 0)),
                    "last_success_ms": int(e.get("last_success_ms", 0)),
                }
                for e in entries
            ]
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", prefix=".addrbook-"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError as e:
            logger.warning("address book save failed: %r", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._last_save = time.monotonic()
        self._dirty = False

    def mark_dirty(self) -> None:
        self._dirty = True

    def maybe_save(self, entries_fn, min_interval_s: float = 2.0) -> None:
        """Debounced save: at most one write per min_interval_s."""
        if not self._dirty:
            return
        if time.monotonic() - self._last_save < min_interval_s:
            return
        self.save(entries_fn())
