"""Shared enums and constants for the domain types."""

from __future__ import annotations

import enum


class SignedMsgType(enum.IntEnum):
    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


# CommitSig block-id flags (reference types/block.go BlockIDFlag)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

# 64 KB block parts (reference types/params.go:21 BlockPartSizeBytes)
BLOCK_PART_SIZE = 65536

MAX_TOTAL_VOTING_POWER = 2**63 // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2
