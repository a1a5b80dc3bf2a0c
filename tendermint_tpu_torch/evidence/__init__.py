"""Evidence pool interface (reference internal/evidence/pool.go:30).

The concrete pool lives in evidence/pool.py; `NopEvidencePool` keeps the
block executor testable without one."""

from __future__ import annotations

EVIDENCE_CHANNEL = 0x38


class EvidencePoolI:
    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """Evidence ready for inclusion in a proposal, with its total size."""
        raise NotImplementedError

    def check_evidence(self, evidence: tuple) -> None:
        """Verify block evidence; raises on invalid (reference verify.go:24)."""
        raise NotImplementedError

    def update(self, state, evidence: tuple) -> None:
        """Mark committed evidence and prune expired."""
        raise NotImplementedError

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """Consensus saw an equivocation; buffer it until the pool can
        stamp it with the committed height/time (reference
        pool.go:188 ReportConflictingVotes)."""
        raise NotImplementedError


class NopEvidencePool(EvidencePoolI):
    def pending_evidence(self, max_bytes):
        return [], 0

    def check_evidence(self, evidence):
        pass

    def update(self, state, evidence):
        pass

    def report_conflicting_votes(self, vote_a, vote_b):
        pass
