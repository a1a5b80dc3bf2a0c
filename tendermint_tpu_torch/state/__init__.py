"""State & execution layer (reference internal/state/)."""

from .execution import BlockExecutor
from .state import State, state_from_genesis
from .store import ABCIResponses, StateStore
from .validation import BlockValidationError, median_time, validate_block

__all__ = [
    "BlockExecutor",
    "State",
    "state_from_genesis",
    "ABCIResponses",
    "StateStore",
    "BlockValidationError",
    "median_time",
    "validate_block",
]
