from .batch import BatchEngine, CapacityError, EngineStats
from .book import (
    BookConfig,
    BookState,
    DeviceOp,
    StepOutput,
    grow_books,
    grow_lanes,
    init_books,
)
from .orchestrator import MatchEngine
from .step import step, step_rows

__all__ = [
    "BatchEngine",
    "CapacityError",
    "EngineStats",
    "MatchEngine",
    "BookConfig",
    "BookState",
    "DeviceOp",
    "StepOutput",
    "grow_books",
    "grow_lanes",
    "init_books",
    "step",
    "step_rows",
]
