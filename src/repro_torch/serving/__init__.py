from .engine import (  # noqa: F401
    Engine,
    EngineConfig,
    Request,
    SlotServer,
    SlotStats,
)
