from .logging import StageTimer, log
from .sync import fence

__all__ = ["StageTimer", "log", "fence"]
