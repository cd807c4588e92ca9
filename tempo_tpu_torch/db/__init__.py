from .blocklist import Blocklist
from .poller import Poller
from .tempodb import TempoDB, TempoDBConfig

__all__ = ["TempoDB", "TempoDBConfig", "Blocklist", "Poller"]
