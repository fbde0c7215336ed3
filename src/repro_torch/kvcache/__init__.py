"""Two-tier KV serving: the ETICA manager and the global-LRU baseline."""
from .manager import (Session, Stats, TwoTierConfig, TwoTierKVManager,
                      quota_with_floor)
from .baseline import GlobalLRUManager

__all__ = ["GlobalLRUManager", "Session", "Stats", "TwoTierConfig",
           "TwoTierKVManager", "quota_with_floor"]
