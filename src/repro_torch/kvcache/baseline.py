"""Baseline KV manager for comparison: :class:`GlobalLRUManager`.

The conventional design (the PyTorch counterpart of
:mod:`repro.kvcache.baseline`): one global LRU over the pool, no
per-tenant partitioning, push mode — every activation promotes, and
every capacity eviction writes the page back to the host although a copy
exists (the datapath write-back the paper's WB policy implies).
"""
from __future__ import annotations

import numpy as np

from .manager import TwoTierConfig, TwoTierKVManager


class GlobalLRUManager(TwoTierKVManager):
    """LRU + write-back eviction + no partitioning."""

    def __init__(self, cfg: TwoTierConfig, num_tenants: int, device="cuda"):
        # no maintenance runs, so the device popularity table is not needed
        super().__init__(cfg, num_tenants, batched=False, device=device)
        self._clock = 0
        self._slot_time: dict[int, int] = {}

    def _alloc_slot(self, sid: int, lp: int) -> int:
        slot = super()._alloc_slot(sid, lp)
        self._slot_time[slot] = self._clock
        self._clock += 1
        return slot

    def _evict_one(self, exclude_sid: int):
        cands = [(self._slot_time.get(slot, 0), slot, sid, lp)
                 for slot, (sid, lp) in self.slot_owner.items()
                 if sid != exclude_sid]
        if not cands:
            raise RuntimeError("HBM pool exhausted by a single session")
        _, slot, sid, lp = min(cands)
        # WB-style datapath write-back on eviction (the wear the WBWO
        # assignment avoids)
        self.stats.dma_write_bytes += self.cfg.page_bytes
        self.stats.latency_s += self.cfg.page_bytes / 8e9
        self._release_slot(sid, lp)

    def activate(self, sid: int) -> np.ndarray:
        sess = self.sessions[sid]
        for lp in sess.pages:
            if lp in sess.hbm_slots:
                self._slot_time[sess.hbm_slots[lp]] = self._clock
                self._clock += 1
        return super().activate(sid)

    # no POD repartitioning, no popularity maintenance
    def _maintenance_tick(self, active_sid: int | None = None):
        pass
