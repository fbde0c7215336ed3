"""Cache write-policy semantics (paper §3).

Five policies appear in the paper; their datapath semantics are summarized
by three predicates used uniformly by the reuse-distance engine and the
simulators:

  * ``allocates_reads``  — does a read miss insert the block into the cache?
  * ``allocates_writes`` — does a write (miss) insert the block into the cache?
  * ``write_invalidates`` — does a write remove/invalidate a cached copy
    (instead of updating it in place)?

====== ================= ================== =================
policy allocates_reads   allocates_writes   write_invalidates
====== ================= ================== =================
WB     yes               yes                no
WT     yes               yes                no
RO     yes               no                 yes
WO     no                yes                no
WBWO   no                yes                no
====== ================= ================== =================

WT differs from WB only in that writes are *also* committed to the backing
store immediately (reliability), which the simulators account for in the
latency/endurance model, not in the content model. WBWO ("WB and WO") is
the paper's name for the write-only-allocating write-back cache used at
ETICA's SSD level; WO is retained as an alias with identical content
semantics.
"""
from __future__ import annotations

import enum


class Policy(enum.Enum):
    WB = "WB"
    WT = "WT"
    RO = "RO"
    WO = "WO"
    WBWO = "WBWO"

    # ---- content-model predicates -------------------------------------
    @property
    def allocates_reads(self) -> bool:
        return self in (Policy.WB, Policy.WT, Policy.RO)

    @property
    def allocates_writes(self) -> bool:
        return self in (Policy.WB, Policy.WT, Policy.WO, Policy.WBWO)

    @property
    def write_invalidates(self) -> bool:
        return self is Policy.RO

    # ---- reliability/latency-model predicates -------------------------
    @property
    def write_through(self) -> bool:
        """Writes are synchronously committed to the backing store."""
        return self in (Policy.WT, Policy.RO)

    @property
    def holds_dirty(self) -> bool:
        """The cache may hold write-pending (dirty) blocks."""
        return self in (Policy.WB, Policy.WO, Policy.WBWO)


# Device latency model (paper Fig. 1 device ratios: HDD:SSD:DRAM IOPS of
# roughly 1 : 500 : 10,000 for 4KB random accesses). Units: seconds/block.
# Disk WRITES are absorbed by the RAID controller's battery-backed write
# cache (the paper's testbed uses an LSI9361i), so they cost far less
# than a random-read seek — still ~50x slower than the SSD tier.
T_DRAM = 0.5e-6
T_SSD = 10e-6
T_HDD = 5e-3          # random read (seek-bound)
T_HDD_WRITE = 0.5e-3  # controller-buffered write


class Level(enum.IntEnum):
    """Where a request was served from."""
    DRAM = 0
    SSD = 1
    DISK = 2


LEVEL_LATENCY = {Level.DRAM: T_DRAM, Level.SSD: T_SSD, Level.DISK: T_HDD}
