"""The baselines the paper compares ETICA against (§2, Table 1).

The PyTorch counterpart of :mod:`repro.core.baselines`. The one-level
baselines share the :class:`~repro_torch.core.controller
.PartitionedSingleLevelCache` chassis and differ in sizing metric and
write policy:

  * ECI-Cache   — URD sizing, per-VM WB/RO from the read ratio (the
    paper's main comparison, fig. 12 and fig. 14);
  * Centaur     — TRD sizing, WB;
  * S-CAVE      — working-set-size sizing, WT;
  * vCacheShare — reuse-intensity sizing, RO.

A :class:`~repro_torch.core.reuse.SizingMetric` (re-exported here) sizes
every VM in one batched pass
(:func:`repro_torch.core.reuse.sizing_metrics_batch`); its ``ref`` is
the reference's per-VM closure (``*_metric_ref``), which the sequential
chassis (``batched=False``) runs, bit-identically. :func:`eci_policy`
carries the same two forms.

The global (non-partitioned) two-level baselines :class:`FastCache` and
:class:`L2ARCCache` run one stream over single ``[S, W]`` states through
the two-level datapath at V = 1 and promote with ``promote_blocks``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import reuse
from repro_torch.core.controller import (Geometry, MetricFn,
                                         PartitionedSingleLevelCache,
                                         PolicyChooser, SingleLevelConfig,
                                         VMResult, _acc_one, _mrc_grid, _pad)
from repro_torch.core.policies import Policy
from repro_torch.core.reuse import SizingMetric
from repro_torch.core.simulator import (capacity_to_ways, make_cache,
                                        promote_blocks, resident_blocks,
                                        simulate_two_level)
from repro_torch.core.trace import Trace
from repro_torch.kernels import resolve_device


# ---------------------------------------------------------------------------
# sizing metrics — sequential per-VM closures (the *_ref oracles)
# ---------------------------------------------------------------------------

def _metric_from_dist(r, n: int, geom: Geometry, points: int):
    grid = _mrc_grid(geom, points)
    hits = reuse.hit_counts_at_sizes(r.dist, r.served, grid)
    curve = np.asarray(hits, np.float64) / max(n, 1)
    return reuse.demand_blocks(int(r.max)), grid, curve


def urd_metric_ref(geom: Geometry, points: int = 17,
                   device="cuda") -> MetricFn:
    def metric(sub: Trace):
        r = reuse.urd_distances(sub.addr, sub.is_write, device)
        return _metric_from_dist(r, len(sub), geom, points)
    return metric


def trd_metric_ref(geom: Geometry, points: int = 17,
                   device="cuda") -> MetricFn:
    def metric(sub: Trace):
        r = reuse.trd_distances(sub.addr, sub.is_write, device)
        return _metric_from_dist(r, len(sub), geom, points)
    return metric


def wss_metric_ref(geom: Geometry, points: int = 17,
                   device="cuda") -> MetricFn:
    """S-CAVE: demand = distinct blocks touched; the TRD curve for
    partitioning."""
    def metric(sub: Trace):
        wss = int(np.unique(np.asarray(sub.addr)).size)
        r = reuse.trd_distances(sub.addr, sub.is_write, device)
        _, grid, curve = _metric_from_dist(r, len(sub), geom, points)
        return wss, grid, curve
    return metric


def reuse_intensity_metric_ref(geom: Geometry, points: int = 17,
                               device="cuda") -> MetricFn:
    """vCacheShare: distinct re-referenced read blocks; the POD(RO)
    curve."""
    def metric(sub: Trace):
        addr = np.asarray(sub.addr)
        rd = addr[~np.asarray(sub.is_write)]
        _, cnt = np.unique(rd, return_counts=True)
        rereferenced = int((cnt > 1).sum())
        r = reuse.pod_distances(sub.addr, sub.is_write, Policy.RO, device)
        _, grid, curve = _metric_from_dist(r, len(sub), geom, points)
        return rereferenced, grid, curve
    return metric


# ---------------------------------------------------------------------------
# sizing metrics in both forms
# ---------------------------------------------------------------------------

def urd_metric(geom: Geometry, points: int = 17,
               device="cuda") -> SizingMetric:
    """ECI-Cache: max reuse distance over read re-references, + 1."""
    return SizingMetric("urd", _mrc_grid(geom, points),
                        urd_metric_ref(geom, points, device))


def trd_metric(geom: Geometry, points: int = 17,
               device="cuda") -> SizingMetric:
    """Centaur: max reuse distance over every re-access, + 1."""
    return SizingMetric("trd", _mrc_grid(geom, points),
                        trd_metric_ref(geom, points, device))


def wss_metric(geom: Geometry, points: int = 17,
               device="cuda") -> SizingMetric:
    """S-CAVE: distinct blocks touched (TRD curve for partitioning)."""
    return SizingMetric("wss", _mrc_grid(geom, points),
                        wss_metric_ref(geom, points, device))


def reuse_intensity_metric(geom: Geometry, points: int = 17,
                           device="cuda") -> SizingMetric:
    """vCacheShare: distinct re-referenced read blocks (POD(RO) curve)."""
    return SizingMetric("reuse_intensity", _mrc_grid(geom, points),
                        reuse_intensity_metric_ref(geom, points, device))


def eci_policy(read_heavy_threshold: float = 0.8) -> PolicyChooser:
    """ECI-Cache gives RO to read-dominated VMs (endurance) and WB to
    the rest (performance): from the batched sizing pass's read counts,
    or per VM from its sub-trace (``ref``)."""
    def from_ratio(read_ratio: float) -> Policy:
        return (Policy.RO if read_ratio >= read_heavy_threshold
                else Policy.WB)

    def chooser(sub: Trace) -> Policy:
        return from_ratio(sub.n_reads / max(len(sub), 1))

    return PolicyChooser(from_read_ratio=from_ratio, ref=chooser)


def fixed_policy(p: Policy):
    return lambda sub: p


def make_eci_cache(capacity: int, num_vms: int,
                   geometry: Geometry | None = None,
                   resize_interval: int = 10_000, device="cuda",
                   **kw) -> PartitionedSingleLevelCache:
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry,
                            resize_interval=resize_interval, **kw)
    return PartitionedSingleLevelCache(
        cfg, num_vms, urd_metric(geometry, device=device), eci_policy(),
        device)


def make_centaur(capacity: int, num_vms: int,
                 geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(
        cfg, num_vms, trd_metric(geometry, device=device),
        fixed_policy(Policy.WB), device)


def make_scave(capacity: int, num_vms: int,
               geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(
        cfg, num_vms, wss_metric(geometry, device=device),
        fixed_policy(Policy.WT), device)


def make_vcacheshare(capacity: int, num_vms: int,
                     geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(
        cfg, num_vms, reuse_intensity_metric(geometry, device=device),
        fixed_policy(Policy.RO), device)


# ---------------------------------------------------------------------------
# global (non-partitioned) two-level baselines — Table 1's FAST and L2ARC,
# reduced to their content policies over the two-level datapath
# ---------------------------------------------------------------------------

class FastCache:
    """Dell EMC FAST-style global two-level cache: DRAM(WB) + SSD(WB),
    blocks with > ``hot_threshold`` accesses in the last window promoted
    to the SSD, no eviction rule beyond LRU (paper §2.2.2)."""

    def __init__(self, dram_capacity: int, ssd_capacity: int,
                 geometry: Geometry | None = None, window: int = 1_000,
                 hot_threshold: int = 3, device="cuda"):
        self.geom = geometry or Geometry()
        self.device = resolve_device(device)
        g = self.geom
        self.dram = make_cache(g.num_sets, g.max_ways, self.device)
        self.ssd = make_cache(g.num_sets, g.max_ways, self.device)
        self.wd = int(capacity_to_ways(dram_capacity, g.num_sets, g.max_ways))
        self.ws = int(capacity_to_ways(ssd_capacity, g.num_sets, g.max_ways))
        self.window = window
        self.hot_threshold = hot_threshold
        self.stats: dict = {}
        self.t = 0

    def run(self, trace: Trace) -> VMResult:
        for win in trace.intervals(self.window):
            a, w = _pad(np.asarray(win.addr, np.int32),
                        np.asarray(win.is_write), self.window)
            # NPE-mode two-level datapath approximates WB+WB content flow
            self.dram, self.ssd, st, t_end = simulate_two_level(
                a, w, self.dram, self.ssd, self.wd, self.ws, mode="npe",
                t0=self.t)
            self.t = int(t_end)
            _acc_one(self.stats, st)
            # FAST promotion: > threshold accesses in the window
            uniq, counts = np.unique(np.asarray(win.addr),
                                     return_counts=True)
            hot = uniq[counts > self.hot_threshold]
            hot = hot[~np.isin(hot, resident_blocks(self.ssd, self.ws))]
            if hot.size:
                self.ssd, n = promote_blocks(self.ssd, hot, self.ws, self.t)
                self.stats["cache_writes_l2"] = (
                    self.stats.get("cache_writes_l2", 0.0) + int(n))
        return VMResult(dict(self.stats), np.zeros(1, np.int64))


def make_fast(dram_capacity: int, ssd_capacity: int, **kw) -> FastCache:
    return FastCache(dram_capacity, ssd_capacity, **kw)


class L2ARCCache:
    """ZFS L2ARC-style global two-level cache (paper §2.2.2): a DRAM read
    cache whose evictions are pushed into the SSD; writes bypass both
    levels; no popularity logic."""

    def __init__(self, dram_capacity: int, ssd_capacity: int,
                 geometry: Geometry | None = None, window: int = 1_000,
                 device="cuda"):
        self.geom = geometry or Geometry()
        self.device = resolve_device(device)
        g = self.geom
        self.dram = make_cache(g.num_sets, g.max_ways, self.device)
        self.ssd = make_cache(g.num_sets, g.max_ways, self.device)
        self.wd = int(capacity_to_ways(dram_capacity, g.num_sets, g.max_ways))
        self.ws = int(capacity_to_ways(ssd_capacity, g.num_sets, g.max_ways))
        self.window = window
        self.stats: dict = {}
        self.t = 0

    def run(self, trace: Trace) -> VMResult:
        prev_resident = resident_blocks(self.dram, self.wd)
        for win in trace.intervals(self.window):
            a, w = _pad(np.asarray(win.addr, np.int32),
                        np.asarray(win.is_write), self.window)
            # full mode never writes misses to the SSD; writes pass
            # through (the DRAM level is RO already)
            self.dram, self.ssd, st, t_end = simulate_two_level(
                a, w, self.dram, self.ssd, self.wd, self.ws, mode="full",
                t0=self.t)
            self.t = int(t_end)
            _acc_one(self.stats, st)
            # push the blocks that left DRAM this window to the SSD
            now_resident = resident_blocks(self.dram, self.wd)
            evicted = prev_resident[~np.isin(prev_resident, now_resident)]
            prev_resident = now_resident
            evicted = evicted[~np.isin(evicted,
                                       resident_blocks(self.ssd, self.ws))]
            if evicted.size:
                self.ssd, n = promote_blocks(self.ssd, evicted, self.ws,
                                             self.t)
                self.stats["cache_writes_l2"] = (
                    self.stats.get("cache_writes_l2", 0.0) + int(n))
        return VMResult(dict(self.stats), np.zeros(1, np.int64))


def make_l2arc(dram_capacity: int, ssd_capacity: int, **kw) -> L2ARCCache:
    return L2ARCCache(dram_capacity, ssd_capacity, **kw)
