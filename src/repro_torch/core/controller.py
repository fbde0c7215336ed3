"""ETICA's interval-driven two-level cache controller.

The PyTorch counterpart of :class:`repro.core.controller.EticaCache` on
its main path: batched, fused maintenance, no classifier, no mesh, no
background cleaner, over an in-memory :class:`~repro_torch.core.trace.Trace`.

Every ``resize_interval`` requests the controller sizes both levels per
VM with POD (RO for DRAM, WBWO for the SSD), partitions them with PPC
and resizes the per-VM caches; every ``promo_interval`` requests it
simulates one ``[V, chunk]`` block and, in ``mode="full"``, runs one
fused maintenance interval (popularity refresh, eviction, promotion).
Cache state and the popularity table live on the device; sizing
analytics, partitioning and the per-VM stats dicts stay on the host, as
in the reference. Results (per-VM stats and allocation histories) are
identical to the JAX controller's.

Options outside this path raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import popularity as pop
from repro_torch.core import reuse, simulator
from repro_torch.core.partition import partition as _partition
from repro_torch.core.policies import Policy
from repro_torch.core.simulator import (CacheState, Stats, capacity_to_ways,
                                        make_cache_batch, resize_levels)
from repro_torch.core.trace import Trace
from repro_torch.kernels import resolve_device
from repro_torch.kernels.maintenance import ops as maint_ops
from repro_torch.runtime.telemetry import TelemetryRecorder
from repro_torch.traces.stream import window_source


@dataclasses.dataclass
class Geometry:
    num_sets: int = 64
    max_ways: int = 64

    @property
    def capacity(self) -> int:
        return self.num_sets * self.max_ways


@dataclasses.dataclass
class IntervalLog:
    """Per-interval sizing record."""
    demands: np.ndarray          # [V] blocks requested by the metric
    alloc: np.ndarray            # [V] blocks granted


@dataclasses.dataclass
class VMResult:
    stats: dict[str, float]
    alloc_history: np.ndarray    # [intervals]

    @property
    def hit_ratio(self) -> float:
        s = self.stats
        return (s["read_hits_l1"] + s["read_hits_l2"] + s["write_hits_l2"]) / max(
            s["reads"] + s["writes"], 1)

    @property
    def mean_latency(self) -> float:
        return self.stats["latency_sum"] / max(
            self.stats["reads"] + self.stats["writes"], 1)

    @property
    def ssd_writes(self) -> float:
        return self.stats["cache_writes_l2"]


_INT_FIELDS = tuple(k for k in Stats._fields if k != "latency_sum")


def _add(d: dict[str, float], key: str, value) -> None:
    d[key] = d.get(key, 0.0) + value


def _mrc_grid(geom: Geometry, points: int = 17) -> np.ndarray:
    ways = np.unique(np.round(np.linspace(0, geom.max_ways, points)).astype(int))
    return (ways * geom.num_sets).astype(np.int64)


def _expand_to_capacity(alloc: np.ndarray, counts: np.ndarray,
                        capacity: int, geom: Geometry) -> np.ndarray:
    """Spread capacity beyond the summed demand over the VMs in
    proportion to their request share, bounded by the geometry."""
    left = capacity - int(alloc.sum())
    if left <= 0 or counts.sum() == 0:
        return alloc
    share = counts / counts.sum()
    extra = np.floor(left * share).astype(np.int64)
    return np.minimum(alloc + extra, geom.capacity)


@dataclasses.dataclass
class EticaConfig:
    dram_capacity: int               # total DRAM-level blocks across VMs
    ssd_capacity: int                # total SSD-level blocks across VMs
    geometry_dram: Geometry = dataclasses.field(default_factory=Geometry)
    geometry_ssd: Geometry = dataclasses.field(default_factory=Geometry)
    resize_interval: int = 10_000    # paper §5.1
    promo_interval: int = 1_000      # paper §5.3
    evict_frac: float = 0.05         # paper §4.2.1: bottom 5%
    popularity_decay: float = 0.5
    mode: str = "full"               # "full" | "npe"
    mrc_points: int = 17
    batched: bool = True             # only the batched path is ported
    prefetch_depth: int = 2          # blocks in flight beyond the consumed
    #                                  (0: copy each block when consumed)
    mesh: object | None = None       # not ported
    fused_maintenance: bool = True   # only the fused path is ported
    pop_capacity: int = 8192         # per-VM device popularity-table slots
    classifier: object | None = None  # not ported
    clean_quota: int = 0             # background cleaner: not ported
    telemetry: object | None = None  # TelemetryRecorder | None


def _check_supported(cfg: EticaConfig) -> None:
    unsupported = [
        ("batched=False", not cfg.batched),
        ("fused_maintenance=False", not cfg.fused_maintenance),
        ("mesh", cfg.mesh is not None),
        ("classifier", cfg.classifier is not None),
        ("clean_quota > 0", cfg.clean_quota > 0),
    ]
    for name, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"EticaConfig {name} is not ported to repro_torch yet")
    if cfg.mode not in ("full", "npe"):
        raise ValueError(f"mode must be 'full' or 'npe', got {cfg.mode!r}")


class EticaCache:
    """The proposed system: DRAM(RO) + SSD(WBWO), POD sizing, PPC
    partitioning, popularity-driven promotion/eviction. ``self.dram`` /
    ``self.ssd`` are stacked ``[V, S, W]`` states on ``device``."""

    def __init__(self, cfg: EticaConfig, num_vms: int, device="cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.num_vms = num_vms
        self.device = resolve_device(device)
        gd, gs = cfg.geometry_dram, cfg.geometry_ssd
        self.dram = make_cache_batch(num_vms, gd.num_sets, gd.max_ways,
                                     self.device)
        self.ssd = make_cache_batch(num_vms, gs.num_sets, gs.max_ways,
                                    self.device)
        self.ways_dram = np.zeros(num_vms, np.int32)
        self.ways_ssd = np.zeros(num_vms, np.int32)
        self.t = torch.zeros(num_vms, dtype=torch.int32, device=self.device)
        self.pop_table = pop.table_init(num_vms, cfg.pop_capacity,
                                        self.device)
        self.stats = [dict() for _ in range(num_vms)]
        self.logs_dram: list[IntervalLog] = []
        self.logs_ssd: list[IntervalLog] = []
        self.telemetry = (cfg.telemetry if cfg.telemetry is not None
                          else TelemetryRecorder())
        self._m_promoted = np.zeros(num_vms, np.int64)
        self._m_evicted = np.zeros(num_vms, np.int64)

    def load_state(self, dram, ssd, pop_table, ways_dram, ways_ssd, t,
                   stats) -> None:
        """Continue from another controller's state, given as numpy
        arrays: ``dram``/``ssd`` as ``(tags, lru, dirty)`` ``[V, S, W]``,
        ``pop_table`` as ``(addr, val)`` ``[V, K]``, ``ways_*``/``t`` as
        ``[V]``, ``stats`` as the per-VM dicts."""
        def dev(x, dtype):
            return torch.as_tensor(np.array(x), device=self.device).to(
                dtype).contiguous()

        self.dram = CacheState(dev(dram[0], torch.int32),
                               dev(dram[1], torch.int32),
                               dev(dram[2], torch.bool))
        self.ssd = CacheState(dev(ssd[0], torch.int32),
                              dev(ssd[1], torch.int32),
                              dev(ssd[2], torch.bool))
        self.pop_table = pop.PopularityTable(dev(pop_table[0], torch.int32),
                                             dev(pop_table[1], torch.float32))
        self.ways_dram = np.asarray(ways_dram, np.int32).copy()
        self.ways_ssd = np.asarray(ways_ssd, np.int32).copy()
        self.t = dev(t, torch.int32)
        self.stats = [dict(s) for s in stats]

    # -- telemetry ----------------------------------------------------------
    def _sample_interval(self) -> None:
        gd, gs = self.cfg.geometry_dram, self.cfg.geometry_ssd
        self.telemetry.sample_cache(
            self.stats,
            alloc_l1=self.ways_dram.astype(np.int64) * gd.num_sets,
            alloc_l2=self.ways_ssd.astype(np.int64) * gs.num_sets,
            promoted=self._m_promoted, evict_queue=self._m_evicted)
        self._m_promoted = np.zeros(self.num_vms, np.int64)
        self._m_evicted = np.zeros(self.num_vms, np.int64)

    # -- sizing -----------------------------------------------------------
    def _size_level(self, subs: list[Trace], policy: Policy, geom: Geometry,
                    capacity: int):
        grid = _mrc_grid(geom, self.cfg.mrc_points)
        demands = np.zeros(self.num_vms, np.int64)
        curves = np.zeros((self.num_vms, grid.size))
        with self.telemetry.span("sizing"):
            dists = reuse.pod_distances_batch(
                [np.asarray(s.addr) for s in subs],
                [np.asarray(s.is_write) for s in subs], policy, self.device)
        for v, r in enumerate(dists):
            if r is None:
                continue
            demands[v] = min(reuse.demand_blocks(r.max), geom.capacity)
            hits = reuse.hit_counts_at_sizes(r.dist, r.served, grid)
            curves[v] = np.asarray(hits, np.float64) / max(len(subs[v]), 1)
        res = _partition(demands, curves, grid, capacity)
        counts = np.array([len(s) for s in subs], np.float64)
        alloc = _expand_to_capacity(res.alloc, counts, capacity, geom)
        return alloc, demands, dists

    # -- maintenance --------------------------------------------------------
    def _maintain(self, a, w, lens, chunks: list[Trace | None]) -> None:
        """One fused maintenance interval for all VMs over the block
        ``a``/``w`` (``lens`` requests per VM, on the device); one host
        transfer of the per-VM counts at the end."""
        cfg = self.cfg
        n = [0 if c is None else len(c) for c in chunks]
        live = [v for v, k in enumerate(n) if k > 0]
        if not live:
            return
        # every VM rides as a row (idle ones zero-length)
        amat, wmat = reuse._block_rows(a, w, lens, reuse._bucket(max(n)))
        dist, served, _ = reuse.decompose(amat, wmat, Policy.WB,
                                          sizing_reads_only=False)
        with self.telemetry.span("maintenance") as sp:
            (self.ssd, self.pop_table, *counts) = \
                maint_ops.maintenance_interval(
                    self.ssd, self.pop_table, dist, served, amat, lens,
                    torch.from_numpy(self.ways_ssd).to(self.device), self.t,
                    evict_frac=cfg.evict_frac, decay=cfg.popularity_decay)
            sp.ready(self.ssd.tags)
        flushed, promoted, eqlen, pqlen, pdrops, _, _ = \
            torch.stack(counts).cpu().numpy()
        for v in live:
            if pdrops[v]:
                _add(self.stats[v], "pop_drops", int(pdrops[v]))
            if eqlen[v]:
                _add(self.stats[v], "disk_writes", int(flushed[v]))
                _add(self.stats[v], "evict_flushes", int(flushed[v]))
            if pqlen[v]:
                # each promotion = 1 disk read + 1 SSD write
                _add(self.stats[v], "cache_writes_l2", int(promoted[v]))
                _add(self.stats[v], "disk_reads", int(promoted[v]))
        self._m_promoted += np.where(pqlen > 0, promoted.astype(np.int64), 0)
        self._m_evicted += eqlen.astype(np.int64)

    # -- datapath ----------------------------------------------------------
    def _run_chunk(self, a, w, chunks: list[Trace | None]) -> None:
        """One ``[V, chunk]`` block through the datapath for every VM."""
        cfg = self.cfg
        with self.telemetry.span("datapath") as sp:
            self.dram, self.ssd, st, self.t = \
                simulator.simulate_two_level_batch(
                    a, w, self.dram, self.ssd, self.ways_dram,
                    self.ways_ssd, mode=cfg.mode, t0=self.t)
            sp.ready(self.t)
        ints = torch.stack([getattr(st, k) for k in _INT_FIELDS]).cpu().numpy()
        lat = st.latency_sum.cpu().numpy()
        for v, chunk in enumerate(chunks):
            if chunk is None:
                continue
            d = self.stats[v]
            for k, row in zip(_INT_FIELDS, ints):
                _add(d, k, float(row[v]))
            _add(d, "latency_sum", float(lat[v]))

    # -- main loop ----------------------------------------------------------
    def run(self, trace: Trace) -> list[VMResult]:
        """Drive the controller over a whole in-memory trace."""
        cfg = self.cfg
        gd, gs = cfg.geometry_dram, cfg.geometry_ssd
        alloc_hist = [[] for _ in range(self.num_vms)]
        source = window_source(trace, self.num_vms, cfg.resize_interval,
                               cfg.promo_interval, self.device,
                               cfg.prefetch_depth)
        for win in source.windows():
            subs = win.subs
            # 1) POD sizing + PPC partitioning at both levels (§4.3)
            alloc_d, dem_d, _ = self._size_level(
                subs, Policy.RO, gd, cfg.dram_capacity)
            alloc_s, dem_s, _ = self._size_level(
                subs, Policy.WBWO, gs, cfg.ssd_capacity)
            self.logs_dram.append(IntervalLog(dem_d, alloc_d))
            self.logs_ssd.append(IntervalLog(dem_s, alloc_s))
            # 2) resize both levels (shrinking flushes dirty blocks)
            wd = capacity_to_ways(alloc_d, gd.num_sets, gd.max_ways)
            ws = capacity_to_ways(alloc_s, gs.num_sets, gs.max_ways)
            self.dram, self.ssd, _, flushed = resize_levels(
                self.dram, self.ssd, self.ways_dram, wd, self.ways_ssd, ws)
            flushed = flushed.cpu().numpy()
            for v in range(self.num_vms):
                _add(self.stats[v], "disk_writes", int(flushed[v]))
                _add(self.stats[v], "evict_flushes", int(flushed[v]))
                alloc_hist[v].append(int(alloc_d[v] + alloc_s[v]))
            self.ways_dram, self.ways_ssd = wd, ws
            # 3) datapath in promo-interval blocks + maintenance
            for a, w, lens, kth in win.blocks():
                self._run_chunk(a, w, kth)
                if cfg.mode == "full":
                    self._maintain(a, w, lens, kth)
                self._sample_interval()
        return [VMResult(dict(self.stats[v]),
                         np.asarray(alloc_hist[v], np.int64))
                for v in range(self.num_vms)]
