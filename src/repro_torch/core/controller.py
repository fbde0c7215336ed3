"""ETICA's interval-driven two-level cache controller, and the chassis
of the one-level baselines.

The PyTorch counterpart of :class:`repro.core.controller.EticaCache` on
its main path: batched, fused maintenance (with the background cleaner
when ``clean_quota > 0``), no classifier, no mesh, over an in-memory
:class:`~repro_torch.core.trace.Trace`; and of
:class:`~repro.core.controller.PartitionedSingleLevelCache` on its
batched path (ECI-Cache, Centaur, S-CAVE, vCacheShare are built on it in
:mod:`repro_torch.core.baselines`).

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
from typing import Callable

import numpy as np
import torch

from repro_torch.core import popularity as pop
from repro_torch.core import reuse, simulator
from repro_torch.core.partition import partition as _partition
from repro_torch.core.policies import Policy
from repro_torch.core.simulator import (CacheState, Stats, capacity_to_ways,
                                        make_cache_batch, policy_flags,
                                        resize_batch, resize_levels)
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
    policies: list[str] | None = None   # [V] write policies (one-level)


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


def _acc_block(stats: list[dict], st: Stats, chunks) -> None:
    """Add one block's ``[V]`` Stats (one host copy) into the per-VM
    dicts of the VMs that had a chunk in it."""
    ints = torch.stack([getattr(st, k) for k in _INT_FIELDS]).cpu().numpy()
    lat = st.latency_sum.cpu().numpy()
    for v, chunk in enumerate(chunks):
        if chunk is None:
            continue
        d = stats[v]
        for k, row in zip(_INT_FIELDS, ints):
            _add(d, k, float(row[v]))
        _add(d, "latency_sum", float(lat[v]))


def _device_tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()


def _load_state(state, device) -> CacheState:
    """A ``(tags, lru, dirty)`` numpy triple as a CacheState on device."""
    return CacheState(_device_tensor(state[0], torch.int32, device),
                      _device_tensor(state[1], torch.int32, device),
                      _device_tensor(state[2], torch.bool, device))


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
    clean_quota: int = 0             # background cleaner: max dirty-block
    #                                  flushes per VM per maintenance
    #                                  interval (0 disables the stage)
    telemetry: object | None = None  # TelemetryRecorder | None


def _check_supported(cfg, *more: tuple[str, bool]) -> None:
    """Raise ``NotImplementedError`` for options outside the port."""
    unsupported = [
        ("batched=False", not cfg.batched),
        ("mesh", cfg.mesh is not None),
        ("classifier", cfg.classifier is not None),
        *more,
    ]
    for name, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{type(cfg).__name__} {name} is not ported to repro_torch "
                "yet")


class EticaCache:
    """The proposed system: DRAM(RO) + SSD(WBWO), POD sizing, PPC
    partitioning, popularity-driven promotion/eviction. ``self.dram`` /
    ``self.ssd`` are stacked ``[V, S, W]`` states on ``device``."""

    def __init__(self, cfg: EticaConfig, num_vms: int, device="cuda"):
        _check_supported(cfg, ("fused_maintenance=False",
                               not cfg.fused_maintenance))
        if cfg.mode not in ("full", "npe"):
            raise ValueError(f"mode must be 'full' or 'npe', got "
                             f"{cfg.mode!r}")
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
        self._m_cleaned = np.zeros(num_vms, np.int64)
        self._m_dirty = np.zeros(num_vms, np.int64)
        self._m_clean_ran = False

    def load_state(self, dram, ssd, pop_table, ways_dram, ways_ssd, t,
                   stats) -> None:
        """Continue from another controller's state, given as numpy
        arrays: ``dram``/``ssd`` as ``(tags, lru, dirty)`` ``[V, S, W]``,
        ``pop_table`` as ``(addr, val)`` ``[V, K]``, ``ways_*``/``t`` as
        ``[V]``, ``stats`` as the per-VM dicts."""
        dev = self.device
        self.dram = _load_state(dram, dev)
        self.ssd = _load_state(ssd, dev)
        self.pop_table = pop.PopularityTable(
            _device_tensor(pop_table[0], torch.int32, dev),
            _device_tensor(pop_table[1], torch.float32, dev))
        self.ways_dram = np.asarray(ways_dram, np.int32).copy()
        self.ways_ssd = np.asarray(ways_ssd, np.int32).copy()
        self.t = _device_tensor(t, torch.int32, dev)
        self.stats = [dict(s) for s in stats]

    # -- telemetry ----------------------------------------------------------
    @property
    def clean_log(self) -> list[np.ndarray]:
        """Per-VM cleaner flushes of each interval the cleaner ran."""
        return self.telemetry.cache_clean_log()

    @property
    def dirty_log(self) -> list[np.ndarray]:
        """Per-VM dirty blocks left after each interval the cleaner ran."""
        return self.telemetry.cache_dirty_log()

    def _sample_interval(self) -> None:
        gd, gs = self.cfg.geometry_dram, self.cfg.geometry_ssd
        self.telemetry.sample_cache(
            self.stats,
            alloc_l1=self.ways_dram.astype(np.int64) * gd.num_sets,
            alloc_l2=self.ways_ssd.astype(np.int64) * gs.num_sets,
            promoted=self._m_promoted, evict_queue=self._m_evicted,
            cleaned=self._m_cleaned, dirty=self._m_dirty,
            clean_ran=self._m_clean_ran)
        self._m_promoted = np.zeros(self.num_vms, np.int64)
        self._m_evicted = np.zeros(self.num_vms, np.int64)
        self._m_cleaned = np.zeros(self.num_vms, np.int64)
        self._m_clean_ran = False          # _m_dirty is a gauge: carries

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
                    evict_frac=cfg.evict_frac, decay=cfg.popularity_decay,
                    clean_quota=cfg.clean_quota)
            sp.ready(self.ssd.tags)
        flushed, promoted, eqlen, pqlen, pdrops, cleaned, dirty_left = \
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
            if cfg.clean_quota > 0:
                _add(self.stats[v], "flushes", int(cleaned[v]))
                _add(self.stats[v], "disk_writes", int(cleaned[v]))
                self.stats[v]["dirty_resident"] = float(dirty_left[v])
        self._m_promoted += np.where(pqlen > 0, promoted.astype(np.int64), 0)
        self._m_evicted += eqlen.astype(np.int64)
        if cfg.clean_quota > 0:
            self._m_cleaned += cleaned.astype(np.int64)
            self._m_dirty = dirty_left.astype(np.int64)
            self._m_clean_ran = True

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
        _acc_block(self.stats, st, chunks)

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


# ---------------------------------------------------------------------------
# the chassis of the one-level partitioned baselines
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SingleLevelConfig:
    capacity: int                    # total cache blocks across VMs
    geometry: Geometry = dataclasses.field(default_factory=Geometry)
    resize_interval: int = 10_000
    sim_chunk: int = 1_000
    mrc_points: int = 17
    batched: bool = True             # only the batched path is ported
    prefetch_depth: int = 2          # blocks in flight beyond the consumed
    mesh: object | None = None       # not ported
    classifier: object | None = None  # not ported
    telemetry: object | None = None  # TelemetryRecorder | None


@dataclasses.dataclass(frozen=True)
class PolicyChooser:
    """A per-VM write-policy chooser from each VM's read ratio (ECI-Cache
    picks RO or WB every resize window). :meth:`batch` takes the read
    counts that the batched sizing pass already reduced."""

    from_read_ratio: Callable[[float], Policy]

    def batch(self, read_counts, lens) -> list[Policy]:
        """Policies for all VMs; empty VMs keep ``Policy.WB``."""
        return [self.from_read_ratio(int(r) / max(int(n), 1))
                if n else Policy.WB
                for r, n in zip(read_counts, lens)]


class PartitionedSingleLevelCache:
    """One SSD cache level, partitioned across VMs per a sizing metric.

    Every ``resize_interval`` requests all VMs are sized in one batched
    pass of ``metric`` (a :class:`repro_torch.core.reuse.SizingMetric`),
    given a write policy by ``policy_fn`` (a
    :class:`PolicyChooser`, or a function of the VM's window sub-trace),
    partitioned with PPC and resized; then each ``[V, sim_chunk]`` block
    runs through the one-level datapath with every VM under its own
    policy. Push-mode: a miss allocates whenever the policy admits it.
    ``self.caches`` is the stacked ``[V, S, W]`` state on ``device``.
    """

    def __init__(self, cfg: SingleLevelConfig, num_vms: int, metric,
                 policy_fn, device="cuda"):
        _check_supported(cfg)
        if not isinstance(metric, reuse.SizingMetric):
            raise NotImplementedError(
                "a per-VM metric closure (the sequential oracle) is not "
                "ported to repro_torch yet: pass a SizingMetric")
        self.cfg = cfg
        self.num_vms = num_vms
        self.metric = metric
        self.policy_fn = policy_fn
        self.device = resolve_device(device)
        g = cfg.geometry
        self.caches = make_cache_batch(num_vms, g.num_sets, g.max_ways,
                                       self.device)
        self.ways = np.zeros(num_vms, np.int32)
        self.t = torch.zeros(num_vms, dtype=torch.int32, device=self.device)
        self.stats = [dict() for _ in range(num_vms)]
        self.logs: list[IntervalLog] = []
        self.telemetry = (cfg.telemetry if cfg.telemetry is not None
                          else TelemetryRecorder())

    def load_state(self, caches, ways, t, stats) -> None:
        """Continue from another chassis' state, given as numpy arrays:
        ``caches`` as ``(tags, lru, dirty)`` ``[V, S, W]``, ``ways``/``t``
        as ``[V]``, ``stats`` as the per-VM dicts."""
        self.caches = _load_state(caches, self.device)
        self.ways = np.asarray(ways, np.int32).copy()
        self.t = _device_tensor(t, torch.int32, self.device)
        self.stats = [dict(s) for s in stats]

    def _sample_interval(self) -> None:
        self.telemetry.sample_cache(
            self.stats, alloc_l2=self.ways.astype(np.int64)
            * self.cfg.geometry.num_sets)

    def _size(self, subs: list[Trace], grid: np.ndarray):
        """``(demands, curves, policies)`` of one window at the sizes
        ``grid``, all VMs sized in one batched pass."""
        cfg = self.cfg
        demands = np.zeros(self.num_vms, np.int64)
        curves = np.zeros((self.num_vms, grid.size))
        with self.telemetry.span("sizing"):
            dem, g_, cur, reads = self.metric.batch(
                [np.asarray(s.addr) for s in subs],
                [np.asarray(s.is_write) for s in subs], device=self.device)
        same_grid = np.array_equal(g_, grid)
        for v, sub in enumerate(subs):
            if len(sub) == 0:
                continue
            demands[v] = min(int(dem[v]), cfg.geometry.capacity)
            curves[v] = cur[v] if same_grid else np.interp(grid, g_, cur[v])
        if isinstance(self.policy_fn, PolicyChooser):
            policies = self.policy_fn.batch(reads, [len(s) for s in subs])
        else:
            policies = [self.policy_fn(sub) if len(sub) else Policy.WB
                        for sub in subs]
        return demands, curves, policies

    def run(self, trace: Trace) -> list[VMResult]:
        """Drive the chassis over a whole in-memory trace."""
        cfg = self.cfg
        g = cfg.geometry
        grid = _mrc_grid(g, cfg.mrc_points)
        alloc_hist = [[] for _ in range(self.num_vms)]
        source = window_source(trace, self.num_vms, cfg.resize_interval,
                               cfg.sim_chunk, self.device,
                               cfg.prefetch_depth)
        for win in source.windows():
            subs = win.subs
            demands, curves, policies = self._size(subs, grid)
            res = _partition(demands, curves, grid, cfg.capacity)
            counts = np.array([len(s) for s in subs], np.float64)
            alloc = _expand_to_capacity(res.alloc, counts, cfg.capacity, g)
            self.logs.append(IntervalLog(demands, alloc,
                                         [p.value for p in policies]))
            w_new = capacity_to_ways(alloc, g.num_sets, g.max_ways)
            self.caches, flushed = resize_batch(self.caches, self.ways,
                                                w_new)
            flushed = flushed.cpu().numpy()
            for v in range(self.num_vms):
                _add(self.stats[v], "disk_writes", int(flushed[v]))
                _add(self.stats[v], "evict_flushes", int(flushed[v]))
                alloc_hist[v].append(int(alloc[v]))
            self.ways = w_new
            ways = torch.from_numpy(w_new).to(self.device)
            flags = policy_flags(policies, self.device)
            for a, w, _, kth in win.blocks():
                with self.telemetry.span("datapath") as sp:
                    self.caches, st, self.t = \
                        simulator.simulate_single_level_batch(
                            a, w, self.caches, ways, flags, t0=self.t)
                    sp.ready(self.t)
                _acc_block(self.stats, st, kth)
                self._sample_interval()
        return [VMResult(dict(self.stats[v]),
                         np.asarray(alloc_hist[v], np.int64))
                for v in range(self.num_vms)]
