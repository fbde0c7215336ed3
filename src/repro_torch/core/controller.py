"""ETICA's interval-driven two-level cache controller, and the chassis
of the one-level baselines.

The PyTorch counterpart of :class:`repro.core.controller.EticaCache`
(over an in-memory
:class:`~repro_torch.core.trace.Trace`, an on-disk
:class:`~repro_torch.traces.store.TraceStore` or a
:class:`~repro_torch.traces.stream.StreamingTraceSource`) in its three
maintenance modes, which give identical results:

  * fused (the default): batched ``[V, S, W]`` states, one device
    maintenance interval (popularity table, queues, evict, promote,
    cleaner) per block, no host sync inside it;
  * staged (``fused_maintenance=False``): batched states, host
    :class:`~repro_torch.core.popularity.PopularityTracker` s fed with the
    ``popularity`` kernel's block scores (one launch per interval for all
    VMs), and separate evict / promote / clean launches with host queue
    building between them;
  * sequential (``batched=False``): per-VM ``[S, W]`` states in lists,
    one datapath launch per VM and block, and numpy maintenance (the
    ``*_ref`` ops of :mod:`repro_torch.core.simulator`), the reference
    oracle;

and of :class:`~repro.core.controller.PartitionedSingleLevelCache`,
batched or sequential, with a :class:`~repro_torch.core.reuse
.SizingMetric` or a plain per-VM metric closure (ECI-Cache, Centaur,
S-CAVE, vCacheShare are built on it in :mod:`repro_torch.core.baselines`).

Every ``resize_interval`` requests the controller sizes both levels per
VM with POD (RO for DRAM, WBWO for the SSD), partitions them with PPC
and resizes the per-VM caches; every ``promo_interval`` requests it
simulates one block of requests and, in ``mode="full"``, runs one
maintenance interval (popularity refresh, eviction, promotion, the
optional cleaner). Cache state lives on the device; sizing analytics,
partitioning, the trackers and the per-VM stats dicts stay on the host,
as in the reference. Results (per-VM stats and allocation histories) are
identical to the JAX controller's.

With an IO classifier (``classifier=`` a
:class:`repro_torch.classify.Classifier`) both controllers classify each
resize window once on the device, size on the sub-traces without the
weight-0 (bypass) requests with per-class weighted curves, set each
class's insertion way range after every resize, run every block through
the ``classified`` datapath routes, leave bypassed requests out of the
maintenance (compacted out of the device block), and keep per-(VM,
class) served hit and miss counts (``cls_hits`` / ``cls_miss``), which
ride the block's one copy of its counts to the host.

With a VM mesh (``mesh=`` a :class:`repro_torch.launch.mesh.VMMesh`;
batched, fused maintenance and no classifier) both controllers pad the
VM count with dead VMs (zero ways, ``addr = -1`` blocks, empty windows:
exact no-ops) to ``-(-V // d) * d`` rows and hold the device state in
``d`` row blocks, each in tensors of its own on its shard's device
(lists, one entry a shard; :func:`repro_torch.core.simulator
.gather_rows` joins them). Sizing, the datapath, the resize and the
maintenance run once a shard a step (the ``*_sharded`` dispatches);
stats, logs and trackers stay at the real VM count, and every result is
bit-identical to the unsharded run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.classify import Classifier
from repro_torch.core import popularity as pop
from repro_torch.core import reuse, simulator
from repro_torch.core.partition import partition as _partition
from repro_torch.core.policies import T_SSD, Policy
from repro_torch.core.simulator import (CacheState, PolicyFlags, Stats,
                                        capacity_to_ways, make_cache,
                                        make_cache_batch, policy_flags,
                                        resize_batch, resize_levels)
from repro_torch.core.trace import Trace
from repro_torch.kernels import resolve_device, upload
from repro_torch.kernels.maintenance import ops as maint_ops
from repro_torch.kernels.popularity import ops as pop_ops
from repro_torch.launch.mesh import VMMesh
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

    def contended_latency(self, beta: float = 8.0) -> float:
        """Mean latency under an SSD write-contention model: sustained
        writes trigger SSD garbage collection, which slows every SSD
        access, modelled as ``t_ssd_eff = T_SSD * (1 + beta *
        write_share)`` with write_share = SSD writes / SSD accesses (host
        float64, in the reference's order of operations)."""
        s = self.stats
        ssd_accesses = (s["read_hits_l2"] + s["write_hits_l2"]
                        + s["cache_writes_l2"])
        if ssd_accesses <= 0:
            return self.mean_latency
        write_share = s["cache_writes_l2"] / ssd_accesses
        extra = ssd_accesses * T_SSD * beta * write_share
        return (s["latency_sum"] + extra) / max(
            s["reads"] + s["writes"], 1)

    @property
    def ssd_writes(self) -> float:
        return self.stats["cache_writes_l2"]


_INT_FIELDS = tuple(k for k in Stats._fields if k != "latency_sum")


def _add(d: dict[str, float], key: str, value) -> None:
    d[key] = d.get(key, 0.0) + value


def _acc_block(stats: list[dict], st: Stats, chunks, classes=None):
    """Add one block's ``[V]`` Stats (one host copy) into the per-VM
    dicts of the VMs that had a chunk in it. ``classes``, a classified
    block's ``(cls_hits, cls_miss)`` ``[V, C]``, rides the same copy;
    returns them on the host (int64), else ``None``."""
    ints = torch.stack([getattr(st, k) for k in _INT_FIELDS])
    if classes is not None:
        ints = torch.cat([ints, classes[0].T, classes[1].T])
    ints = ints.cpu().numpy()
    lat = st.latency_sum.cpu().numpy()
    for v, chunk in enumerate(chunks):
        if chunk is None:
            continue
        d = stats[v]
        for k, row in zip(_INT_FIELDS, ints):
            _add(d, k, float(row[v]))
        _add(d, "latency_sum", float(lat[v]))
    if classes is None:
        return None
    ch, cm = np.split(ints[len(_INT_FIELDS):].T.astype(np.int64), 2, axis=1)
    return ch, cm


def _acc_one(d: dict[str, float], st: Stats, classes=None):
    """Add one VM's 0-d Stats (a per-state dispatch) into its dict; its
    ``[C]`` class counts, if any, come back as in :func:`_acc_block`."""
    if classes is not None:
        classes = tuple(x[None] for x in classes)
    out = _acc_block([d], Stats(*(x[None] for x in st)), [True], classes)
    return None if out is None else (out[0][0], out[1][0])


def _pad(addr: np.ndarray, is_write: np.ndarray, n: int):
    """One VM's requests padded (or cut) to ``n`` with ``addr = -1``
    no-ops."""
    k = n - addr.shape[0]
    if k <= 0:
        return addr[:n], is_write[:n]
    return (np.concatenate([addr, np.full(k, -1, addr.dtype)]),
            np.concatenate([is_write, np.zeros(k, bool)]))


def _device_tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()


def _load_state(state, device) -> CacheState:
    """A ``(tags, lru, dirty)`` numpy triple as a CacheState on device."""
    return CacheState(_device_tensor(state[0], torch.int32, device),
                      _device_tensor(state[1], torch.int32, device),
                      _device_tensor(state[2], torch.bool, device))


def _trd_rows(a, w, lens, longest: int):
    """The maintenance TRD channels of a ``[V, chunk]`` block, every VM
    as a row (idle ones zero-length): ``(addr, dist, served)`` ``[V,
    b]`` on the device, columns past ``lens[v]`` cold padding."""
    amat, wmat = reuse._block_rows(a, w, lens, reuse._bucket(longest))
    dist, served, _ = reuse.decompose(amat, wmat, Policy.WB,
                                      sizing_reads_only=False)
    return amat, dist, served


def _cls_chunk(cls_subs: list[np.ndarray], k: int, chunk: int) -> np.ndarray:
    """The ``[V, chunk]`` class-id block of datapath block ``k`` (padding
    positions are class 0 — no-ops either way)."""
    out = np.zeros((len(cls_subs), chunk), np.int32)
    for v, cs in enumerate(cls_subs):
        seg = cs[k * chunk:(k + 1) * chunk]
        out[v, :len(seg)] = seg
    return out


def _class_policy_flags(pol_vc: list[list[Policy]]) -> PolicyFlags:
    """``[V, C]`` :class:`PolicyFlags` (numpy) from per-(VM, class)
    policies (the classifier's override or the VM's own policy)."""
    f = lambda attr: np.asarray(
        [[getattr(p, attr) for p in row] for row in pol_vc], bool)
    return PolicyFlags(f("allocates_reads"), f("write_invalidates"),
                       f("holds_dirty"), f("write_through"))


def _strip_bypass(chunks: list[Trace | None], cls_subs: list[np.ndarray],
                  k: int, chunk: int, byp: np.ndarray) -> list[Trace | None]:
    """Drop bypass-class requests from a maintenance chunk list: bypassed
    requests never touch the cache, so they must not feed popularity
    either. Chunks without bypassed requests pass through unchanged."""
    out = []
    for v, c in enumerate(chunks):
        if c is None or len(c) == 0:
            out.append(c)
            continue
        m = ~byp[cls_subs[v][k * chunk:(k + 1) * chunk]]
        out.append(c if m.all() else c[m])
    return out


def _strip_block(a, w, cmat, byp):
    """:func:`_strip_bypass` on a device block: each row's requests that
    do not bypass, stably compacted to the front (a prefix sum of the
    keep mask and a scatter), ``-1`` after them, and their count
    ``[V]`` — no host sync."""
    v, n = a.shape
    keep = (a >= 0) & ~byp[cmat.long()]
    pos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    idx = torch.where(keep, pos, n).long()      # dropped: a spare column
    a2 = a.new_full((v, n + 1), -1).scatter_(1, idx, a)[:, :n]
    w2 = torch.zeros((v, n + 1), dtype=torch.uint8, device=a.device) \
        .scatter_(1, idx, w.to(torch.uint8))[:, :n].bool()
    return a2, w2, keep.sum(dim=1, dtype=torch.int32)


def _classifier(cfg):
    """The configuration's classifier: ``None`` or a port
    :class:`~repro_torch.classify.Classifier` (anything else, the JAX
    package's included, raises ``TypeError``)."""
    c = cfg.classifier
    if c is not None and not isinstance(c, Classifier):
        raise TypeError(f"classifier must be a repro_torch.classify."
                        f"Classifier, got {type(c).__module__}."
                        f"{type(c).__name__}")
    return c


def _weighted_subs(weights: np.ndarray, addrs: list, writes: list,
                   cls_subs: list[np.ndarray]):
    """The sizing sub-traces of a classified window: each VM's requests
    of positive class weight, and their weights (``float64``)."""
    addrs, writes, wts = list(addrs), list(writes), []
    for v, cs in enumerate(cls_subs):
        w_req = weights[cs]
        keep = w_req > 0
        if not keep.all():
            addrs[v] = addrs[v][keep]
            writes[v] = writes[v][keep]
            w_req = w_req[keep]
        wts.append(w_req)
    return addrs, writes, wts


def _load_classes(cache, carry, hits, miss) -> None:
    """The classifier's run carry and per-class counts of a continued
    run (each left as it is when ``None``)."""
    if carry is not None:
        cache._cls_end, cache._cls_len = (np.asarray(x, np.int32).copy()
                                          for x in carry)
    if hits is not None:
        cache.cls_hits = np.asarray(hits, np.int64).copy()
    if miss is not None:
        cache.cls_miss = np.asarray(miss, np.int64).copy()


def _mesh_setup(mesh, num_vms: int, batched: bool, classifier,
                device: torch.device) -> int:
    """Validate a controller's mesh; returns the dead-VM-padded row count
    its device state carries (``num_vms`` without a mesh)."""
    if mesh is None:
        return num_vms
    if not isinstance(mesh, VMMesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.VMMesh, "
                        f"got {type(mesh).__module__}.{type(mesh).__name__}")
    if not batched:
        raise ValueError(
            "mesh sharding requires batched=True — the sequential "
            "per-VM oracle has no [V] axis to shard")
    if classifier is not None:
        raise ValueError(
            "mesh sharding does not support an IO classifier yet — the "
            "classified datapath dispatches have no sharded variants")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh's devices are {mesh.device_type}, the "
                         f"controller's device is {device}")
    d = mesh.size
    return -(-num_vms // d) * d


def _per_shard(make, rows: int, device, mesh):
    """``make(rows, device)``; with a mesh, one ``make(rows / d, dev)`` a
    shard on its own device."""
    if mesh is None:
        return make(rows, device)
    return [make(rows // mesh.size, dev) for dev in mesh.devices]


def _zeros_t(rows: int, device) -> torch.Tensor:
    return torch.zeros(rows, dtype=torch.int32, device=device)


def _vm_view(state, v: int, rows: int, mesh) -> CacheState:
    """VM ``v``'s ``[S, W]`` view of a stacked state, sharded or whole."""
    if mesh is not None:
        per = rows // mesh.size
        state, v = state[v // per], v % per
    return CacheState(*(x[v] for x in state))


def _pad_loaded(x, blank, mesh):
    """A loaded whole ``[V, ...]`` tensor or NamedTuple as a controller
    holds it: with a mesh, the dead rows ``blank`` appended and the rows
    sharded."""
    if mesh is None:
        return x
    if isinstance(x, tuple):
        x = type(x)(*(torch.cat(ab) for ab in zip(x, blank)))
    else:
        x = torch.cat([x, blank])
    return simulator.shard_rows(x, mesh)


def _last(x):
    """A tensor to time a span by: the last shard's, if sharded."""
    return x[-1] if isinstance(x, list) else x


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
    batched: bool = True             # stacked states; False: the per-VM
    #                                  sequential oracle
    prefetch: bool = True            # pipeline host->device blocks
    prefetch_depth: int = 2          # blocks in flight beyond the consumed
    #                                  (0: copy each block when consumed)
    mesh: VMMesh | None = None       # shard the VM axis over a mesh's
    #                                  devices (batched + fused maintenance,
    #                                  no classifier; VM count padded with
    #                                  dead VMs to a multiple of its size)
    fused_maintenance: bool = True   # one device interval; False: the
    #                                  staged tracker-based path
    pop_capacity: int = 8192         # per-VM device popularity-table slots
    classifier: object | None = None  # repro_torch.classify.Classifier
    clean_quota: int = 0             # background cleaner: max dirty-block
    #                                  flushes per VM per maintenance
    #                                  interval (0 disables the stage)
    telemetry: object | None = None  # TelemetryRecorder | None


class EticaCache:
    """The proposed system: DRAM(RO) + SSD(WBWO), POD sizing, PPC
    partitioning, popularity-driven promotion/eviction. With
    ``cfg.batched``, ``self.dram`` / ``self.ssd`` are stacked ``[V, S,
    W]`` states on ``device`` (with a mesh, lists of ``[V / d, S, W]``
    row blocks, one a shard); without it, lists of per-VM ``[S, W]``
    states. :meth:`vm_dram` / :meth:`vm_ssd` give one VM's view in every
    layout."""

    def __init__(self, cfg: EticaConfig, num_vms: int, device="cuda"):
        if cfg.mode not in ("full", "npe"):
            raise ValueError(f"mode must be 'full' or 'npe', got "
                             f"{cfg.mode!r}")
        if cfg.mesh is not None and not cfg.fused_maintenance:
            raise ValueError(
                "EticaCache mesh sharding requires fused_maintenance=True "
                "— the staged maintenance path round-trips through host "
                "trackers and cannot stay shard-local")
        self.cfg = cfg
        self.num_vms = num_vms
        self.device = resolve_device(device)
        # with a mesh the device state carries dead-VM rows up to a
        # multiple of the mesh size; host structures (stats, logs,
        # trackers) stay at the real VM count
        self.mesh = cfg.mesh
        self._rows = rows = _mesh_setup(cfg.mesh, num_vms, cfg.batched,
                                        cfg.classifier, self.device)
        gd, gs = cfg.geometry_dram, cfg.geometry_ssd
        if cfg.batched:
            self.dram, self.ssd = (_per_shard(
                lambda n, dev: make_cache_batch(n, g.num_sets, g.max_ways,
                                                dev),
                rows, self.device, self.mesh) for g in (gd, gs))
            self.t = _per_shard(_zeros_t, rows, self.device, self.mesh)
        else:
            self.dram = [make_cache(gd.num_sets, gd.max_ways, self.device)
                         for _ in range(num_vms)]
            self.ssd = [make_cache(gs.num_sets, gs.max_ways, self.device)
                        for _ in range(num_vms)]
            self.t = np.zeros(num_vms, np.int32)
        self.ways_dram = np.zeros(rows, np.int32)
        self.ways_ssd = np.zeros(rows, np.int32)
        # the fused path keeps one [V, K] device table; the staged and
        # sequential paths keep host trackers (its bit-exact oracle)
        fused = cfg.batched and cfg.fused_maintenance
        self.pop_table = (_per_shard(
            lambda n, dev: pop.table_init(n, cfg.pop_capacity, dev), rows,
            self.device, self.mesh) if fused else None)
        self.trackers = [pop.PopularityTracker(cfg.popularity_decay)
                         for _ in range(num_vms)]
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
        # IO classification: the per-VM sequential-run carry, the class
        # tables of the classified datapath and the per-(VM, class)
        # served hit / miss counts
        self.classifier = _classifier(cfg)
        if self.classifier is not None:
            self._cls_end, self._cls_len = self.classifier.init_carry(num_vms)
            self._byp = np.asarray(self.classifier.bypass, bool)
            self._byp_dev = torch.from_numpy(self._byp).to(self.device)
            c = self.classifier.num_classes
            self._lo_d = self._hi_d = np.zeros((num_vms, c), np.int32)
            self._lo_s = self._hi_s = np.zeros((num_vms, c), np.int32)
            self._bounds = None         # the window's bounds on the device
            self.cls_hits = np.zeros((num_vms, c), np.int64)
            self.cls_miss = np.zeros((num_vms, c), np.int64)

    def vm_dram(self, v: int) -> CacheState:
        return (_vm_view(self.dram, v, self._rows, self.mesh)
                if self.cfg.batched else self.dram[v])

    def vm_ssd(self, v: int) -> CacheState:
        return (_vm_view(self.ssd, v, self._rows, self.mesh)
                if self.cfg.batched else self.ssd[v])

    def load_state(self, dram, ssd, pop_table, ways_dram, ways_ssd, t,
                   stats, cls_carry=None, cls_hits=None,
                   cls_miss=None) -> None:
        """Continue a batched, fused controller from another's state,
        given as numpy arrays: ``dram``/``ssd`` as ``(tags, lru, dirty)``
        ``[V, S, W]``,
        ``pop_table`` as ``(addr, val)`` ``[V, K]``, ``ways_*``/``t`` as
        ``[V]``, ``stats`` as the per-VM dicts; with a classifier, its
        run carry ``(prev_end, run_len)`` ``[V]`` and the per-class
        counts ``[V, C]``. With a mesh the arrays hold the real VMs; the
        dead rows are added and the rows sharded here."""
        if self.pop_table is None:
            raise ValueError("load_state continues a batched controller "
                             "with fused maintenance")
        dev, pad = self.device, self._rows - self.num_vms
        gd, gs = self.cfg.geometry_dram, self.cfg.geometry_ssd
        self.dram = _pad_loaded(_load_state(dram, dev), make_cache_batch(
            pad, gd.num_sets, gd.max_ways, dev), self.mesh)
        self.ssd = _pad_loaded(_load_state(ssd, dev), make_cache_batch(
            pad, gs.num_sets, gs.max_ways, dev), self.mesh)
        self.pop_table = _pad_loaded(pop.PopularityTable(
            _device_tensor(pop_table[0], torch.int32, dev),
            _device_tensor(pop_table[1], torch.float32, dev)),
            pop.table_init(pad, self.cfg.pop_capacity, dev), self.mesh)
        self.ways_dram = np.pad(np.asarray(ways_dram, np.int32), (0, pad))
        self.ways_ssd = np.pad(np.asarray(ways_ssd, np.int32), (0, pad))
        self.t = _pad_loaded(_device_tensor(t, torch.int32, dev),
                             _zeros_t(pad, dev), self.mesh)
        self.stats = [dict(s) for s in stats]
        if self.classifier is not None:
            _load_classes(self, cls_carry, cls_hits, cls_miss)

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
        cls = self.classifier is not None
        n = self.num_vms
        self.telemetry.sample_cache(
            self.stats,
            alloc_l1=self.ways_dram[:n].astype(np.int64) * gd.num_sets,
            alloc_l2=self.ways_ssd[:n].astype(np.int64) * gs.num_sets,
            promoted=self._m_promoted, evict_queue=self._m_evicted,
            cleaned=self._m_cleaned, dirty=self._m_dirty,
            clean_ran=self._m_clean_ran,
            cls_hits=self.cls_hits if cls else None,
            cls_miss=self.cls_miss if cls else None)
        self._m_promoted = np.zeros(self.num_vms, np.int64)
        self._m_evicted = np.zeros(self.num_vms, np.int64)
        self._m_cleaned = np.zeros(self.num_vms, np.int64)
        self._m_clean_ran = False          # _m_dirty is a gauge: carries

    # -- sizing -----------------------------------------------------------
    def _size_level(self, subs: list[Trace], policy: Policy, geom: Geometry,
                    capacity: int, cls_subs: list[np.ndarray] | None = None):
        grid = _mrc_grid(geom, self.cfg.mrc_points)
        demands = np.zeros(self.num_vms, np.int64)
        curves = np.zeros((self.num_vms, grid.size))
        addrs = [np.asarray(s.addr) for s in subs]
        writes = [np.asarray(s.is_write) for s in subs]
        wts = None
        if cls_subs is not None:
            # weight-0 (bypass) requests never reach the cache: cut from
            # the sizing sub-traces; the rest weight the hit curves
            addrs, writes, wts = _weighted_subs(
                self.classifier.weights, addrs, writes, cls_subs)
        with self.telemetry.span("sizing"):
            if self.mesh is not None:
                # dead-VM rows pad to the sharded row count
                pad = self._rows - self.num_vms
                dists = reuse.pod_distances_batch(
                    addrs + [np.empty(0, np.int32)] * pad,
                    writes + [np.empty(0, bool)] * pad, policy,
                    mesh=self.mesh)[:self.num_vms]
            elif self.cfg.batched:
                dists = reuse.pod_distances_batch(addrs, writes, policy,
                                                  self.device)
            else:
                dists = [reuse.pod_distances(a, w, policy, self.device)
                         if a.size else None
                         for a, w in zip(addrs, writes)]
        for v, r in enumerate(dists):
            if r is None:
                continue
            demands[v] = min(reuse.demand_blocks(r.max), geom.capacity)
            if wts is None:
                hits = reuse.hit_counts_at_sizes(r.dist, r.served, grid)
                curves[v] = np.asarray(hits, np.float64) / max(len(subs[v]),
                                                               1)
            else:
                hits = reuse.hit_counts_at_sizes_weighted(
                    r.dist, r.served, grid, wts[v])
                curves[v] = hits / max(wts[v].sum(), 1)
        res = _partition(demands, curves, grid, capacity)
        if wts is None:
            counts = np.array([len(s) for s in subs], np.float64)
        else:
            counts = np.array([w.sum() for w in wts], np.float64)
        alloc = _expand_to_capacity(res.alloc, counts, capacity, geom)
        return alloc, demands, dists

    # -- maintenance --------------------------------------------------------
    def _alloc_blocks(self, v: int) -> int:
        return int(self.ways_ssd[v]) * self.cfg.geometry_ssd.num_sets

    def _refresh_tracker(self, v: int, window: Trace, r) -> None:
        # Eq. 1 sums over every re-reference, writes included, so
        # write-hot blocks become popular and get promoted into the WBWO
        # SSD, where later writes hit
        cs = float(max(self._alloc_blocks(v), 1))
        contrib = pop.contributions(torch.from_numpy(r.dist),
                                    torch.from_numpy(r.served), cs)
        self.trackers[v].update(np.asarray(window.addr), contrib.numpy())

    def _maintain_seq(self, v: int, window: Trace) -> None:
        """Per-VM popularity refresh, eviction, promotion and cleaning
        (paper §4.2) with host numpy ops: the reference oracle."""
        cfg = self.cfg
        if len(window) == 0:
            return
        alloc_blocks = self._alloc_blocks(v)
        ways = int(self.ways_ssd[v])
        r = reuse.trd_distances(window.addr, window.is_write, self.device)
        self._refresh_tracker(v, window, r)
        stats = self.stats[v]
        ssd_res = simulator.resident_blocks(self.ssd[v], ways)
        # eviction queue: the least popular 5% of SSD-resident blocks,
        # once the partition is at least 90% full (integer arithmetic, so
        # every path agrees at the boundary)
        if ssd_res.size and ssd_res.size * 10 >= alloc_blocks * 9:
            evict = self.trackers[v].least_popular(ssd_res, cfg.evict_frac)
            if evict.size:
                self._m_evicted[v] += int(evict.size)
                self.ssd[v], flushed = simulator.evict_blocks_ref(
                    self.ssd[v], evict)
                _add(stats, "disk_writes", flushed)
                _add(stats, "evict_flushes", flushed)
        # promotion queue: the most popular known blocks without an SSD
        # copy, drained up to the free space
        residents = simulator.resident_blocks(self.ssd[v], ways)
        free = max(alloc_blocks - residents.size, 0)
        if free:
            promote = self.trackers[v].top_known(residents, free)
            if promote.size:
                self.ssd[v], n = simulator.promote_blocks_ref(
                    self.ssd[v], promote, ways, int(self.t[v]))
                self._m_promoted[v] += int(n)
                # each promotion = 1 disk read + 1 SSD write
                _add(stats, "cache_writes_l2", n)
                _add(stats, "disk_reads", n)
        # background cleaner: flush the quota oldest dirty blocks
        if cfg.clean_quota > 0:
            self.ssd[v], n_fl, left = simulator.clean_blocks_ref(
                self.ssd[v], ways, cfg.clean_quota)
            _add(stats, "flushes", n_fl)
            _add(stats, "disk_writes", n_fl)
            stats["dirty_resident"] = float(left)
            self._m_cleaned[v] += int(n_fl)
            self._m_dirty[v] = int(left)

    def _residents(self, tags_np: np.ndarray, v: int) -> np.ndarray:
        t = tags_np[v, :, : max(int(self.ways_ssd[v]), 0)]
        return t[t >= 0]

    def _maintain_staged(self, a, w, lens, chunks: list[Trace | None]
                         ) -> None:
        """The staged maintenance interval: host trackers, scored by one
        ``popularity`` launch for all VMs, and separate evict, promote
        and clean launches with host syncs between them (the oracle
        between the fused path and the sequential one)."""
        cfg = self.cfg
        n = [0 if c is None else len(c) for c in chunks]
        live = [v for v, k in enumerate(n) if k > 0]
        if not live:
            return
        amat, dist, served = _trd_rows(a, w, lens, max(n))
        col = torch.arange(amat.shape[1], device=amat.device)[None, :]
        waddr = torch.where(col < lens[:, None], amat, -1)
        cs = torch.from_numpy(np.maximum(
            self.ways_ssd.astype(np.float32)
            * self.cfg.geometry_ssd.num_sets, 1.0)).to(self.device)
        scores = pop_ops.block_popularity_batch(waddr, dist, served, cs)
        for v in live:
            self.trackers[v].decay()
            self.trackers[v].merge(*scores[v])

        stats = self.stats
        nothing = np.empty(0, np.int64)
        tags_np = self.ssd.tags.cpu().numpy()
        evict_qs = [nothing] * self.num_vms
        for v in live:
            res = self._residents(tags_np, v)
            if res.size and res.size * 10 >= self._alloc_blocks(v) * 9:
                evict_qs[v] = self.trackers[v].least_popular(
                    res, cfg.evict_frac)
        if any(q.size for q in evict_qs):
            self._m_evicted += np.asarray([q.size for q in evict_qs],
                                          np.int64)
            self.ssd, flushed = simulator.evict_blocks_batch(self.ssd,
                                                             evict_qs)
            flushed = flushed.cpu().numpy()
            for v in live:
                if evict_qs[v].size:
                    _add(stats[v], "disk_writes", int(flushed[v]))
                    _add(stats[v], "evict_flushes", int(flushed[v]))
            tags_np = self.ssd.tags.cpu().numpy()

        promo_qs = [nothing] * self.num_vms
        for v in live:
            res = self._residents(tags_np, v)
            free = max(self._alloc_blocks(v) - res.size, 0)
            if free:
                promo_qs[v] = self.trackers[v].top_known(res, free)
        if any(q.size for q in promo_qs):
            self.ssd, promoted = simulator.promote_blocks_batch(
                self.ssd, promo_qs, self.ways_ssd, self.t)
            promoted = promoted.cpu().numpy()
            for v in live:
                if promo_qs[v].size:
                    self._m_promoted[v] += int(promoted[v])
                    _add(stats[v], "cache_writes_l2", int(promoted[v]))
                    _add(stats[v], "disk_reads", int(promoted[v]))

        # background cleaner: one launch flushes the quota oldest dirty
        # blocks of every live VM
        if cfg.clean_quota > 0:
            quota = np.zeros(self.num_vms, np.int32)
            quota[live] = cfg.clean_quota
            self.ssd, cleaned, dirty_left = simulator.clean_batch(
                self.ssd, self.ways_ssd, quota)
            cleaned, dirty_left = torch.stack(
                [cleaned, dirty_left]).cpu().numpy()
            for v in live:
                _add(stats[v], "flushes", int(cleaned[v]))
                _add(stats[v], "disk_writes", int(cleaned[v]))
                stats[v]["dirty_resident"] = float(dirty_left[v])
            self._m_cleaned += cleaned.astype(np.int64)
            self._m_dirty = dirty_left.astype(np.int64)
            self._m_clean_ran = True

    def _maintain_fused(self, a, w, lens, chunks: list[Trace | None]
                        ) -> None:
        """One fused maintenance interval for all VMs over the block
        ``a``/``w`` (``lens`` requests per VM, on the device; with a
        mesh, one of each a shard, and one interval a shard); one host
        transfer of the per-VM counts at the end."""
        cfg = self.cfg
        n = [0 if c is None else len(c) for c in chunks]
        live = [v for v, k in enumerate(n) if k > 0]
        if not live:
            return
        if self.mesh is None:
            amat, dist, served = _trd_rows(a, w, lens, max(n))
        else:
            amat, dist, served = simulator.map_shards(
                lambda *blk: _trd_rows(*blk, max(n)), self.mesh, a, w, lens)
        with self.telemetry.span("maintenance") as sp:
            (self.ssd, self.pop_table, *counts) = \
                maint_ops.maintenance_interval(
                    self.ssd, self.pop_table, dist, served, amat, lens,
                    torch.from_numpy(self.ways_ssd).to(self.device), self.t,
                    evict_frac=cfg.evict_frac,
                    decay=cfg.popularity_decay, clean_quota=cfg.clean_quota,
                    mesh=self.mesh)
            sp.ready(_last(self.ssd).tags)
        if self.mesh is not None:
            counts = [simulator.gather_rows(c) for c in counts]
        flushed, promoted, eqlen, pqlen, pdrops, cleaned, dirty_left = \
            torch.stack(counts).cpu().numpy()[:, :self.num_vms]
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
    def _run_chunk(self, a, w, chunks: list[Trace | None],
                   cmat=None) -> None:
        """One ``[V, chunk]`` block through the datapath for every VM;
        ``cmat`` is its ``[V, chunk]`` class-id block on the device when
        a classifier is configured."""
        cfg = self.cfg
        with self.telemetry.span("datapath") as sp:
            if self.mesh is not None:
                self.dram, self.ssd, st, self.t = \
                    simulator.simulate_two_level_sharded(
                        a, w, self.dram, self.ssd, self.ways_dram,
                        self.ways_ssd, self.mesh, mode=cfg.mode, t0=self.t)
                st, classes = simulator.gather_rows(st), None
            elif cmat is None:
                self.dram, self.ssd, st, self.t = \
                    simulator.simulate_two_level_batch(
                        a, w, self.dram, self.ssd, self.ways_dram,
                        self.ways_ssd, mode=cfg.mode, t0=self.t)
                classes = None
            else:
                self.dram, self.ssd, st, self.t, *classes = \
                    simulator.simulate_two_level_classified_batch(
                        a, w, cmat, self.dram, self.ssd, self.ways_dram,
                        self.ways_ssd, self._byp_dev, *self._bounds,
                        mode=cfg.mode, t0=self.t)
            sp.ready(_last(self.t))
        classes = _acc_block(self.stats, st, chunks, classes)
        if classes is not None:
            self.cls_hits += classes[0]
            self.cls_miss += classes[1]

    def _run_chunk_sequential(self, chunks: list[Trace | None],
                              cls_subs: list[np.ndarray] | None = None,
                              k: int = 0) -> None:
        """The reference oracle: one datapath launch per VM."""
        cfg = self.cfg
        for v, chunk in enumerate(chunks):
            if chunk is None:
                continue
            a, w = _pad(np.asarray(chunk.addr, np.int32),
                        np.asarray(chunk.is_write), cfg.promo_interval)
            if cls_subs is None:
                self.dram[v], self.ssd[v], st, t_end = \
                    simulator.simulate_two_level(
                        a, w, self.dram[v], self.ssd[v],
                        int(self.ways_dram[v]), int(self.ways_ssd[v]),
                        mode=cfg.mode, t0=int(self.t[v]))
                classes = None
            else:
                cpad = _cls_chunk([cls_subs[v]], k, cfg.promo_interval)[0]
                self.dram[v], self.ssd[v], st, t_end, *classes = \
                    simulator.simulate_two_level_classified(
                        a, w, cpad, self.dram[v], self.ssd[v],
                        int(self.ways_dram[v]), int(self.ways_ssd[v]),
                        self._byp, self._lo_d[v], self._hi_d[v],
                        self._lo_s[v], self._hi_s[v], mode=cfg.mode,
                        t0=int(self.t[v]))
            self.t[v] = int(t_end)
            classes = _acc_one(self.stats[v], st, classes)
            if classes is not None:
                self.cls_hits[v] += classes[0]
                self.cls_miss[v] += classes[1]

    def _resize(self, wd: np.ndarray, ws: np.ndarray) -> None:
        """Resize both levels of every VM (shrinking flushes dirty
        blocks): one pass over the stacked states (one a shard with a
        mesh, the dead rows at zero ways), or per VM with the numpy
        oracle."""
        pad = self._rows - self.num_vms
        wd, ws = np.pad(wd, (0, pad)), np.pad(ws, (0, pad))
        if self.mesh is not None:
            self.dram, self.ssd, _, flushed = \
                simulator.resize_levels_sharded(
                    self.dram, self.ssd, self.ways_dram, wd, self.ways_ssd,
                    ws, self.mesh)
            flushed = simulator.gather_rows(flushed).cpu().numpy()
        elif self.cfg.batched:
            self.dram, self.ssd, _, flushed = resize_levels(
                self.dram, self.ssd, self.ways_dram, wd, self.ways_ssd, ws)
            flushed = flushed.cpu().numpy()
        else:
            flushed = np.zeros(self.num_vms, np.int64)
            for v in range(self.num_vms):
                self.dram[v], _ = simulator.resize_ref(
                    self.dram[v], int(self.ways_dram[v]), int(wd[v]))
                self.ssd[v], flushed[v] = simulator.resize_ref(
                    self.ssd[v], int(self.ways_ssd[v]), int(ws[v]))
        for v in range(self.num_vms):
            _add(self.stats[v], "disk_writes", int(flushed[v]))
            _add(self.stats[v], "evict_flushes", int(flushed[v]))
        self.ways_dram, self.ways_ssd = wd, ws

    # -- main loop ----------------------------------------------------------
    def run(self, trace) -> list[VMResult]:
        """Drive the controller over a whole trace.

        ``trace`` may be an in-memory :class:`Trace`, an on-disk
        :class:`repro_torch.traces.store.TraceStore`, or a pre-built
        :class:`repro_torch.traces.stream.StreamingTraceSource` — all
        three give bit-identical results; the store and stream paths
        hold one resize window (plus the in-flight ``[V, chunk]``
        blocks) in host memory. Anything else raises ``TypeError``."""
        cfg = self.cfg
        gd, gs = cfg.geometry_dram, cfg.geometry_ssd
        alloc_hist = [[] for _ in range(self.num_vms)]
        source = window_source(trace, self.num_vms, cfg.resize_interval,
                               cfg.promo_interval, cfg.prefetch,
                               cfg.prefetch_depth, self.device,
                               self._rows - self.num_vms, self.mesh)
        chunk = cfg.promo_interval
        for win in source.windows():
            subs = win.subs
            # 0) IO classification: one classify_block a window on the
            # device, the sequential-run carry threaded across windows
            cls_subs = None
            if self.classifier is not None:
                cls_subs, self._cls_end, self._cls_len = \
                    self.classifier.classify_subs(subs, self._cls_end,
                                                  self._cls_len, self.device)
            # 1) POD sizing + PPC partitioning at both levels (§4.3)
            alloc_d, dem_d, _ = self._size_level(
                subs, Policy.RO, gd, cfg.dram_capacity, cls_subs)
            alloc_s, dem_s, _ = self._size_level(
                subs, Policy.WBWO, gs, cfg.ssd_capacity, cls_subs)
            self.logs_dram.append(IntervalLog(dem_d, alloc_d))
            self.logs_ssd.append(IntervalLog(dem_s, alloc_s))
            # 2) resize both levels (shrinking flushes dirty blocks)
            self._resize(capacity_to_ways(alloc_d, gd.num_sets, gd.max_ways),
                         capacity_to_ways(alloc_s, gs.num_sets, gs.max_ways))
            for v in range(self.num_vms):
                alloc_hist[v].append(int(alloc_d[v] + alloc_s[v]))
            # class -> sub-partition way ranges for the new allocations
            if cls_subs is not None:
                self._lo_d, self._hi_d = self.classifier.way_bounds(
                    self.ways_dram)
                self._lo_s, self._hi_s = self.classifier.way_bounds(
                    self.ways_ssd)
                self._bounds = [upload(x, self.device) for x in (
                    self._lo_d, self._hi_d, self._lo_s, self._hi_s)]
            strip = cls_subs is not None and bool(self._byp.any())
            # 3) datapath in promo-interval blocks + maintenance
            if cfg.batched:
                for k, (a, w, lens, kth) in enumerate(win.blocks()):
                    cmat = (None if cls_subs is None else upload(
                        _cls_chunk(cls_subs, k, chunk), self.device))
                    self._run_chunk(a, w, kth, cmat)
                    if cfg.mode == "full" and strip:
                        # bypassed requests never feed the maintenance
                        kth = _strip_bypass(kth, cls_subs, k, chunk,
                                            self._byp)
                        a, w, lens = _strip_block(a, w, cmat, self._byp_dev)
                    if cfg.mode == "full" and cfg.fused_maintenance:
                        self._maintain_fused(a, w, lens, kth)
                    elif cfg.mode == "full":
                        with self.telemetry.span("maintenance"):
                            self._maintain_staged(a, w, lens, kth)
                    self._sample_interval()
                continue
            chunk_lists = win.chunk_lists()
            for k in range(max(map(len, chunk_lists), default=0)):
                kth = [c[k] if k < len(c) else None for c in chunk_lists]
                with self.telemetry.span("datapath"):
                    self._run_chunk_sequential(kth, cls_subs, k)
                if cfg.mode == "full":
                    if strip:
                        kth = _strip_bypass(kth, cls_subs, k, chunk,
                                            self._byp)
                    with self.telemetry.span("maintenance"):
                        for v, c in enumerate(kth):
                            if c is not None:
                                self._maintain_seq(v, c)
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
    batched: bool = True             # stacked states; False: the per-VM
    #                                  sequential oracle
    prefetch: bool = True            # pipeline host->device blocks
    prefetch_depth: int = 2          # blocks in flight beyond the consumed
    mesh: VMMesh | None = None       # shard the VM axis over a mesh's
    #                                  devices (batched, no classifier;
    #                                  VM count padded with dead VMs)
    classifier: object | None = None  # repro_torch.classify.Classifier
    telemetry: object | None = None  # TelemetryRecorder | None


MetricFn = Callable[[Trace], tuple[int, np.ndarray, np.ndarray]]
# returns (demand_blocks, grid_sizes, hit_curve)
PolicyFn = Callable[[Trace], Policy]


@dataclasses.dataclass(frozen=True)
class PolicyChooser:
    """A per-VM write-policy chooser from each VM's read ratio (ECI-Cache
    picks RO or WB every resize window), in batched and sequential
    forms: :meth:`batch` takes the read counts that the batched sizing
    pass already reduced; ``ref`` is the per-VM closure the sequential
    chassis runs. Instances are callable as a plain :data:`PolicyFn`."""

    from_read_ratio: Callable[[float], Policy]
    ref: PolicyFn                    # sequential per-VM oracle

    def __call__(self, sub: Trace) -> Policy:
        return self.ref(sub)

    def batch(self, read_counts, lens) -> list[Policy]:
        """Policies for all VMs; empty VMs keep ``Policy.WB``."""
        return [self.from_read_ratio(int(r) / max(int(n), 1))
                if n else Policy.WB
                for r, n in zip(read_counts, lens)]


class PartitionedSingleLevelCache:
    """One SSD cache level, partitioned across VMs per a sizing metric.

    Every ``resize_interval`` requests all VMs are sized by ``metric``
    (a :class:`repro_torch.core.reuse.SizingMetric`, in one batched pass,
    or a plain per-VM :data:`MetricFn` closure), given a write policy by
    ``policy_fn`` (a :class:`PolicyChooser`, or a function of the VM's
    window sub-trace), partitioned with PPC and resized; then each
    ``[V, sim_chunk]`` block runs through the one-level datapath with
    every VM under its own policy. Push-mode: a miss allocates whenever
    the policy admits it. With ``cfg.batched``, ``self.caches`` is the
    stacked ``[V, S, W]`` state on ``device``; without it, a list of
    per-VM ``[S, W]`` states, sized with the metric's ``ref`` closure and
    simulated one VM at a time (the sequential oracle).
    """

    def __init__(self, cfg: SingleLevelConfig, num_vms: int, metric,
                 policy_fn, device="cuda"):
        if not (isinstance(metric, reuse.SizingMetric) or callable(metric)):
            raise TypeError("metric must be a SizingMetric or a per-VM "
                            "closure sub -> (demand, grid, curve)")
        self.cfg = cfg
        self.num_vms = num_vms
        self.metric = metric
        self.policy_fn = policy_fn
        self.device = resolve_device(device)
        # dead-VM rows with a mesh, as in EticaCache
        self.mesh = cfg.mesh
        self._rows = rows = _mesh_setup(cfg.mesh, num_vms, cfg.batched,
                                        cfg.classifier, self.device)
        g = cfg.geometry
        if cfg.batched:
            self.caches = _per_shard(
                lambda n, dev: make_cache_batch(n, g.num_sets, g.max_ways,
                                                dev),
                rows, self.device, self.mesh)
            self.t = _per_shard(_zeros_t, rows, self.device, self.mesh)
        else:
            self.caches = [make_cache(g.num_sets, g.max_ways, self.device)
                           for _ in range(num_vms)]
            self.t = np.zeros(num_vms, np.int32)
        self.ways = np.zeros(rows, np.int32)
        self.stats = [dict() for _ in range(num_vms)]
        self.logs: list[IntervalLog] = []
        self.telemetry = (cfg.telemetry if cfg.telemetry is not None
                          else TelemetryRecorder())
        self.classifier = _classifier(cfg)
        if self.classifier is not None:
            self._cls_end, self._cls_len = self.classifier.init_carry(num_vms)
            self._byp = np.asarray(self.classifier.bypass, bool)
            c = self.classifier.num_classes
            self.cls_hits = np.zeros((num_vms, c), np.int64)
            self.cls_miss = np.zeros((num_vms, c), np.int64)

    def vm_cache(self, v: int) -> CacheState:
        return (_vm_view(self.caches, v, self._rows, self.mesh)
                if self.cfg.batched else self.caches[v])

    def load_state(self, caches, ways, t, stats, cls_carry=None,
                   cls_hits=None, cls_miss=None) -> None:
        """Continue a batched chassis from another's state, given as numpy
        arrays:
        ``caches`` as ``(tags, lru, dirty)`` ``[V, S, W]``, ``ways``/``t``
        as ``[V]``, ``stats`` as the per-VM dicts; with a classifier, its
        run carry ``(prev_end, run_len)`` ``[V]`` and the per-class
        counts ``[V, C]``. With a mesh the arrays hold the real VMs, as
        in :meth:`EticaCache.load_state`."""
        dev, pad, g = self.device, self._rows - self.num_vms, self.cfg.geometry
        self.caches = _pad_loaded(_load_state(caches, dev), make_cache_batch(
            pad, g.num_sets, g.max_ways, dev), self.mesh)
        self.ways = np.pad(np.asarray(ways, np.int32), (0, pad))
        self.t = _pad_loaded(_device_tensor(t, torch.int32, dev),
                             _zeros_t(pad, dev), self.mesh)
        self.stats = [dict(s) for s in stats]
        if self.classifier is not None:
            _load_classes(self, cls_carry, cls_hits, cls_miss)

    def _sample_interval(self) -> None:
        cls = self.classifier is not None
        self.telemetry.sample_cache(
            self.stats, alloc_l2=self.ways[:self.num_vms].astype(np.int64)
            * self.cfg.geometry.num_sets,
            cls_hits=self.cls_hits if cls else None,
            cls_miss=self.cls_miss if cls else None)

    def _size(self, subs: list[Trace], grid: np.ndarray):
        """``(demands, curves, policies)`` of one window at the sizes
        ``grid``: all VMs in one batched pass of a SizingMetric, or the
        per-VM closure (the metric's ``ref``) when not batched."""
        cfg = self.cfg
        demands = np.zeros(self.num_vms, np.int64)
        curves = np.zeros((self.num_vms, grid.size))
        batched_metric = cfg.batched and hasattr(self.metric, "batch")
        with self.telemetry.span("sizing"):
            if batched_metric:
                # with a mesh: dead-VM rows pad to the sharded row count
                pad = self._rows - self.num_vms
                kw = {} if self.mesh is None else dict(mesh=self.mesh)
                dem, g_, cur, reads = self.metric.batch(
                    [np.asarray(s.addr) for s in subs]
                    + [np.empty(0, np.int32)] * pad,
                    [np.asarray(s.is_write) for s in subs]
                    + [np.empty(0, bool)] * pad, device=self.device, **kw)
                same_grid = np.array_equal(g_, grid)
                for v, sub in enumerate(subs):
                    if len(sub) == 0:
                        continue
                    demands[v] = min(int(dem[v]), cfg.geometry.capacity)
                    curves[v] = (cur[v] if same_grid
                                 else np.interp(grid, g_, cur[v]))
            else:
                metric_fn = getattr(self.metric, "ref", self.metric)
                for v, sub in enumerate(subs):
                    if len(sub) == 0:
                        continue
                    d, g_, c_ = metric_fn(sub)
                    demands[v] = min(d, cfg.geometry.capacity)
                    curves[v] = np.interp(grid, g_, c_)
        if batched_metric and isinstance(self.policy_fn, PolicyChooser):
            policies = self.policy_fn.batch(reads, [len(s) for s in subs])
        else:
            policies = [self.policy_fn(sub) if len(sub) else Policy.WB
                        for sub in subs]
        return demands, curves, policies

    def _resize(self, w_new: np.ndarray) -> None:
        """Resize every VM's partition (shrinking flushes dirty blocks):
        one pass over the stacked state (one a shard with a mesh, the
        dead rows at zero ways), or per VM with the numpy oracle."""
        w_new = np.pad(w_new, (0, self._rows - self.num_vms))
        if self.mesh is not None:
            self.caches, flushed = simulator.resize_batch_sharded(
                self.caches, self.ways, w_new, self.mesh)
            flushed = simulator.gather_rows(flushed).cpu().numpy()
        elif self.cfg.batched:
            self.caches, flushed = resize_batch(self.caches, self.ways,
                                                w_new)
            flushed = flushed.cpu().numpy()
        else:
            flushed = np.zeros(self.num_vms, np.int64)
            for v in range(self.num_vms):
                self.caches[v], flushed[v] = simulator.resize_ref(
                    self.caches[v], int(self.ways[v]), int(w_new[v]))
        for v in range(self.num_vms):
            _add(self.stats[v], "disk_writes", int(flushed[v]))
            _add(self.stats[v], "evict_flushes", int(flushed[v]))
        self.ways = w_new

    def _run_sequential(self, win, policies: list[Policy],
                        cls_subs=None, tables=None) -> None:
        """The window's blocks one VM at a time (the reference oracle);
        with a classifier, ``tables`` is the window's ``(flags [V, C],
        lo, hi)``."""
        cfg = self.cfg
        chunk_lists = win.chunk_lists()
        for k in range(max(map(len, chunk_lists), default=0)):
            kth = [c[k] if k < len(c) else None for c in chunk_lists]
            with self.telemetry.span("datapath"):
                for v, chunk in enumerate(kth):
                    if chunk is None:
                        continue
                    a, w = _pad(np.asarray(chunk.addr, np.int32),
                                np.asarray(chunk.is_write), cfg.sim_chunk)
                    if cls_subs is None:
                        self.caches[v], st, t_end = \
                            simulator.simulate_single_level(
                                a, w, self.caches[v], int(self.ways[v]),
                                policies[v], t0=int(self.t[v]))
                        classes = None
                    else:
                        flags, lo, hi = tables
                        cpad = _cls_chunk([cls_subs[v]], k, cfg.sim_chunk)[0]
                        self.caches[v], st, t_end, *classes = \
                            simulator.simulate_single_level_classified(
                                a, w, cpad, self.caches[v],
                                int(self.ways[v]),
                                PolicyFlags(*(f[v] for f in flags)), lo[v],
                                hi[v], self._byp, t0=int(self.t[v]))
                    self.t[v] = int(t_end)
                    classes = _acc_one(self.stats[v], st, classes)
                    if classes is not None:
                        self.cls_hits[v] += classes[0]
                        self.cls_miss[v] += classes[1]
            self._sample_interval()

    def run(self, trace) -> list[VMResult]:
        """Drive the chassis over a :class:`Trace`, an on-disk
        :class:`repro_torch.traces.store.TraceStore`, or a pre-built
        :class:`repro_torch.traces.stream.StreamingTraceSource` —
        bit-identical results either way (the streamed paths hold one
        resize window at a time). Anything else raises ``TypeError``."""
        cfg = self.cfg
        g = cfg.geometry
        grid = _mrc_grid(g, cfg.mrc_points)
        alloc_hist = [[] for _ in range(self.num_vms)]
        source = window_source(trace, self.num_vms, cfg.resize_interval,
                               cfg.sim_chunk, cfg.prefetch,
                               cfg.prefetch_depth, self.device,
                               self._rows - self.num_vms, self.mesh)
        for win in source.windows():
            subs = win.subs
            # IO classification: bypass-class requests never reach the
            # cache, so they are cut from the sizing and policy sub-traces
            cls_subs, subs_sz = None, subs
            if self.classifier is not None:
                cls_subs, self._cls_end, self._cls_len = \
                    self.classifier.classify_subs(subs, self._cls_end,
                                                  self._cls_len, self.device)
                wts = self.classifier.weights
                keep = [wts[c] > 0 for c in cls_subs]
                subs_sz = [s if m.all() else s[m]
                           for s, m in zip(subs, keep)]
            demands, curves, policies = self._size(subs_sz, grid)
            res = _partition(demands, curves, grid, cfg.capacity)
            if cls_subs is None:
                counts = np.array([len(s) for s in subs], np.float64)
            else:
                counts = np.array([wts[c].sum() for c in cls_subs],
                                  np.float64)
            alloc = _expand_to_capacity(res.alloc, counts, cfg.capacity, g)
            self.logs.append(IntervalLog(demands, alloc,
                                         [p.value for p in policies]))
            self._resize(capacity_to_ways(alloc, g.num_sets, g.max_ways))
            for v in range(self.num_vms):
                alloc_hist[v].append(int(alloc[v]))
            tables = None
            if cls_subs is not None:
                # per-(VM, class) policy flags and insertion way ranges
                tables = (_class_policy_flags(
                    self.classifier.vm_policies(policies)),
                    *self.classifier.way_bounds(self.ways))
            if not cfg.batched:
                self._run_sequential(win, policies, cls_subs, tables)
                continue
            if self.mesh is not None:
                # dead rows take the WB default: with zero ways and
                # addr -1 blocks they never touch their cache
                pols = policies + [Policy.WB] * (self._rows - self.num_vms)
                ways = simulator.shard_rows(self.ways, self.mesh)
                flags = simulator.shard_rows(policy_flags(pols, "cpu"),
                                             self.mesh)
            else:
                ways = torch.from_numpy(self.ways).to(self.device)
                if tables is None:
                    flags = policy_flags(policies, self.device)
                else:
                    flags_vc = PolicyFlags(*(upload(f, self.device)
                                             for f in tables[0]))
                    lo, hi = (upload(x, self.device) for x in tables[1:])
                    byp = upload(self._byp, self.device)
            for k, (a, w, _, kth) in enumerate(win.blocks()):
                with self.telemetry.span("datapath") as sp:
                    if self.mesh is not None:
                        self.caches, st, self.t = \
                            simulator.simulate_single_level_sharded(
                                a, w, self.caches, ways, flags, self.mesh,
                                t0=self.t)
                        st, classes = simulator.gather_rows(st), None
                    elif tables is None:
                        self.caches, st, self.t = \
                            simulator.simulate_single_level_batch(
                                a, w, self.caches, ways, flags, t0=self.t)
                        classes = None
                    else:
                        cmat = upload(_cls_chunk(cls_subs, k, cfg.sim_chunk),
                                      self.device)
                        self.caches, st, self.t, *classes = \
                            simulator.simulate_single_level_classified_batch(
                                a, w, cmat, self.caches, ways, flags_vc, lo,
                                hi, byp, t0=self.t)
                    sp.ready(_last(self.t))
                classes = _acc_block(self.stats, st, kth, classes)
                if classes is not None:
                    self.cls_hits += classes[0]
                    self.cls_miss += classes[1]
                self._sample_interval()
        return [VMResult(dict(self.stats[v]),
                         np.asarray(alloc_hist[v], np.int64))
                for v in range(self.num_vms)]
