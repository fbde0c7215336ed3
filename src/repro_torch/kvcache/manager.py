"""Two-tier KV page manager: ETICA's policy engine applied to serving.

The PyTorch counterpart of :mod:`repro.kvcache.manager`. Tier 1 is the
device page pool (fast, capacity-pressured, a read-only cache: every
resident page is a clean copy that may be dropped); tier 2 is the host
pool (authoritative, write-back/write-only: every appended page is
written there exactly once, so host-DMA write traffic, the wear analog,
is bounded by generated tokens). Tenants play the VMs, session
activations the reads and page appends the writes:

  * POD(RO) over each tenant's activation window sizes its pool
    partition, split under pressure by PPC;
  * Eq. 1 popularity ranks sessions; maintenance drops cold sessions'
    pages down to quota (pull mode: an activation miss copies pages up
    but is no promotion decision).

``batched=True`` (default) runs the controller on the batched machinery:
bounded ``[T, window]`` per-tenant rings, every tenant's sizing in one
``reuse.pod_distances_batch`` pass, and maintenance as one
:func:`~repro_torch.kernels.maintenance.ops.serving_maintenance`
dispatch over a device-resident ``[T, K]`` popularity table, with one
host synchronisation per interval. ``batched=False`` is the host-dict
sequential oracle with one numpy :class:`PopularityTracker` per tenant.
Both give the same Stats, quotas and page placements request for
request, and both equal the JAX package's.

The pools are ``[num_layers, hbm_pages, PS, Hkv, D]`` tensors on the
manager's device, laid out for
:func:`repro_torch.kernels.decode_attention.ops.decode_attention`. The
host tier keeps references to the CPU page tensors it is handed; a copy
up is one ``non_blocking`` copy on the current stream (pinned pages,
as :func:`repro_torch.launch.serve.kv_page_bank` makes them, do not
wait for the device) and a conversion into the pool's dtype on the
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import popularity as pop
from repro_torch.core import reuse
from repro_torch.core.partition import partition as _partition, size_grid
from repro_torch.core.policies import Policy
from repro_torch.core.popularity import PopularityTracker, contributions
from repro_torch.kernels import resolve_device, upload
from repro_torch.kernels.maintenance.ops import serving_maintenance
from repro_torch.runtime.telemetry import TelemetryRecorder

PCIE_BW = 8e9            # bytes/s per host link (dma latency model)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass
class TwoTierConfig:
    page_size: int = 256          # tokens per page
    hbm_pages: int = 256          # tier-1 pool capacity
    num_kv_heads: int = 8
    head_dim: int = 128
    num_layers: int = 1           # pages are per-layer-stacked
    dtype: str = "bfloat16"
    maintenance_interval: int = 64   # activations between maintenance
    resize_interval: int = 512       # activations between re-partitioning
    popularity_decay: float = 0.5
    pop_capacity: int = 256       # [T, K] popularity-table slots per tenant
    materialize: bool = True      # keep device page pools in sync; off =
                                  # controller-only mode (Stats identical,
                                  # no decode)
    clean_quota: int = 0          # deferred write-back: max dirty-page
                                  # flushes per tenant per maintenance
                                  # interval (0 = eager commit on append)
    telemetry: object | None = None  # a runtime.telemetry
                                  # .TelemetryRecorder; None gets a default
                                  # bounded recorder (Stats identical)

    @property
    def page_bytes(self) -> int:
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * self.head_dim * _torch_dtype(self.dtype).itemsize)


@dataclasses.dataclass
class Session:
    tenant: int
    length: int = 0                       # tokens
    pages: list = dataclasses.field(default_factory=list)   # logical pages
    hbm_slots: dict = dataclasses.field(default_factory=dict)
    # logical page -> pool slot (only for resident pages)


@dataclasses.dataclass
class Stats:
    activations: int = 0
    hits: int = 0                  # fully resident activations
    appends: int = 0               # pages generated (WBWO commits)
    dma_read_bytes: int = 0        # host -> device copies (misses)
    dma_write_bytes: int = 0       # device -> host commits (the wear analog)
    latency_s: float = 0.0
    sessions_ended: int = 0        # churn: retired sessions
    pop_drops: int = 0             # [T, K] table merge-overflow drops
    flushes: int = 0               # background-cleaner page commits
    evict_flushes: int = 0         # dirty pages committed on slot release
    dirty_resident: int = 0        # gauge: uncommitted pages right now
    dirty_dropped: int = 0         # dirty pages retired with the session
    #                                (no DMA: host copy freed uncommitted)

    def as_dict(self):
        return dataclasses.asdict(self) | {
            "hit_ratio": self.hits / max(self.activations, 1)}


class _TraceRing:
    """Bounded controller-trace ring: the last ``window`` requests with
    their session id, record-time tenant and write flag."""

    def __init__(self, window: int):
        self.window = window
        self.sid = np.zeros(window, np.int32)
        self.tenant = np.zeros(window, np.int32)
        self.write = np.zeros(window, bool)
        self.n = 0               # total records ever pushed

    def push(self, sid: int, tenant: int, write: bool):
        pos = self.n % self.window
        self.sid[pos] = sid
        self.tenant[pos] = tenant
        self.write[pos] = write
        self.n += 1

    def arrays(self):
        """(sid, tenant, write) of the last ``min(n, window)`` records in
        chronological order."""
        if self.n < self.window:
            sl = slice(0, self.n)
            return self.sid[sl], self.tenant[sl], self.write[sl]
        pos = self.n % self.window
        order = np.r_[pos:self.window, 0:pos]
        return self.sid[order], self.tenant[order], self.write[order]


class _TenantRings:
    """``[T, window]`` per-tenant trace rings (batched controller). Each
    record carries its global sequence number, so ``window_rows`` gives
    exactly the per-tenant sub-traces of the last ``window`` global
    records."""

    def __init__(self, num_tenants: int, window: int):
        self.window = window
        self.sid = np.zeros((num_tenants, window), np.int32)
        self.write = np.zeros((num_tenants, window), bool)
        self.seq = np.full((num_tenants, window), -1, np.int64)
        self.count = np.zeros(num_tenants, np.int64)  # pushes per tenant

    def push(self, tenant: int, sid: int, write: bool, seq: int):
        pos = self.count[tenant] % self.window
        self.sid[tenant, pos] = sid
        self.write[tenant, pos] = write
        self.seq[tenant, pos] = seq
        self.count[tenant] += 1

    def window_rows(self, min_seq: int):
        """Per-tenant (sid, write) arrays of records with
        ``seq >= min_seq``, each in chronological order."""
        sids, writes = [], []
        for t in range(self.seq.shape[0]):
            n = int(min(self.count[t], self.window))
            if n == 0:
                sids.append(np.empty(0, np.int32))
                writes.append(np.empty(0, bool))
                continue
            if self.count[t] < self.window:
                order = np.arange(n)
            else:
                pos = int(self.count[t] % self.window)
                order = np.r_[pos:self.window, 0:pos]
            keep = self.seq[t, order] >= min_seq
            sids.append(self.sid[t, order][keep])
            writes.append(self.write[t, order][keep])
        return sids, writes


def quota_with_floor(alloc: np.ndarray, capacity: int) -> np.ndarray:
    """Give every tenant >= 1 page without exceeding the pool: raising a
    tenant to the floor is paid for by shaving the largest allocations,
    one page at a time (never below the floor)."""
    alloc = np.asarray(alloc, np.int64).copy()
    if capacity < alloc.size:       # pool smaller than tenant count:
        alloc = np.minimum(alloc, 1)   # floor is unsatisfiable; best effort
        while alloc.sum() > capacity:
            alloc[np.argmax(alloc)] -= 1
        return alloc
    alloc = np.maximum(alloc, 1)
    while alloc.sum() > capacity:
        big = np.argmax(alloc)
        if alloc[big] <= 1:
            break
        alloc[big] -= 1
    return alloc


class TwoTierKVManager:
    """Host-side datapath (page tables, pools) + batched or sequential
    controller (see module docstring)."""

    def __init__(self, cfg: TwoTierConfig, num_tenants: int,
                 batched: bool = True, device="cuda"):
        self.cfg = cfg
        self.num_tenants = num_tenants
        self.batched = batched
        self.device = resolve_device(device)
        shape = (cfg.num_layers, cfg.hbm_pages, cfg.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        if cfg.materialize:
            dt = _torch_dtype(cfg.dtype)
            self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
            self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        else:
            self.k_pool = self.v_pool = None
        self.free = list(range(cfg.hbm_pages))
        self.slot_owner: dict[int, tuple[int, int]] = {}  # slot -> (sid, lp)
        # tier-2 host pool: {(sid, logical_page): (k, v) CPU tensors}
        self.host: dict[tuple[int, int], tuple] = {}
        self.sessions: dict[int, Session] = {}
        self._ring = _TraceRing(cfg.resize_interval)
        if batched:
            self._trings = _TenantRings(num_tenants, cfg.resize_interval)
            self._table = pop.table_init(num_tenants, cfg.pop_capacity,
                                         self.device)
            self._mirror_table()
            self.trackers = None
        else:
            self._trings = None
            self._table = None
            self.trackers = [PopularityTracker(cfg.popularity_decay)
                             for _ in range(num_tenants)]
        self.tenant_quota = np.full(num_tenants,
                                    cfg.hbm_pages // max(num_tenants, 1))
        self.tenant_used = np.zeros(num_tenants, np.int64)
        self.stats = Stats()
        self.telemetry = (cfg.telemetry if cfg.telemetry is not None
                          else TelemetryRecorder())
        self._since_maint = 0
        self._since_resize = 0
        # deferred write-back (clean_quota > 0): uncommitted appended
        # pages, (sid, lp) -> global append sequence (the cleaner's age)
        self._dirty: dict[tuple[int, int], int] = {}
        self._append_seq = 0

    def _mirror_table(self) -> None:
        """Host copy of the device table for between-tick score lookups."""
        self._pop_addr = self._table.addr.cpu().numpy()
        self._pop_val = self._table.val.cpu().numpy()

    def load_state(self, *, free, slot_owner, sessions, host, ring,
                   tenant_quota, tenant_used, stats, dirty, append_seq,
                   since_maint, since_resize, tenant_rings=None, table=None,
                   trackers=None, k_pool=None, v_pool=None) -> None:
        """Continue from another manager's state (the JAX package's),
        given as numpy arrays and Python objects: ``free`` (list order
        kept), ``slot_owner`` ``{slot: (sid, lp)}``, ``sessions`` ``{sid:
        session}`` (objects with ``tenant``, ``length``, ``pages`` and
        ``hbm_slots``), ``host`` ``{(sid, lp): (k, v)}`` pages, ``ring``
        ``(sid, tenant, write, n)``, ``tenant_rings`` ``(sid, write, seq,
        count)`` and ``table`` ``(addr, val)`` ``[T, K]`` of the batched
        controller or ``trackers`` ``[(addr, val)]`` of the sequential
        one, the quotas and used counts, ``stats`` (an object with the
        :class:`Stats` fields), ``dirty`` ``{(sid, lp): seq}``, the append
        sequence and the two tick counters, and the ``[L, hbm_pages, PS,
        Hkv, D]`` pools when the manager materializes them."""
        self.free = [int(s) for s in free]
        self.slot_owner = {int(s): (int(a), int(b))
                           for s, (a, b) in slot_owner.items()}
        self.sessions = {int(sid): Session(
            tenant=int(s.tenant), length=int(s.length),
            pages=[int(p) for p in s.pages],
            hbm_slots={int(a): int(b) for a, b in s.hbm_slots.items()})
            for sid, s in sessions.items()}
        self.host = {(int(a), int(b)): (torch.tensor(np.asarray(k)),
                                        torch.tensor(np.asarray(v)))
                     for (a, b), (k, v) in host.items()}
        self._ring.sid[:], self._ring.tenant[:], self._ring.write[:] = \
            ring[:3]
        self._ring.n = int(ring[3])
        if self.batched:
            tr = self._trings
            tr.sid[:], tr.write[:], tr.seq[:], tr.count[:] = tenant_rings
            self._table = pop.PopularityTable(
                torch.tensor(np.asarray(table[0], np.int32),
                             device=self.device),
                torch.tensor(np.asarray(table[1], np.float32),
                             device=self.device))
            self._mirror_table()
        else:
            for trk, (a, v) in zip(self.trackers, trackers):
                trk._addr = np.asarray(a, np.int64).copy()
                trk._val = np.asarray(v, np.float32).copy()
        self.tenant_quota = np.asarray(tenant_quota).copy()
        self.tenant_used = np.asarray(tenant_used, np.int64).copy()
        self.stats = Stats(**{f.name: getattr(stats, f.name)
                              for f in dataclasses.fields(Stats)})
        self._dirty = {(int(a), int(b)): int(q)
                       for (a, b), q in dirty.items()}
        self._append_seq = int(append_seq)
        self._since_maint = int(since_maint)
        self._since_resize = int(since_resize)
        if self.cfg.materialize:
            dt = _torch_dtype(self.cfg.dtype)
            self.k_pool = torch.tensor(np.asarray(k_pool, np.float32),
                                       device=self.device).to(dt)
            self.v_pool = torch.tensor(np.asarray(v_pool, np.float32),
                                       device=self.device).to(dt)

    # -- session lifecycle ------------------------------------------------
    def new_session(self, sid: int, tenant: int):
        self.sessions[sid] = Session(tenant=tenant)

    def end_session(self, sid: int):
        """Churn: the session leaves for good — release its slots and
        drop its tier-2 pages (no DMA: the host copies are freed)."""
        sess = self.sessions[sid]
        for lp in list(sess.hbm_slots):
            self._release_slot(sid, lp, drop=True)
        for lp in sess.pages:
            self.host.pop((sid, lp), None)
        del self.sessions[sid]
        self.stats.sessions_ended += 1

    def _alloc_slot(self, sid: int, lp: int) -> int:
        if not self.free:
            self._evict_one(exclude_sid=sid)
        slot = self.free.pop()
        self.slot_owner[slot] = (sid, lp)
        sess = self.sessions[sid]
        sess.hbm_slots[lp] = slot
        self.tenant_used[sess.tenant] += 1
        return slot

    def _release_slot(self, sid: int, lp: int, drop: bool = False):
        """Free a session's slot. A dirty page settles first: it is
        force-flushed to the host pool (``evict_flushes``), or with
        ``drop`` (the session retires) discarded uncommitted."""
        sess = self.sessions[sid]
        slot = sess.hbm_slots.pop(lp, None)
        if slot is not None:
            self.slot_owner.pop(slot, None)
            self.free.append(slot)
            self.tenant_used[sess.tenant] -= 1
            key = (sid, lp)
            if key in self._dirty:
                if drop:
                    self._dirty.pop(key)
                    self.stats.dirty_dropped += 1
                    self.stats.dirty_resident = len(self._dirty)
                else:
                    self._flush_page(key, evict=True)

    def _flush_page(self, key: tuple[int, int], evict: bool = False):
        """Commit an uncommitted page to the host pool now (cleaner flush
        or eviction-forced flush)."""
        self._dirty.pop(key)
        self.stats.dma_write_bytes += self.cfg.page_bytes
        if evict:
            self.stats.evict_flushes += 1
        else:
            self.stats.flushes += 1
        self.stats.dirty_resident = len(self._dirty)

    def _scores(self, tenants: np.ndarray, sids: np.ndarray) -> np.ndarray:
        """Popularity of (tenant, sid) pairs (float32), from the device
        table's host mirror (batched) or the trackers (sequential)."""
        tenants = np.asarray(tenants)
        sids = np.asarray(sids)
        out = np.zeros(sids.shape, np.float32)
        for t in np.unique(tenants):
            m = tenants == t
            if self.batched:
                row_a, row_v = self._pop_addr[t], self._pop_val[t]
                pos = np.searchsorted(row_a, sids[m].astype(np.int32))
                pos_c = np.minimum(pos, row_a.size - 1)
                hit = (pos < row_a.size) & (row_a[pos_c]
                                            == sids[m].astype(np.int32))
                vals = np.zeros(int(m.sum()), np.float32)
                vals[hit] = row_v[pos_c[hit]]
                out[m] = vals
            else:
                out[m] = self.trackers[int(t)].scores_for(sids[m])
        return out

    def _evict_one(self, exclude_sid: int):
        """Drop the least popular resident page (RO tier: no write-back),
        preferring tenants over quota; never the active session."""
        cands = [(slot, sid, lp) for slot, (sid, lp) in self.slot_owner.items()
                 if sid != exclude_sid]
        if not cands:
            raise RuntimeError("HBM pool exhausted by a single session")
        sids = np.array([sid for _, sid, _ in cands], np.int64)
        tens = np.array([self.sessions[int(s)].tenant for s in sids],
                        np.int64)
        over = self.tenant_used[tens] - self.tenant_quota[tens]
        pops = self._scores(tens, sids)
        # min((-over, pop)) with first-encounter tie-break
        pick = int(np.lexsort((np.arange(len(cands)), pops, -over))[0])
        slot, sid, lp = cands[pick]
        self._release_slot(sid, lp)

    # -- datapath ----------------------------------------------------------
    def _install(self, slot: int, k_page, v_page) -> None:
        """Copy one page (``[L or 1, PS, Hkv, D]`` on the host) into pool
        slot ``slot`` of every layer."""
        for pool, page in ((self.k_pool, k_page), (self.v_pool, v_page)):
            page = torch.as_tensor(page)
            if self.device.type != "cpu":
                page = page.to(self.device, non_blocking=True)
            pool[:, slot].copy_(page)

    def activate(self, sid: int) -> np.ndarray:
        """Make a session's pages resident; returns its page table. A
        fully resident activation is a hit; missing pages are copied up
        from the host pool at DMA cost (the READ of the mapping)."""
        sess = self.sessions[sid]
        self._record(sid, write=False)
        missing = [lp for lp in sess.pages if lp not in sess.hbm_slots]
        self.stats.activations += 1
        if not missing:
            self.stats.hits += 1
        for lp in missing:
            slot = self._alloc_slot(sid, lp)
            if self.cfg.materialize:
                self._install(slot, *self.host[(sid, lp)])
            self.stats.dma_read_bytes += self.cfg.page_bytes
            self.stats.latency_s += self.cfg.page_bytes / PCIE_BW
        self._maintenance_tick(active_sid=sid)
        pt = self.page_table(sid)
        # maintenance excluded the active session, so every page must be
        # resident: a -1 here would read another session's KV in decode
        assert (pt >= 0).all(), \
            f"activate({sid}): non-resident page in active page table"
        return pt

    def append_page(self, sid: int, k_page, v_page):
        """Commit a freshly generated page: written once to the host pool
        (tier-2 WBWO, the only mandatory DMA write) and installed in the
        pool for the ongoing decode (the WRITE of the mapping)."""
        sess = self.sessions[sid]
        lp = len(sess.pages)
        sess.pages.append(lp)
        k_page, v_page = torch.as_tensor(k_page), torch.as_tensor(v_page)
        self.host[(sid, lp)] = (k_page, v_page)
        if self.cfg.clean_quota > 0:
            # deferred write-back: the DMA commit waits for the cleaner or
            # for an eviction
            self._dirty[(sid, lp)] = self._append_seq
            self.stats.dirty_resident = len(self._dirty)
        else:
            self.stats.dma_write_bytes += self.cfg.page_bytes
        self._append_seq += 1
        self.stats.appends += 1
        slot = self._alloc_slot(sid, lp)
        if self.cfg.materialize:
            self._install(slot, k_page, v_page)
        sess.length = lp * self.cfg.page_size + k_page.shape[1]
        self._record(sid, write=True)

    def page_table(self, sid: int) -> np.ndarray:
        """Logical page -> pool slot; ``-1`` marks a non-resident page."""
        sess = self.sessions[sid]
        return np.array([sess.hbm_slots.get(lp, -1) for lp in sess.pages],
                        np.int32)

    def deactivate(self, sid: int):
        """Session leaves the active batch; pages stay until evicted
        (pull mode: no datapath demotion)."""

    # -- controller --------------------------------------------------------
    def _record(self, sid: int, write: bool):
        tenant = self.sessions[sid].tenant
        self._ring.push(sid, tenant, write)
        if self.batched:
            self._trings.push(tenant, sid, write, self._ring.n - 1)
        self._since_maint += 1
        self._since_resize += 1

    def _maintenance_tick(self, active_sid: int | None = None):
        cfg = self.cfg
        ran = False
        if self._since_maint >= cfg.maintenance_interval:
            self._since_maint = 0
            ran = True
            if self.batched:
                self._maintain_batched(exclude_sid=active_sid)
            else:
                self._update_popularity()
                self._clean_tick()
                self._evict_cold(exclude_sid=active_sid)
        if self._since_resize >= cfg.resize_interval:
            self._since_resize = 0
            self._repartition()
        if ran:
            # one journal row per maintenance interval, from host state
            self.telemetry.sample_serving(self.stats,
                                          quota=self.tenant_quota,
                                          used=self.tenant_used)

    def _resident_by_tenant(self, exclude_sid: int | None):
        """Per-tenant resident sessions (page-table insertion order) and
        their resident-page counts."""
        per: list[dict[int, int]] = [dict() for _ in range(self.num_tenants)]
        for slot, (sid, lp) in self.slot_owner.items():
            if sid == exclude_sid:
                continue
            t = self.sessions[sid].tenant
            per[t][sid] = per[t].get(sid, 0) + 1
        return per

    # ---- sequential oracle path (host dicts + trackers) -----------------
    def _update_popularity(self):
        addr, tenant, wr = self._ring.arrays()
        if addr.size == 0:
            return
        r = reuse.pod_distances(addr, wr, Policy.RO, self.device)
        cs = torch.tensor([max(int(self.tenant_quota.sum()), 1)],
                          dtype=torch.float32)
        contrib = contributions(torch.from_numpy(r.dist),
                                torch.from_numpy(r.served), cs).numpy()
        for t in range(self.num_tenants):
            mask = tenant == t
            if mask.any():
                self.trackers[t].update(addr[mask].astype(np.int64),
                                        contrib[mask])

    def _evict_cold(self, exclude_sid: int | None = None):
        """Drop the coldest resident sessions' pages down to quota (clean
        copies, no write-back); never the active session."""
        per = self._resident_by_tenant(exclude_sid)
        for t in range(self.num_tenants):
            over = self.tenant_used[t] - self.tenant_quota[t]
            if over <= 0:
                continue
            resident = per[t]
            sids = np.fromiter(resident.keys(), np.int64,
                               count=len(resident))
            scores = self._scores(np.full(sids.shape, t), sids)
            order = np.argsort(scores, kind="stable")
            for i in order:
                sid = int(sids[i])
                lps = [lp for lp in self.sessions[sid].hbm_slots]
                for lp in lps:
                    if over <= 0:
                        break
                    self._release_slot(sid, lp)
                    over -= 1

    def _clean_tick(self):
        """Background cleaner (sequential oracle): commit each tenant's
        ``clean_quota`` oldest uncommitted pages, before eviction."""
        if self.cfg.clean_quota <= 0 or not self._dirty:
            return
        per: list[list] = [[] for _ in range(self.num_tenants)]
        for key, seq in self._dirty.items():
            per[self.sessions[key[0]].tenant].append((seq, key))
        for t in range(self.num_tenants):
            per[t].sort()
            for _, key in per[t][: self.cfg.clean_quota]:
                self._flush_page(key)

    # ---- batched path (device table + fused dispatch) -------------------
    def _dirty_by_tenant(self):
        """Per-tenant dirty pages in age order: ``ditems[t]`` is ``[(seq,
        sid, lp), ...]`` ascending and ``dirty_age`` the ``[T, max_dirty]``
        matrix (``-1`` pad) the fused dispatch ranks."""
        ditems: list[list] = [[] for _ in range(self.num_tenants)]
        for (sid, lp), seq in self._dirty.items():
            ditems[self.sessions[sid].tenant].append((seq, sid, lp))
        dmax = max([len(d) for d in ditems] + [1])
        dirty_age = np.full((self.num_tenants, dmax), -1, np.int32)
        for t, d in enumerate(ditems):
            d.sort()
            for i, (seq, _, _) in enumerate(d):
                dirty_age[t, i] = seq
        return ditems, dirty_age

    def _maintain_batched(self, exclude_sid: int | None = None):
        addr, tenant, wr = self._ring.arrays()
        if addr.size == 0:
            return
        r = reuse.pod_distances(addr, wr, Policy.RO, self.device,
                                host=False)
        per = self._resident_by_tenant(exclude_sid)
        smax = max(max((len(p) for p in per), default=0), 1)
        t_axis = self.num_tenants
        cand_sid = np.full((t_axis, smax), -1, np.int32)
        cand_pages = np.zeros((t_axis, smax), np.int32)
        for t, p in enumerate(per):
            for i, (sid, n) in enumerate(p.items()):
                cand_sid[t, i] = sid
                cand_pages[t, i] = n
        over = self.tenant_used - self.tenant_quota
        ditems, dirty_age = self._dirty_by_tenant()
        # every host operand in one upload
        parts = (addr, tenant, cand_sid, cand_pages, over,
                 [max(int(self.tenant_quota.sum()), 1)], dirty_age)
        flat = upload(np.concatenate(
            [np.asarray(x, np.int32).ravel() for x in parts]), self.device)
        cuts = np.cumsum([0] + [int(np.size(x)) for x in parts])
        dev = [flat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        with self.telemetry.span("serving_maintenance") as sp:
            self._table, drops, eorder, take, fpick = serving_maintenance(
                self._table, r.dist, r.served, dev[0], dev[1],
                dev[2].view(t_axis, smax), dev[3].view(t_axis, smax), dev[4],
                dev[5].float(), decay=self.cfg.popularity_decay,
                dirty_age=dev[6].view(dirty_age.shape),
                clean_quota=self.cfg.clean_quota)
            sp.ready(self._table.addr)
        # one host sync per interval: queues, cleaner picks, drops, mirror
        k = self._table.addr.shape[1]
        out = torch.cat([eorder.reshape(-1), take.reshape(-1),
                         fpick.reshape(-1), drops.to(torch.int32),
                         self._table.addr.reshape(-1),
                         self._table.val.view(torch.int32).reshape(-1)]
                        ).cpu().numpy()
        sb = eorder.shape[1]
        eorder, take, fpick, drops, addr_m, val_m = np.split(
            out, np.cumsum([t_axis * sb, t_axis * sb, fpick.numel(), t_axis,
                            t_axis * k]))
        eorder, take = eorder.reshape(t_axis, sb), take.reshape(t_axis, sb)
        fpick = fpick.reshape(dirty_age.shape)
        self._pop_addr = addr_m.reshape(t_axis, k)
        self._pop_val = val_m.view(np.float32).reshape(t_axis, k)
        self.stats.pop_drops += int(drops.sum())
        # cleaner picks apply before the eviction queue (both were ranked
        # against the same state): a page the cleaner reaches is a
        # `flushes` commit and eviction then releases it clean
        for t, d in enumerate(ditems):
            for i, (_, sid, lp) in enumerate(d):
                if fpick[t, i]:
                    self._flush_page((sid, lp))
        for t in range(t_axis):
            if over[t] <= 0:
                continue
            for i in range(sb):
                pos = int(eorder[t, i])
                k = int(take[t, i])
                if k <= 0 or pos >= smax or cand_sid[t, pos] < 0:
                    continue
                sid = int(cand_sid[t, pos])
                for lp in list(self.sessions[sid].hbm_slots)[:k]:
                    self._release_slot(sid, lp)

    # ---- repartitioning (shared; sizing dispatch differs) ----------------
    def _tenant_subtraces(self):
        """Per-tenant (sid, write) sub-traces of the controller window,
        from the ``[T, window]`` rings (batched) or by masking the global
        ring (sequential); identical by construction."""
        if self.batched:
            return self._trings.window_rows(
                max(self._ring.n - self._ring.window, 0))
        addr, tenant, wr = self._ring.arrays()
        return ([addr[tenant == t] for t in range(self.num_tenants)],
                [wr[tenant == t] for t in range(self.num_tenants)])

    def _repartition(self):
        """POD(RO) per tenant over the activation window, then a PPC split
        of the pool (paper §4.3 applied to pages)."""
        sids, writes = self._tenant_subtraces()
        if sum(int(s.size) for s in sids) == 0:
            return
        grid = size_grid(self.cfg.hbm_pages, 16)
        demands = np.zeros(self.num_tenants, np.int64)
        curves = np.zeros((self.num_tenants, grid.size))
        if self.batched:
            with self.telemetry.span("serving_sizing"):
                rs = reuse.pod_distances_batch(sids, writes, Policy.RO,
                                               self.device)
        else:
            rs = [reuse.pod_distances(s, w, Policy.RO, self.device)
                  if s.size else None for s, w in zip(sids, writes)]
        for t, r in enumerate(rs):
            if r is None:
                continue
            # demand in sessions -> pages (mean pages per session of tenant)
            sess_pages = [len(s.pages) or 1 for s in self.sessions.values()
                          if s.tenant == t] or [1]
            per = int(np.ceil(np.mean(sess_pages)))
            demands[t] = min(reuse.demand_blocks(int(r.max)) * per,
                             self.cfg.hbm_pages)
            hits = reuse.hit_counts_at_sizes(
                r.dist, r.served, np.maximum(grid // per, 1))
            curves[t] = np.asarray(hits, np.float64) / max(sids[t].size, 1)
        res = _partition(demands, curves, grid, self.cfg.hbm_pages)
        self.tenant_quota = quota_with_floor(res.alloc, self.cfg.hbm_pages)
