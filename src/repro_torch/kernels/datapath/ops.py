"""The datapath kernels' wrappers and their plain PyTorch versions.

``two_level`` (ETICA's DRAM + SSD) and ``single_level`` (the one-level
baselines) each run one ``[V, N]`` request block for all VMs: CUDA
tensors go through the kernel (``csrc/datapath.cu``,
``csrc/single_level.cu``: each cache set's requests walked in order by
one warp, the sets in parallel, one CTA a VM or several while the VMs
leave SMs idle, ``csrc/set_walk.cuh``), CPU tensors through
:func:`two_level_plain` / :func:`single_level_plain`. All are
functional: the states come back as new tensors (the kernels read the
input state and write every row of fresh outputs).

Operands: ``addr`` int32 ``[V, N]`` (``-1`` = no-op), ``is_write`` bool
``[V, N]``; per level ``tags``/``lru`` int32 ``[V, S, W]`` and ``dirty``
bool ``[V, S, W]``; ways and ``t0`` int32 ``[V]``; ``single_level``'s
four policy flags bool ``[V]``. The outputs end in ``(counts, latency,
t_end)`` with ``counts`` int32 ``[V, 8]`` in :data:`COUNT_FIELDS` order
and ``latency`` float32 ``[V]``.

``two_level_classified`` and ``single_level_classified`` (the
``classified`` routes, the IO classifier's datapaths) take beside them a
class id per request, ``cls`` int32 ``[V, N]`` (clipped to ``[0, C)``),
a ``bypass`` mask bool ``[C]`` and insertion way bounds int32 ``[V, C]``
(one pair, or one pair a level for ``two_level``; non-negative, as
:meth:`repro_torch.classify.Classifier.way_bounds` gives them), and for
``single_level`` the four policy flags as bool ``[V, C]``. Their counts
are ``[V, 9]`` (:data:`COUNT_FIELDS`, then ``bypassed``), and they
also return the per-class served hits and misses, int32 ``[V, C]``. A
lookup stays over all active ways; only the victim is taken from the
class's range ``[min(lo, hi'), hi')``, ``hi' = min(hi, ways)``. At most
:data:`MAX_CLASSES` classes on the card, and at most
:func:`max_classified_sets` sets a level.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.policies import T_DRAM, T_HDD, T_HDD_WRITE, T_SSD

COUNT_FIELDS = ("reads", "writes", "read_hits_l1", "read_hits_l2",
                "write_hits_l2", "cache_writes_l2", "disk_reads",
                "disk_writes")
MAX_CLASSES = 256    # class ids of a classified walk
# flag bits below the class id in a classified walk's keys
# (csrc/datapath.cu, csrc/single_level.cu kClsFlagBits)
CLASS_FLAG_BITS = {"two_level": 3, "single_level": 6}
INT32_MAX = 2**31 - 1
WALK_WARPS = 16      # warps of a set-walk CTA (csrc/set_walk.cuh kWalkWarps)


def _split(dev, v: int, n: int, sets: int, extra: int = 0):
    """``(parts, scratch)`` of a set-walk launch. While the VMs leave SMs
    idle, each VM's sets are split across ``parts`` CTAs, about one set a
    warp; those CTAs leave their latencies ([V, n] float32) and counts
    ([V, parts, 8 + extra]) in scratch for the VM's last CTA, counted by
    a zeroed ticket a VM: fresh for the unclassified walks; for the
    classified ones (``extra`` = ``2C + 1``, their extra counts) the
    kept :func:`_tickets`, which the kernel puts back to 0. From shapes
    alone, so no host sync."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = max(1, min(sms // v, sets // WALK_WARPS))
    if parts == 1:
        return 1, ()
    tickets = (_tickets(dev, v) if extra else
               torch.zeros(v, dtype=torch.int32, device=dev))
    return parts, (torch.empty(v * n, dtype=torch.float32, device=dev),
                   torch.empty(v * parts * (8 + extra), dtype=torch.int32,
                               device=dev),
                   tickets)


_TICKETS: dict = {}


def _tickets(dev, v: int) -> torch.Tensor:
    """The classified walks' per-VM tickets, zeroed once and kept per
    (device, stream): each launch's last CTA of a VM puts its ticket
    back to 0, so a launch needs no fill of its own (one device event a
    call); launches on one stream run in order, so they never share a
    ticket at once."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < v:
        t = torch.zeros(max(v, 256), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def _pointers(scratch) -> tuple:
    """The scratch's device pointers; null ones without a split."""
    return tuple(x.data_ptr() for x in scratch) if scratch else (0, 0, 0)


def two_level(addr, is_write, tags_d, lru_d, dirty_d, tags_s, lru_s,
              dirty_s, ways_d, ways_s, t0, *, npe: bool):
    if addr.device.type == "cpu":
        return two_level_plain(addr, is_write, tags_d, lru_d, dirty_d,
                               tags_s, lru_s, dirty_s, ways_d, ways_s, t0,
                               npe=npe)
    dev = addr.device
    v, n = addr.shape
    _, sd, wd = tags_d.shape
    _, ss, ws = tags_s.shape
    kernels.check(addr, "addr", torch.int32, (v, n), dev)
    kernels.check(is_write, "is_write", torch.bool, (v, n), dev)
    for name, t, s, w in (("tags_d", tags_d, sd, wd), ("lru_d", lru_d, sd, wd),
                          ("tags_s", tags_s, ss, ws), ("lru_s", lru_s, ss, ws)):
        kernels.check(t, name, torch.int32, (v, s, w), dev)
    kernels.check(dirty_d, "dirty_d", torch.bool, (v, sd, wd), dev)
    kernels.check(dirty_s, "dirty_s", torch.bool, (v, ss, ws), dev)
    for name, t in (("ways_d", ways_d), ("ways_s", ways_s), ("t0", t0)):
        kernels.check(t, name, torch.int32, (v,), dev)
    state = (tags_d, lru_d, dirty_d, tags_s, lru_s, dirty_s)
    out = [torch.empty_like(x) for x in state]
    counts = torch.empty((v, 8), dtype=torch.int32, device=dev)
    latency = torch.empty(v, dtype=torch.float32, device=dev)
    t_end = torch.empty(v, dtype=torch.int32, device=dev)
    if v:
        # the DRAM walk must see every SSD set's requests: split only when
        # the two levels have the same sets
        parts, scratch = _split(dev, v, n, sd) if sd == ss else (1, ())
        ptrs = [x.data_ptr() for x in (addr, is_write, *state, *out, ways_d,
                                       ways_s, t0, counts, latency, t_end)]
        kernels.launch("two_level", *ptrs, *_pointers(scratch), v, n, sd, wd,
                       ss, ws, int(npe), parts, T_DRAM, T_SSD, T_HDD,
                       T_HDD_WRITE, route="unclassified")
    return (*out, counts, latency, t_end)


def _lookup(tags, a, active):
    """(hit[V], first matching active way[V]) for each VM's set row."""
    eq = (tags == a[:, None]) & active
    return eq.any(dim=1), eq.to(torch.int32).argmax(dim=1)


def _victim(tags, lru, active):
    """First empty active way, else the first LRU-minimum active way."""
    score = torch.where(active, torch.where(tags < 0, -1, lru), INT32_MAX)
    return score.argmin(dim=1)


def two_level_plain(addr, is_write, tags_d, lru_d, dirty_d, tags_s, lru_s,
                    dirty_s, ways_d, ways_s, t0, *, npe: bool):
    """The datapath as a loop over requests, vectorised over VMs.

    Each step gathers every VM's set row at both levels, applies the
    request with masked updates, and writes the rows back — the same
    operations as one step of the JAX ``lax.scan``."""
    dev = addr.device
    v, n = addr.shape
    sd, sw = tags_d.shape[1], tags_s.shape[1]
    td, ld, dd, ts, ls, ds = [x.clone() for x in (tags_d, lru_d, dirty_d,
                                                  tags_s, lru_s, dirty_s)]
    vi = torch.arange(v, device=dev)
    wd_i = torch.arange(td.shape[2], dtype=torch.int32, device=dev)
    ws_i = torch.arange(ts.shape[2], dtype=torch.int32, device=dev)
    act_d = wd_i[None, :] < ways_d[:, None]
    act_s = ws_i[None, :] < ways_s[:, None]
    can_d, can_s = ways_d > 0, ways_s > 0
    counts = torch.zeros((v, 8), dtype=torch.int32, device=dev)
    lat_sum = torch.zeros(v, dtype=torch.float32, device=dev)
    t = t0.clone()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    t_dram, t_ssd, t_hdd, t_hddw = (f32(T_DRAM), f32(T_SSD), f32(T_HDD),
                                    f32(T_HDD_WRITE))
    zero = f32(0.0)
    valid_cols = (addr >= 0).any(dim=0).nonzero()
    n_eff = int(valid_cols.max()) + 1 if valid_cols.numel() else 0
    for k in range(n_eff):
        a_raw = addr[:, k]
        valid = a_raw >= 0
        a = a_raw.clamp(min=0)
        rd = valid & ~is_write[:, k]
        wr = valid & is_write[:, k]
        s1, s2 = a % sd, a % sw
        rt_d, rl_d, rdy_d = td[vi, s1], ld[vi, s1], dd[vi, s1]
        rt_s, rl_s, rdy_s = ts[vi, s2], ls[vi, s2], ds[vi, s2]
        d_hit, d_way = _lookup(rt_d, a, act_d)
        s_hit, s_way = _lookup(rt_s, a, act_s)
        oh_d = wd_i[None, :] == d_way[:, None]
        oh_s = ws_i[None, :] == s_way[:, None]
        tt = t[:, None]

        # read: DRAM hit -> touch; SSD hit -> touch SSD; DRAM miss inserts
        m = (rd & d_hit)[:, None] & oh_d
        rl_d = torch.where(m, tt, rl_d)
        m = (rd & s_hit & ~d_hit)[:, None] & oh_s
        rl_s = torch.where(m, tt, rl_s)
        vic = _victim(rt_d, rl_d, act_d)
        m = (rd & ~d_hit & can_d)[:, None] & (wd_i[None, :] == vic[:, None])
        rt_d = torch.where(m, a[:, None], rt_d)
        rl_d = torch.where(m, tt, rl_d)
        rdy_d = rdy_d & ~m

        # write: invalidate the DRAM copy; SSD hit -> touch + dirty; SSD
        # miss -> disk ("full") or a dirty insert ("npe")
        m = (wr & d_hit)[:, None] & oh_d
        rt_d = rt_d.masked_fill(m, -1)
        rl_d = rl_d.masked_fill(m, -1)
        rdy_d = rdy_d & ~m
        m = (wr & s_hit)[:, None] & oh_s
        rl_s = torch.where(m, tt, rl_s)
        rdy_s = rdy_s | m
        if npe:
            vic = _victim(rt_s, rl_s, act_s)
            ohv = ws_i[None, :] == vic[:, None]
            ev_dirty = ((rt_s >= 0) & rdy_s & ohv).any(dim=1)
            ins = wr & ~s_hit & can_s
            m = ins[:, None] & ohv
            rt_s = torch.where(m, a[:, None], rt_s)
            rl_s = torch.where(m, tt, rl_s)
            rdy_s = rdy_s | m
            committed = s_hit | can_s
            cw = wr & committed
            dw = wr & ((~s_hit & can_s & ev_dirty) | ~committed)
            w_lat = torch.where(committed, t_ssd, t_hddw)
        else:
            cw = wr & s_hit
            dw = wr & ~s_hit
            w_lat = torch.where(s_hit, t_ssd, t_hddw)
        r_lat = torch.where(d_hit, t_dram, torch.where(s_hit, t_ssd, t_hdd))
        lat = torch.where(rd, r_lat, torch.where(wr, w_lat, zero))

        td[vi, s1], ld[vi, s1], dd[vi, s1] = rt_d, rl_d, rdy_d
        ts[vi, s2], ls[vi, s2], ds[vi, s2] = rt_s, rl_s, rdy_s
        step = torch.stack([rd, wr, rd & d_hit, rd & s_hit & ~d_hit,
                            wr & s_hit, cw, rd & ~(d_hit | s_hit), dw], 1)
        counts += step.to(torch.int32)
        lat_sum = lat_sum + lat
        t = t + valid.to(torch.int32)
    return td, ld, dd, ts, ls, ds, counts, lat_sum, t


def single_level(addr, is_write, tags, lru, dirty, ways, allocates_reads,
                 write_invalidates, holds_dirty, write_through, t0, *,
                 t_cache: float):
    """One-level datapath block; returns ``(tags, lru, dirty, counts,
    latency, t_end)``."""
    flags = (allocates_reads, write_invalidates, holds_dirty, write_through)
    if addr.device.type == "cpu":
        return single_level_plain(addr, is_write, tags, lru, dirty, ways,
                                  *flags, t0, t_cache=t_cache)
    dev = addr.device
    v, n = addr.shape
    _, s, w = tags.shape
    kernels.check(addr, "addr", torch.int32, (v, n), dev)
    kernels.check(is_write, "is_write", torch.bool, (v, n), dev)
    kernels.check(tags, "tags", torch.int32, (v, s, w), dev)
    kernels.check(lru, "lru", torch.int32, (v, s, w), dev)
    kernels.check(dirty, "dirty", torch.bool, (v, s, w), dev)
    kernels.check(ways, "ways", torch.int32, (v,), dev)
    kernels.check(t0, "t0", torch.int32, (v,), dev)
    for name, f in zip(("allocates_reads", "write_invalidates",
                        "holds_dirty", "write_through"), flags):
        kernels.check(f, name, torch.bool, (v,), dev)
    out = [torch.empty_like(x) for x in (tags, lru, dirty)]
    counts = torch.empty((v, 8), dtype=torch.int32, device=dev)
    latency = torch.empty(v, dtype=torch.float32, device=dev)
    t_end = torch.empty(v, dtype=torch.int32, device=dev)
    if v:
        parts, scratch = _split(dev, v, n, s)
        ptrs = [x.data_ptr() for x in (addr, is_write, tags, lru, dirty,
                                       *out, ways, *flags, t0, counts,
                                       latency, t_end)]
        kernels.launch("single_level", *ptrs, *_pointers(scratch), v, n, s,
                       w, parts, t_cache, T_HDD, T_HDD_WRITE,
                       route="unclassified")
    return (*out, counts, latency, t_end)


def single_level_plain(addr, is_write, tags, lru, dirty, ways,
                       allocates_reads, write_invalidates, holds_dirty,
                       write_through, t0, *, t_cache: float):
    """The one-level datapath as a loop over requests, vectorised over
    VMs, with the policy as per-VM masks — the operations of one step of
    the JAX ``lax.scan`` with traced :class:`PolicyFlags`."""
    dev = addr.device
    v, n = addr.shape
    num_sets = tags.shape[1]
    tg, lr, dt = [x.clone() for x in (tags, lru, dirty)]
    vi = torch.arange(v, device=dev)
    widx = torch.arange(tg.shape[2], dtype=torch.int32, device=dev)
    act = widx[None, :] < ways[:, None]
    can = ways > 0
    ar, inv, hd = allocates_reads, write_invalidates, holds_dirty
    wt = write_through.to(torch.int32)
    counts = torch.zeros((v, 8), dtype=torch.int32, device=dev)
    lat_sum = torch.zeros(v, dtype=torch.float32, device=dev)
    t = t0.clone()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    t_c, t_hdd, t_hddw, zero = (f32(t_cache), f32(T_HDD), f32(T_HDD_WRITE),
                                f32(0.0))
    valid_cols = (addr >= 0).any(dim=0).nonzero()
    n_eff = int(valid_cols.max()) + 1 if valid_cols.numel() else 0
    for k in range(n_eff):
        a_raw = addr[:, k]
        valid = a_raw >= 0
        a = a_raw.clamp(min=0)
        rd = valid & ~is_write[:, k]
        wr = valid & is_write[:, k]
        s = a % num_sets
        rt, rl, rdy = tg[vi, s], lr[vi, s], dt[vi, s]
        hit, way = _lookup(rt, a, act)
        oh = widx[None, :] == way[:, None]
        ohv = widx[None, :] == _victim(rt, rl, act)[:, None]
        ev_dirty = ((rt >= 0) & rdy & ohv).any(dim=1)
        tt = t[:, None]
        alloc = ~inv & wr                   # an allocating write
        # a read hit or an allocating write hit is touched; a write hit
        # under write_invalidates is invalidated; a read miss under
        # allocates_reads or an allocating write miss is inserted
        touch = (rd | alloc) & hit
        inval = wr & inv & hit
        ins = ~hit & can & ((rd & ar) | alloc)
        set_dirty = (alloc & hd)[:, None]
        m = touch[:, None] & oh
        rl = torch.where(m, tt, rl)
        rdy = rdy | (m & set_dirty)
        m = inval[:, None] & oh
        rt, rl, rdy = rt.masked_fill(m, -1), rl.masked_fill(m, -1), rdy & ~m
        m = ins[:, None] & ohv
        rt = torch.where(m, a[:, None], rt)
        rl = torch.where(m, tt, rl)
        rdy = torch.where(m, set_dirty, rdy)
        tg[vi, s], lr[vi, s], dt[vi, s] = rt, rl, rdy

        committed = hit | can
        cw = (rd & ins) | (alloc & committed)
        dw = ((ins & ev_dirty) | (wr & inv)).to(torch.int32) + torch.where(
            alloc, wt + (~committed).to(torch.int32), 0)
        w_lat = torch.where(inv | ~committed | write_through, t_hddw, t_c)
        r_lat = torch.where(hit, t_c, t_hdd)
        lat = torch.where(rd, r_lat, torch.where(wr, w_lat, zero))
        step = torch.stack([rd, wr, torch.zeros_like(rd), rd & hit,
                            alloc & hit, cw, rd & ~hit], 1)
        counts[:, :7] += step.to(torch.int32)
        counts[:, 7] += dw
        lat_sum = lat_sum + lat
        t = t + valid.to(torch.int32)
    return tg, lr, dt, counts, lat_sum, t


# ---------------------------------------------------------------------------
# the classified routes (IO classification)
# ---------------------------------------------------------------------------

def _check_classes(cls, bypass, bounds, v: int, n: int, dev) -> int:
    """Validate the class operands of a classified launch; returns C."""
    c = bypass.shape[0] if bypass.dim() == 1 else -1
    kernels.check(bypass, "bypass", torch.bool, (c,), dev)
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{c} classes: a classified walk takes 1 to "
                         f"{MAX_CLASSES}")
    kernels.check(cls, "cls", torch.int32, (v, n), dev)
    for name, t in bounds:
        kernels.check(t, name, torch.int32, (v, c), dev)
    return c


def max_classified_sets(kernel: str, classes: int) -> int:
    """The most sets a level of a ``classified`` launch may have: its keys
    hold the set above the class id and its flags (``set << sh | class
    << F | flags``, ``csrc/set_walk.cuh`` ``class_shift``) in a
    non-negative int32."""
    sh = CLASS_FLAG_BITS[kernel] + max(classes - 1, 0).bit_length()
    return 1 << (31 - sh)


def _check_class_sets(kernel: str, c: int, *sets: int) -> None:
    top = max_classified_sets(kernel, c)
    if max(sets) > top:
        raise ValueError(f"{max(sets)} sets: a classified {kernel} walk "
                         f"with {c} classes takes at most {top}")


def _class_outputs(v: int, c: int, dev):
    return (torch.empty((v, 9), dtype=torch.int32, device=dev),
            torch.empty(v, dtype=torch.float32, device=dev),
            torch.empty(v, dtype=torch.int32, device=dev),
            torch.empty((v, c), dtype=torch.int32, device=dev),
            torch.empty((v, c), dtype=torch.int32, device=dev))


def two_level_classified(addr, is_write, cls, tags_d, lru_d, dirty_d,
                         tags_s, lru_s, dirty_s, ways_d, ways_s, t0, bypass,
                         lo_d, hi_d, lo_s, hi_s, *, npe: bool):
    """The two-level datapath with IO classes; returns the six states,
    ``counts [V, 9]``, ``latency``, ``t_end``, ``cls_hits`` and
    ``cls_miss`` ``[V, C]``."""
    if addr.device.type == "cpu":
        return two_level_classified_plain(
            addr, is_write, cls, tags_d, lru_d, dirty_d, tags_s, lru_s,
            dirty_s, ways_d, ways_s, t0, bypass, lo_d, hi_d, lo_s, hi_s,
            npe=npe)
    dev = addr.device
    v, n = addr.shape
    _, sd, wd = tags_d.shape
    _, ss, ws = tags_s.shape
    kernels.check(addr, "addr", torch.int32, (v, n), dev)
    kernels.check(is_write, "is_write", torch.bool, (v, n), dev)
    for name, t, s, w in (("tags_d", tags_d, sd, wd), ("lru_d", lru_d, sd, wd),
                          ("tags_s", tags_s, ss, ws), ("lru_s", lru_s, ss, ws)):
        kernels.check(t, name, torch.int32, (v, s, w), dev)
    kernels.check(dirty_d, "dirty_d", torch.bool, (v, sd, wd), dev)
    kernels.check(dirty_s, "dirty_s", torch.bool, (v, ss, ws), dev)
    for name, t in (("ways_d", ways_d), ("ways_s", ways_s), ("t0", t0)):
        kernels.check(t, name, torch.int32, (v,), dev)
    c = _check_classes(cls, bypass, (("lo_d", lo_d), ("hi_d", hi_d),
                                     ("lo_s", lo_s), ("hi_s", hi_s)),
                       v, n, dev)
    _check_class_sets("two_level", c, sd, ss)
    state = (tags_d, lru_d, dirty_d, tags_s, lru_s, dirty_s)
    out = [torch.empty_like(x) for x in state]
    res = _class_outputs(v, c, dev)
    if v:
        parts, scratch = (_split(dev, v, n, sd, 2 * c + 1) if sd == ss
                          else (1, ()))
        ptrs = [x.data_ptr() for x in (addr, is_write, cls, *state, *out,
                                       ways_d, ways_s, t0, bypass, lo_d,
                                       hi_d, lo_s, hi_s, *res)]
        kernels.launch("two_level", *ptrs, *_pointers(scratch), v, n, sd, wd,
                       ss, ws, c, int(npe), parts, T_DRAM, T_SSD, T_HDD,
                       T_HDD_WRITE, route="classified")
    return (*out, *res)


def _class_ranges(lo, hi, ways, vi, c, width: int, dev):
    """``(in range [V, W], range not empty [V])`` of each VM's request of
    class ``c``: ``[min(lo, hi'), hi')`` with ``hi' = min(hi, ways)``."""
    h = torch.minimum(hi[vi, c], ways)
    lo_ = torch.minimum(lo[vi, c], h)
    w = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    return (w >= lo_[:, None]) & (w < h[:, None]), h > lo_


def two_level_classified_plain(addr, is_write, cls, tags_d, lru_d, dirty_d,
                               tags_s, lru_s, dirty_s, ways_d, ways_s, t0,
                               bypass, lo_d, hi_d, lo_s, hi_s, *, npe: bool):
    """The classified two-level datapath as a loop over requests,
    vectorised over VMs: the operations of one step of the JAX
    ``lax.scan`` of ``_simulate_two_level_classified``."""
    dev = addr.device
    v, n = addr.shape
    nc = bypass.shape[0]
    sd, sw = tags_d.shape[1], tags_s.shape[1]
    td, ld, dd, ts, ls, ds = [x.clone() for x in (tags_d, lru_d, dirty_d,
                                                  tags_s, lru_s, dirty_s)]
    vi = torch.arange(v, device=dev)
    wd_i = torch.arange(td.shape[2], dtype=torch.int32, device=dev)
    ws_i = torch.arange(ts.shape[2], dtype=torch.int32, device=dev)
    act_d = wd_i[None, :] < ways_d[:, None]
    act_s = ws_i[None, :] < ways_s[:, None]
    counts = torch.zeros((v, 9), dtype=torch.int32, device=dev)
    hits = torch.zeros((v, nc), dtype=torch.int32, device=dev)
    miss = torch.zeros((v, nc), dtype=torch.int32, device=dev)
    lat_sum = torch.zeros(v, dtype=torch.float32, device=dev)
    t = t0.clone()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    t_dram, t_ssd, t_hdd, t_hddw = (f32(T_DRAM), f32(T_SSD), f32(T_HDD),
                                    f32(T_HDD_WRITE))
    zero = f32(0.0)
    valid_cols = (addr >= 0).any(dim=0).nonzero()
    n_eff = int(valid_cols.max()) + 1 if valid_cols.numel() else 0
    for k in range(n_eff):
        a_raw = addr[:, k]
        valid = a_raw >= 0
        a = a_raw.clamp(min=0)
        c = cls[:, k].clamp(0, nc - 1).long()
        byp = bypass[c]
        in_d, can_d = _class_ranges(lo_d, hi_d, ways_d, vi, c, td.shape[2],
                                    dev)
        in_s, can_s = _class_ranges(lo_s, hi_s, ways_s, vi, c, ts.shape[2],
                                    dev)
        w_k = is_write[:, k]
        rd = valid & ~w_k & ~byp
        wr = valid & w_k & ~byp
        b_rd = valid & ~w_k & byp
        b_wr = valid & w_k & byp
        s1, s2 = a % sd, a % sw
        rt_d, rl_d, rdy_d = td[vi, s1], ld[vi, s1], dd[vi, s1]
        rt_s, rl_s, rdy_s = ts[vi, s2], ls[vi, s2], ds[vi, s2]
        d_hit, d_way = _lookup(rt_d, a, act_d)
        s_hit, s_way = _lookup(rt_s, a, act_s)
        oh_d = wd_i[None, :] == d_way[:, None]
        oh_s = ws_i[None, :] == s_way[:, None]
        tt = t[:, None]

        # read: DRAM hit -> touch; SSD hit -> touch SSD; a DRAM miss
        # inserts into the class's DRAM range
        m = (rd & d_hit)[:, None] & oh_d
        rl_d = torch.where(m, tt, rl_d)
        m = (rd & s_hit & ~d_hit)[:, None] & oh_s
        rl_s = torch.where(m, tt, rl_s)
        vic = _victim(rt_d, rl_d, in_d)
        m = (rd & ~d_hit & can_d)[:, None] & (wd_i[None, :] == vic[:, None])
        rt_d = torch.where(m, a[:, None], rt_d)
        rl_d = torch.where(m, tt, rl_d)
        rdy_d = rdy_d & ~m

        # write (and a bypassed write): invalidate the DRAM copy; a
        # bypassed write also drops the SSD copy, unflushed
        m = ((wr | b_wr) & d_hit)[:, None] & oh_d
        rt_d = rt_d.masked_fill(m, -1)
        rl_d = rl_d.masked_fill(m, -1)
        rdy_d = rdy_d & ~m
        m = (b_wr & s_hit)[:, None] & oh_s
        rt_s = rt_s.masked_fill(m, -1)
        rl_s = rl_s.masked_fill(m, -1)
        rdy_s = rdy_s & ~m
        m = (wr & s_hit)[:, None] & oh_s
        rl_s = torch.where(m, tt, rl_s)
        rdy_s = rdy_s | m
        if npe:
            vic = _victim(rt_s, rl_s, in_s)
            ohv = ws_i[None, :] == vic[:, None]
            ev_dirty = ((rt_s >= 0) & rdy_s & ohv).any(dim=1)
            ins = wr & ~s_hit & can_s
            m = ins[:, None] & ohv
            rt_s = torch.where(m, a[:, None], rt_s)
            rl_s = torch.where(m, tt, rl_s)
            rdy_s = rdy_s | m
            committed = s_hit | can_s
            cw = wr & committed
            dw = wr & ((~s_hit & can_s & ev_dirty) | ~committed)
            w_lat = torch.where(committed, t_ssd, t_hddw)
        else:
            cw = wr & s_hit
            dw = wr & ~s_hit
            w_lat = torch.where(s_hit, t_ssd, t_hddw)
        r_lat = torch.where(d_hit, t_dram, torch.where(s_hit, t_ssd, t_hdd))
        lat = torch.where(rd, r_lat, torch.where(
            wr, w_lat, torch.where(b_rd, t_hdd, torch.where(b_wr, t_hddw,
                                                            zero))))

        td[vi, s1], ld[vi, s1], dd[vi, s1] = rt_d, rl_d, rdy_d
        ts[vi, s2], ls[vi, s2], ds[vi, s2] = rt_s, rl_s, rdy_s
        step = torch.stack([rd | b_rd, wr | b_wr, rd & d_hit,
                            rd & s_hit & ~d_hit, wr & s_hit, cw,
                            (rd & ~(d_hit | s_hit)) | b_rd, dw | b_wr,
                            b_rd | b_wr], 1)
        counts += step.to(torch.int32)
        served = torch.where(w_k, s_hit, d_hit | s_hit)
        elig = valid & ~byp
        hits[vi, c] += (elig & served).to(torch.int32)
        miss[vi, c] += (elig & ~served).to(torch.int32)
        lat_sum = lat_sum + lat
        t = t + valid.to(torch.int32)
    return td, ld, dd, ts, ls, ds, counts, lat_sum, t, hits, miss


def single_level_classified(addr, is_write, cls, tags, lru, dirty, ways,
                            allocates_reads, write_invalidates, holds_dirty,
                            write_through, t0, bypass, lo, hi, *,
                            t_cache: float):
    """The one-level datapath with IO classes (policy flags ``[V, C]``);
    returns ``(tags, lru, dirty, counts [V, 9], latency, t_end, cls_hits,
    cls_miss)``."""
    flags = (allocates_reads, write_invalidates, holds_dirty, write_through)
    if addr.device.type == "cpu":
        return single_level_classified_plain(
            addr, is_write, cls, tags, lru, dirty, ways, *flags, t0, bypass,
            lo, hi, t_cache=t_cache)
    dev = addr.device
    v, n = addr.shape
    _, s, w = tags.shape
    kernels.check(addr, "addr", torch.int32, (v, n), dev)
    kernels.check(is_write, "is_write", torch.bool, (v, n), dev)
    kernels.check(tags, "tags", torch.int32, (v, s, w), dev)
    kernels.check(lru, "lru", torch.int32, (v, s, w), dev)
    kernels.check(dirty, "dirty", torch.bool, (v, s, w), dev)
    kernels.check(ways, "ways", torch.int32, (v,), dev)
    kernels.check(t0, "t0", torch.int32, (v,), dev)
    c = _check_classes(cls, bypass, (("lo", lo), ("hi", hi)), v, n, dev)
    _check_class_sets("single_level", c, s)
    for name, f in zip(("allocates_reads", "write_invalidates",
                        "holds_dirty", "write_through"), flags):
        kernels.check(f, name, torch.bool, (v, c), dev)
    out = [torch.empty_like(x) for x in (tags, lru, dirty)]
    res = _class_outputs(v, c, dev)
    if v:
        parts, scratch = _split(dev, v, n, s, 2 * c + 1)
        ptrs = [x.data_ptr() for x in (addr, is_write, cls, tags, lru, dirty,
                                       *out, ways, *flags, bypass, lo, hi,
                                       t0, *res)]
        kernels.launch("single_level", *ptrs, *_pointers(scratch), v, n, s,
                       w, c, parts, t_cache, T_HDD, T_HDD_WRITE,
                       route="classified")
    return (*out, *res)


def single_level_classified_plain(addr, is_write, cls, tags, lru, dirty,
                                  ways, allocates_reads, write_invalidates,
                                  holds_dirty, write_through, t0, bypass, lo,
                                  hi, *, t_cache: float):
    """The classified one-level datapath as a loop over requests,
    vectorised over VMs, each request under its (VM, class) policy: the
    operations of one step of the JAX ``lax.scan`` of
    ``_simulate_single_level_classified``."""
    dev = addr.device
    v, n = addr.shape
    nc = bypass.shape[0]
    num_sets = tags.shape[1]
    tg, lr, dt = [x.clone() for x in (tags, lru, dirty)]
    vi = torch.arange(v, device=dev)
    widx = torch.arange(tg.shape[2], dtype=torch.int32, device=dev)
    act = widx[None, :] < ways[:, None]
    counts = torch.zeros((v, 9), dtype=torch.int32, device=dev)
    hits = torch.zeros((v, nc), dtype=torch.int32, device=dev)
    miss = torch.zeros((v, nc), dtype=torch.int32, device=dev)
    lat_sum = torch.zeros(v, dtype=torch.float32, device=dev)
    t = t0.clone()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    t_c, t_hdd, t_hddw, zero = (f32(t_cache), f32(T_HDD), f32(T_HDD_WRITE),
                                f32(0.0))
    valid_cols = (addr >= 0).any(dim=0).nonzero()
    n_eff = int(valid_cols.max()) + 1 if valid_cols.numel() else 0
    for k in range(n_eff):
        a_raw = addr[:, k]
        valid = a_raw >= 0
        a = a_raw.clamp(min=0)
        c = cls[:, k].clamp(0, nc - 1).long()
        byp = bypass[c]
        ar, inv, hd = (allocates_reads[vi, c], write_invalidates[vi, c],
                       holds_dirty[vi, c])
        wt_b = write_through[vi, c]
        wt = wt_b.to(torch.int32)
        in_r, can = _class_ranges(lo, hi, ways, vi, c, tg.shape[2], dev)
        w_k = is_write[:, k]
        rd = valid & ~w_k & ~byp
        wr = valid & w_k & ~byp
        b_rd = valid & ~w_k & byp
        b_wr = valid & w_k & byp
        s = a % num_sets
        rt, rl, rdy = tg[vi, s], lr[vi, s], dt[vi, s]
        hit, way = _lookup(rt, a, act)
        oh = widx[None, :] == way[:, None]
        ohv = widx[None, :] == _victim(rt, rl, in_r)[:, None]
        ev_dirty = ((rt >= 0) & rdy & ohv).any(dim=1)
        tt = t[:, None]
        alloc = ~inv & wr                   # an allocating write
        touch = (rd | alloc) & hit
        inval = ((wr & inv) | b_wr) & hit
        ins = ~hit & can & ((rd & ar) | alloc)
        set_dirty = (alloc & hd)[:, None]
        m = touch[:, None] & oh
        rl = torch.where(m, tt, rl)
        rdy = rdy | (m & set_dirty)
        m = inval[:, None] & oh
        rt, rl, rdy = rt.masked_fill(m, -1), rl.masked_fill(m, -1), rdy & ~m
        m = ins[:, None] & ohv
        rt = torch.where(m, a[:, None], rt)
        rl = torch.where(m, tt, rl)
        rdy = torch.where(m, set_dirty, rdy)
        tg[vi, s], lr[vi, s], dt[vi, s] = rt, rl, rdy

        committed = hit | can
        cw = (rd & ins) | (alloc & committed)
        dw = ((ins & ev_dirty) | (wr & inv) | b_wr).to(torch.int32) \
            + torch.where(alloc, wt + (~committed).to(torch.int32), 0)
        w_lat = torch.where(inv | ~committed | wt_b, t_hddw, t_c)
        r_lat = torch.where(hit, t_c, t_hdd)
        lat = torch.where(rd, r_lat, torch.where(
            wr, w_lat, torch.where(b_rd, t_hdd, torch.where(b_wr, t_hddw,
                                                            zero))))
        step = torch.stack([rd | b_rd, wr | b_wr, torch.zeros_like(rd),
                            rd & hit, alloc & hit, cw,
                            (rd & ~hit) | b_rd], 1)
        counts[:, :7] += step.to(torch.int32)
        counts[:, 7] += dw
        counts[:, 8] += (b_rd | b_wr).to(torch.int32)
        served = hit & ~(w_k & inv)
        elig = valid & ~byp
        hits[vi, c] += (elig & served).to(torch.int32)
        miss[vi, c] += (elig & ~served).to(torch.int32)
        lat_sum = lat_sum + lat
        t = t + valid.to(torch.int32)
    return tg, lr, dt, counts, lat_sum, t, hits, miss
