"""The datapath kernels' wrappers and their plain PyTorch versions.

``two_level`` (ETICA's DRAM + SSD) and ``single_level`` (the one-level
baselines) each run one ``[V, N]`` request block for all VMs: CUDA
tensors go through the kernel (``csrc/datapath.cu``,
``csrc/single_level.cu``), CPU tensors through :func:`two_level_plain` /
:func:`single_level_plain`. All are functional: the states come back as
new tensors (the kernels update copies in place).

Operands: ``addr`` int32 ``[V, N]`` (``-1`` = no-op), ``is_write`` bool
``[V, N]``; per level ``tags``/``lru`` int32 ``[V, S, W]`` and ``dirty``
bool ``[V, S, W]``; ways and ``t0`` int32 ``[V]``; ``single_level``'s
four policy flags bool ``[V]``. The outputs end in ``(counts, latency,
t_end)`` with ``counts`` int32 ``[V, 8]`` in :data:`COUNT_FIELDS` order
and ``latency`` float32 ``[V]``.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.policies import T_DRAM, T_HDD, T_HDD_WRITE, T_SSD

COUNT_FIELDS = ("reads", "writes", "read_hits_l1", "read_hits_l2",
                "write_hits_l2", "cache_writes_l2", "disk_reads",
                "disk_writes")
INT32_MAX = 2**31 - 1


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
    out = [x.clone() for x in (tags_d, lru_d, dirty_d, tags_s, lru_s,
                               dirty_s)]
    counts = torch.empty((v, 8), dtype=torch.int32, device=dev)
    latency = torch.empty(v, dtype=torch.float32, device=dev)
    t_end = torch.empty(v, dtype=torch.int32, device=dev)
    if v:
        ptrs = [x.data_ptr() for x in (addr, is_write, *out, ways_d, ways_s,
                                       t0, counts, latency, t_end)]
        kernels.launch("two_level", *ptrs, v, n, sd, wd, ss, ws, int(npe),
                       T_DRAM, T_SSD, T_HDD, T_HDD_WRITE)
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
    out = [x.clone() for x in (tags, lru, dirty)]
    counts = torch.empty((v, 8), dtype=torch.int32, device=dev)
    latency = torch.empty(v, dtype=torch.float32, device=dev)
    t_end = torch.empty(v, dtype=torch.int32, device=dev)
    if v:
        ptrs = [x.data_ptr() for x in (addr, is_write, *out, ways, *flags,
                                       t0, counts, latency, t_end)]
        kernels.launch("single_level", *ptrs, v, n, s, w, t_cache, T_HDD,
                       T_HDD_WRITE)
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
