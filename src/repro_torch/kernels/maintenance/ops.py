"""Maintenance scatters and the fused per-interval maintenance.

``evict_scatter`` / ``promote_scatter`` / ``clean_scatter`` run the CUDA
kernels (``csrc/evict_scatter.cu``, ``csrc/promote_scatter.cu``,
``csrc/clean_scatter.cu``) on CUDA tensors and the plain versions beside
them on CPU tensors. States are stacked ``[V, S, W]`` (``tags``/``lru``
int32, ``dirty`` bool); queues are ``[V, Q]`` int32 with ``-1`` padding.
All are functional: ``evict_scatter``'s and ``promote_scatter``'s
kernels write fresh outputs themselves, ``clean_scatter``'s updates
copies.

:func:`maintenance_interval` is one interval of ETICA maintenance for
all VMs (the JAX ``maintenance_interval``): Eq. 1 contributions ->
popularity-table merge -> eviction queue -> evict -> free space of the
post-eviction state -> promotion queue -> promote -> (``clean_quota >
0``) the background cleaner. It never synchronises with the host; only
the count vectors it returns need to reach the host.

:func:`serving_maintenance` is the two-tier KV serving workload's
interval (the JAX ``serving_maintenance``): tenants play the VMs and
sessions the blocks. It is plain PyTorch on the device around the
popularity table's ``run_sums`` kernel, and it too never synchronises
with the host.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import popularity as pop
from repro_torch.core.simulator import CacheState


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _check_state(tags, lru, dirty, queue, dev):
    v, s, w = tags.shape
    kernels.check(tags, "tags", torch.int32, (v, s, w), dev)
    kernels.check(lru, "lru", torch.int32, (v, s, w), dev)
    kernels.check(dirty, "dirty", torch.bool, (v, s, w), dev)
    kernels.check(queue, "queue", torch.int32, (v, queue.shape[1]), dev)


# ---------------------------------------------------------------------------
# evict
# ---------------------------------------------------------------------------

EVICT_MAX_PARTS = 8      # CTAs a VM: one portable cluster
EVICT_THREADS = 256      # threads a CTA (csrc/evict_scatter.cu kThreads)
EVICT_FEW_THREADS = 128  # threads a CTA once the VMs alone fill the card
EVICT_PART_SLOTS = 512   # slots a CTA, at least, where a VM is split


def evict_plan(v: int, sw: int, sms: int) -> tuple[int, int]:
    """``(parts, threads)`` of an ``evict_scatter`` launch, from shapes
    alone: while the VMs leave SMs idle, a VM's ``sw`` slots are split
    into up to ``EVICT_MAX_PARTS`` contiguous ranges of at least
    ``EVICT_PART_SLOTS`` slots, one cluster a VM, ``EVICT_THREADS``
    threads a CTA; when the VMs' CTAs outnumber the SMs, CTAs of
    ``EVICT_FEW_THREADS``, so that more of them share an SM."""
    parts = max(1, min(EVICT_MAX_PARTS, sms // max(v, 1),
                       -(-sw // EVICT_PART_SLOTS)))
    return parts, EVICT_THREADS if v * parts <= sms else EVICT_FEW_THREADS


def evict_scatter(tags, lru, dirty, queue):
    """Clear every slot whose tag (>= 0) is in the VM's queue; returns
    ``(tags, lru, dirty, flushed[V])`` — flushed counts dirty slots
    cleared. New tensors: on the card one launch reads the input state
    and the queue (of any width, 0 included) and writes all four."""
    if tags.device.type == "cpu":
        return evict_scatter_plain(tags, lru, dirty, queue)
    dev = tags.device
    _check_state(tags, lru, dirty, queue, dev)
    v, s, w = tags.shape
    state = (tags, lru, dirty)
    out = [torch.empty_like(x) for x in state]
    if not (v and s * w):
        return (*out, torch.zeros(v, dtype=torch.int32, device=dev))
    flushed = torch.empty(v, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptrs = [x.data_ptr() for x in (*state, *out, queue, flushed)]
    kernels.launch("evict_scatter", *ptrs, v, s * w, queue.shape[1],
                   *evict_plan(v, s * w, sms))
    return (*out, flushed)


def evict_scatter_plain(tags, lru, dirty, queue):
    """Membership by binary search in each VM's sorted queue."""
    v, s, w = tags.shape
    flat = tags.reshape(v, s * w)
    if queue.shape[1] == 0:
        match = torch.zeros_like(flat, dtype=torch.bool)
    else:
        qs = torch.sort(queue, dim=1).values
        pos = torch.searchsorted(qs, flat).clamp(max=queue.shape[1] - 1)
        match = (qs.gather(1, pos) == flat) & (flat >= 0)
    match = match.reshape(v, s, w)
    flushed = (match & dirty).sum(dim=(1, 2), dtype=torch.int32)
    return (tags.masked_fill(match, -1), lru.masked_fill(match, -1),
            dirty & ~match, flushed)


# ---------------------------------------------------------------------------
# promote
# ---------------------------------------------------------------------------

PROMOTE_MAX_WAYS = 128   # csrc/promote_scatter.cu kMaxWays
PROMOTE_MAX_PARTS = 8    # CTAs a VM: one portable cluster
PROMOTE_WARPS = 16       # warps a CTA (kWarps), one a set of a part
PROMOTE_FEW_WARPS = 4    # warps a CTA once the VMs alone fill the card


def promote_plan(v: int, s: int, sms: int) -> tuple[int, int]:
    """``(parts, warps)`` of a ``promote_scatter`` launch, from shapes
    alone: while the VMs leave SMs idle, a VM's sets are split into up to
    ``PROMOTE_MAX_PARTS`` contiguous ranges of at least ``PROMOTE_WARPS``
    sets, one cluster a VM, ``PROMOTE_WARPS`` warps a CTA; when the VMs'
    CTAs outnumber the SMs, CTAs of ``PROMOTE_FEW_WARPS`` warps, so that
    several share an SM's registers."""
    parts = max(1, min(PROMOTE_MAX_PARTS, sms // max(v, 1),
                       -(-s // PROMOTE_WARPS)))
    return parts, PROMOTE_WARPS if v * parts <= sms else PROMOTE_FEW_WARPS


def promote_scatter(tags, lru, dirty, queue, ways, t, dedupe: bool = True):
    """Drain promotion queues into free active ways: per set, the k-th
    eligible entry (valid, not resident in an active way, ``ways > 0``;
    with ``dedupe``, also the first entry of its address in the VM's
    queue) in queue order takes the set's k-th free active way, with
    ``lru = t[v]`` and clean. ``dedupe=False`` is for queues the caller
    knows to be unique. Returns ``(tags, lru, dirty, promoted[V])``, new
    tensors: on the card one launch reads the input state and writes all
    four (``W`` at most ``PROMOTE_MAX_WAYS``)."""
    if tags.device.type == "cpu":
        return promote_scatter_plain(tags, lru, dirty, queue, ways, t, dedupe)
    dev = tags.device
    _check_state(tags, lru, dirty, queue, dev)
    v, s, w = tags.shape
    kernels.check(ways, "ways", torch.int32, (v,), dev)
    kernels.check(t, "t", torch.int32, (v,), dev)
    if w > PROMOTE_MAX_WAYS:
        raise ValueError(f"promote_scatter: {w} ways > {PROMOTE_MAX_WAYS}")
    state = (tags, lru, dirty)
    out = [torch.empty_like(x) for x in state]
    if not (v and s and w):
        return (*out, torch.zeros(v, dtype=torch.int32, device=dev))
    promoted = torch.empty(v, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptrs = [x.data_ptr() for x in (*state, *out, queue, ways, t, promoted)]
    kernels.launch("promote_scatter", *ptrs, v, s, w, queue.shape[1],
                   *promote_plan(v, s, sms), int(dedupe))
    return (*out, promoted)


def _first_occurrence(queue):
    """``[V, Q]`` mask of each row's first entry of every value: a stable
    sort groups equal entries in queue order, and each group's head is
    its first occurrence."""
    order = torch.sort(queue, dim=1, stable=True).indices
    sq = queue.gather(1, order)
    head = torch.ones_like(sq, dtype=torch.bool)
    head[:, 1:] = sq[:, 1:] != sq[:, :-1]
    return torch.zeros_like(head).scatter_(1, order, head)


def promote_scatter_plain(tags, lru, dirty, queue, ways, t,
                          dedupe: bool = True):
    """The same contract with per-set ranks from cumulative sums."""
    v, s, w = tags.shape
    dev = tags.device
    q = queue.shape[1]
    valid = queue >= 0
    if dedupe:
        valid = valid & _first_occurrence(queue)
    qa = torch.where(valid, queue, 0)
    qset = (qa % s).long()                                   # [V, Q]
    widx = torch.arange(w, dtype=torch.int32, device=dev)
    active = widx[None, :] < ways[:, None]                   # [V, W]
    rows = tags.gather(1, qset[:, :, None].expand(v, q, w))  # [V, Q, W]
    present = ((rows == qa[:, :, None]) & active[:, None, :]).any(dim=2)
    elig = valid & ~present & (ways > 0)[:, None]
    sidx = torch.arange(s, device=dev)
    eligm = ((qset[:, None, :] == sidx[None, :, None])
             & elig[:, None, :]).long()                      # [V, S, Q]
    rank = (eligm.cumsum(dim=2) - eligm).gather(1, qset[:, None, :])[:, 0]
    free = active[:, None, :] & (tags < 0)                   # [V, S, W]
    nfree = free.sum(dim=2).gather(1, qset)                  # [V, Q]
    prom = elig & (rank < nfree)
    free_ways = torch.sort((~free).to(torch.int8), dim=2,
                           stable=True).indices              # free first
    way = free_ways.reshape(v, s * w).gather(
        1, qset * w + rank.clamp(max=w - 1))
    dest = torch.where(prom, qset * w + way, s * w)

    def put(x, val):
        out = torch.cat([x.reshape(v, s * w), x.reshape(v, s * w)[:, :1]], 1)
        out.scatter_(1, dest, val.to(x.dtype).expand(v, q))
        return out[:, :s * w].reshape(v, s, w).contiguous()

    return (put(tags, qa), put(lru, t[:, None]),
            put(dirty, torch.zeros(1, 1, dtype=torch.bool, device=dev)),
            prom.sum(dim=1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# clean (the background cleaner)
# ---------------------------------------------------------------------------

INT32_MIN = -2**31


def clean_scatter(dirty, lru, ways, lru_cut, idx_cut):
    """Clear the dirty bit of every dirty active slot whose age key
    ``(lru, set * W + way)`` is at or below the VM's cutoff ``(lru_cut,
    idx_cut)`` (``(INT32_MIN, -1)`` flushes nothing). ``dirty`` bool and
    ``lru`` int32 are ``[V, S, W]``; the rest ``[V]`` int32. Returns
    ``(dirty, flushed[V])``."""
    if dirty.device.type == "cpu":
        return clean_scatter_plain(dirty, lru, ways, lru_cut, idx_cut)
    dev = dirty.device
    v, s, w = dirty.shape
    kernels.check(dirty, "dirty", torch.bool, (v, s, w), dev)
    kernels.check(lru, "lru", torch.int32, (v, s, w), dev)
    for name, x in (("ways", ways), ("lru_cut", lru_cut),
                    ("idx_cut", idx_cut)):
        kernels.check(x, name, torch.int32, (v,), dev)
    dirty = dirty.clone()
    flushed = torch.zeros(v, dtype=torch.int32, device=dev)
    if v and s * w:
        ptrs = [x.data_ptr() for x in (dirty, lru, ways, lru_cut, idx_cut,
                                       flushed)]
        kernels.launch("clean_scatter", *ptrs, v, s, w)
    return dirty, flushed


def clean_scatter_plain(dirty, lru, ways, lru_cut, idx_cut):
    """The same flush mask, elementwise."""
    v, s, w = dirty.shape
    widx = torch.arange(w, dtype=torch.int32, device=dirty.device)
    sidx = torch.arange(s, dtype=torch.int32, device=dirty.device)
    flat = sidx[:, None] * w + widx[None, :]                 # [S, W]
    cand = dirty & (widx[None, None, :] < ways[:, None, None])
    lc = lru_cut[:, None, None]
    flush = cand & ((lru < lc) | ((lru == lc)
                                  & (flat <= idx_cut[:, None, None])))
    return dirty & ~flush, flush.sum(dim=(1, 2), dtype=torch.int32)


def _clean_cutoffs(dirty, lru, ways, quota):
    """Per-VM age cutoffs for the background cleaner.

    Candidates are the dirty blocks in active ways, aged by the unique
    key (lru ascending, flat ``set * W + way`` ascending). Returns
    ``(lru_cut[V], idx_cut[V], take[V], n_cand[V])``: the key of the
    ``take``-th oldest candidate (``take = min(quota, n_cand)``), or
    ``(INT32_MIN, -1)`` when nothing flushes. Two stable sorts, by lru
    and then by not-candidate, put the candidates first in key order
    (the reference's int32-safe lexsort)."""
    v, s, w = dirty.shape
    widx = torch.arange(w, dtype=torch.int32, device=dirty.device)
    active = widx[None, None, :] < ways[:, None, None]
    cflat = (dirty & active).reshape(v, s * w)
    lflat = lru.reshape(v, s * w)
    ord1 = torch.sort(lflat, dim=1, stable=True).indices
    c1 = cflat.gather(1, ord1)
    ord2 = torch.sort((~c1).to(torch.uint8), dim=1, stable=True).indices
    order = ord1.gather(1, ord2)
    n_cand = cflat.sum(dim=1, dtype=torch.int32)
    take = torch.minimum(quota, n_cand)
    kth = (take - 1).clamp(min=0).long()
    idx_k = order.gather(1, kth[:, None])[:, 0]
    lru_k = lflat.gather(1, idx_k[:, None])[:, 0]
    has = take > 0
    return (torch.where(has, lru_k, INT32_MIN),
            torch.where(has, idx_k.to(torch.int32), -1), take, n_cand)


def clean(state: CacheState, ways, quota):
    """Flush up to ``quota[v]`` of VM v's oldest dirty active blocks
    (they stay resident and clean). ``ways``/``quota`` are ``[V]`` int32
    tensors on the state's device. Returns ``(state, flushed[V],
    dirty_left[V])``."""
    lcut, icut, take, n_cand = _clean_cutoffs(state.dirty, state.lru, ways,
                                              quota)
    dirty, flushed = clean_scatter(state.dirty, state.lru, ways, lcut, icut)
    return (CacheState(state.tags, state.lru, dirty), flushed,
            n_cand - take)


def evict(state: CacheState, queue):
    tags, lru, dirty, flushed = evict_scatter(*state, queue)
    return CacheState(tags, lru, dirty), flushed


def promote(state: CacheState, queue, ways, t, assume_unique: bool = False):
    """``assume_unique=True`` skips the first-occurrence dedupe, for
    queues unique by construction (the popularity table's)."""
    tags, lru, dirty, n = promote_scatter(*state, queue, ways, t,
                                          dedupe=not assume_unique)
    return CacheState(tags, lru, dirty), n


# ---------------------------------------------------------------------------
# the fused per-interval maintenance
# ---------------------------------------------------------------------------

def maintenance_interval(ssd: CacheState, table: pop.PopularityTable,
                         dist, served, waddr, wlen, ways, t, *,
                         evict_frac: float, decay: float,
                         clean_quota: int = 0):
    """One interval of ETICA maintenance for all VMs.

    ``dist``/``served``/``waddr`` are the ``[V, N]`` TRD channels and
    addresses of the VMs' windows (tails past ``wlen[v]`` are padding;
    ``wlen == 0`` leaves a VM untouched); ``wlen``/``ways``/``t`` are
    ``[V]`` int32 tensors on the state's device. Returns ``(ssd, table,
    flushed, promoted, evict_qlen, promo_qlen, pop_drops, cleaned,
    dirty_left)``, each count ``[V]`` int32. With ``clean_quota > 0`` the
    third stage flushes up to ``clean_quota`` oldest dirty active blocks
    of each live VM (``cleaned``) and ``dirty_left`` is the dirty
    candidates it left; otherwise ``cleaned`` is zero and ``dirty_left``
    counts the dirty blocks in active ways.
    """
    v, s, w = ssd.tags.shape
    live = wlen > 0
    alloc = ways * s

    # 1) Eq. 1 popularity refresh into the [V, K] table
    contrib = pop.contributions(dist, served, alloc.clamp(min=1)[:, None])
    table, drops = pop.table_update(table, waddr, contrib, wlen, live, decay)

    # 2) eviction queue (bottom-frac of residents when >= 90% full)
    equeue, eqlen = pop.table_least_popular(table, ssd.tags, ways, alloc,
                                            live, evict_frac)
    equeue = pop.truncate_queue(equeue, _next_pow2(s * w))
    ssd, flushed = evict(ssd, equeue)

    # 3) free space of the post-eviction state -> promotion queue
    widx = torch.arange(w, dtype=torch.int32, device=ssd.tags.device)
    active = widx[None, None, :] < ways[:, None, None]
    n_res = ((ssd.tags >= 0) & active).sum(dim=(1, 2), dtype=torch.int32)
    free = (alloc - n_res).clamp(min=0)
    pqueue, pqlen = pop.table_top_known(
        table, ssd.tags, ways, free, live,
        width=_next_pow2(min(table.capacity, s * w)))
    ssd, promoted = promote(ssd, pqueue, ways, t, assume_unique=True)

    # 4) the background cleaner over the post-promotion state
    if clean_quota > 0:
        quota = live.to(torch.int32) * clean_quota
        ssd, cleaned, dirty_left = clean(ssd, ways, quota)
    else:
        cleaned = torch.zeros_like(flushed)
        dirty_left = (ssd.dirty & active).sum(dim=(1, 2), dtype=torch.int32)
    return (ssd, table, flushed, promoted, eqlen, pqlen, drops, cleaned,
            dirty_left)


# ---------------------------------------------------------------------------
# the fused interval of the two-tier KV serving workload
# ---------------------------------------------------------------------------

INT32_MAX = 2**31 - 1


def _pad_cols(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Pad the last axis of ``x`` to ``width`` with ``fill``."""
    k = width - x.shape[-1]
    if k <= 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (k,), fill)], dim=-1)


def _serving_impl(table: pop.PopularityTable, dist, served, waddr, wtenant,
                  cand_sid, cand_pages, over, cache_size, dirty_age, *,
                  decay: float, clean_quota: int):
    t_axis, n = table.addr.shape[0], waddr.shape[0]
    dev = waddr.device

    # 1) Eq. 1 contributions over the mixed window
    contrib = pop.contributions(dist, served, cache_size)

    # 2) stable demux into [T, N] per-tenant rows in arrival order; pad
    #    entries (tenant -1) go to a spare row T that is cut off
    tn = torch.where(wtenant >= 0, wtenant, t_axis).to(torch.int32)
    order = torch.sort(tn, stable=True).indices
    tn_sorted = tn[order]
    starts = torch.searchsorted(
        tn_sorted, torch.arange(t_axis + 1, dtype=torch.int32, device=dev))
    rows = tn_sorted.long()
    dest = rows * n + torch.arange(n, device=dev) - starts[rows]
    rows_addr = torch.zeros((t_axis + 1) * n, dtype=torch.int32,
                            device=dev).scatter_(0, dest, waddr[order])
    rows_contrib = torch.zeros((t_axis + 1) * n, dtype=torch.float32,
                               device=dev).scatter_(0, dest, contrib[order])
    rows_addr = rows_addr.view(t_axis + 1, n)
    rows_contrib = rows_contrib.view(t_axis + 1, n)
    n_valid = starts[1:] - starts[:-1]
    live = n_valid > 0

    # 3) [T, K] popularity merge
    table, drops = pop.table_update(table, rows_addr[:t_axis],
                                    rows_contrib[:t_axis], n_valid, live,
                                    decay)

    # 4) cold-first eviction ranking against the updated table; running
    #    page totals turn the over-quota count into per-session takes
    valid = cand_sid >= 0
    scores = pop.table_scores(table, torch.where(valid, cand_sid, 0))
    key = torch.where(valid, scores, float("inf"))
    eorder = torch.sort(key, dim=1, stable=True).indices
    pages_sorted = torch.where(valid, cand_pages, 0).gather(1, eorder)
    cum_before = pages_sorted.cumsum(dim=1) - pages_sorted
    take = torch.minimum((over[:, None] - cum_before).clamp(min=0),
                         pages_sorted)

    # 5) the cleaner: each tenant's oldest clean_quota dirty pages (ages
    #    are unique append sequence numbers, so the order is total)
    if clean_quota > 0:
        dvalid = dirty_age >= 0
        dorder = torch.sort(torch.where(dvalid, dirty_age, INT32_MAX),
                            dim=1, stable=True).indices
        ranks = torch.empty_like(dorder).scatter_(
            1, dorder, torch.arange(dorder.shape[1], device=dev)
            .expand_as(dorder).contiguous())
        dtake = dvalid.sum(dim=1, dtype=torch.int32).clamp(max=clean_quota)
        fpick = (dvalid & (ranks < dtake[:, None])).to(torch.int32)
    else:
        fpick = torch.zeros_like(dirty_age)
    return (table, drops, eorder.to(torch.int32), take.to(torch.int32),
            fpick)


def serving_maintenance(table: pop.PopularityTable, dist, served, waddr,
                        wtenant, cand_sid, cand_pages, over, cache_size, *,
                        decay: float, dirty_age=None, clean_quota: int = 0):
    """One fused serving-maintenance interval for all tenants.

    Every array operand is a tensor on the table's device: ``dist`` int32
    / ``served`` bool ``[N]`` are the mixed activation window's POD(RO)
    channels, ``waddr``/``wtenant`` int32 ``[N]`` its session ids and
    record-time tenants (``-1`` = padding), ``cand_sid``/``cand_pages``
    int32 ``[T, Smax]`` each tenant's resident sessions in page-table
    insertion order with their resident-page counts (``-1``/0 padding),
    ``over`` int32 ``[T]`` pages over quota, ``cache_size`` float32 ``[1]``
    the Eq. 1 normaliser, and ``dirty_age`` int32 ``[T, Dmax]`` the ages
    of each tenant's dirty pages (``-1`` = padding; needed when
    ``clean_quota > 0``).

    Returns ``(table, pop_drops[T], order[T, Sb], take[T, Sb], fpick[T,
    Dmax])``: ``order[t, i]`` indexes ``cand_sid[t]`` coldest first and
    ``take[t, i]`` is how many of that session's pages to release;
    ``fpick`` marks the cleaner's flushes. The window, candidates and
    dirty ages are padded to power-of-two widths as in the reference.
    """
    t_axis = table.addr.shape[0]
    n = waddr.shape[0]
    nb = _next_pow2(max(n, 64))
    sb = _next_pow2(max(cand_sid.shape[1], 8))
    if dirty_age is None:
        dirty_age = waddr.new_full((t_axis, 1), -1)
    dmax = dirty_age.shape[1]
    db = _next_pow2(max(dmax, 8))
    table, drops, eorder, take, fpick = _serving_impl(
        table, _pad_cols(dist, nb, -1), _pad_cols(served, nb, False),
        _pad_cols(waddr, nb, 0), _pad_cols(wtenant, nb, -1),
        _pad_cols(cand_sid, sb, -1), _pad_cols(cand_pages, sb, 0), over,
        cache_size, _pad_cols(dirty_age, db, -1), decay=float(decay),
        clean_quota=int(clean_quota))
    return table, drops, eorder, take, fpick[:, :dmax]
