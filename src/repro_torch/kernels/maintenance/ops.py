"""Maintenance scatters and the fused per-interval maintenance.

``evict_scatter`` / ``promote_scatter`` / ``clean_scatter`` run the CUDA
kernels (``csrc/evict_scatter.cu``, ``csrc/promote_scatter.cu``,
``csrc/clean_scatter.cu``) on CUDA tensors and the plain versions beside
them on CPU tensors. States are stacked ``[V, S, W]`` (``tags``/``lru``
int32, ``dirty`` bool); queues are ``[V, Q]`` int32 with ``-1`` padding.
All are functional: the kernels update copies.

:func:`maintenance_interval` is one interval of ETICA maintenance for
all VMs (the JAX ``maintenance_interval``): Eq. 1 contributions ->
popularity-table merge -> eviction queue -> evict -> free space of the
post-eviction state -> promotion queue -> promote -> (``clean_quota >
0``) the background cleaner. It never synchronises with the host; only
the count vectors it returns need to reach the host.
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

def evict_scatter(tags, lru, dirty, queue):
    """Clear every slot whose tag (>= 0) is in the VM's queue; returns
    ``(tags, lru, dirty, flushed[V])`` — flushed counts dirty slots
    cleared."""
    if tags.device.type == "cpu":
        return evict_scatter_plain(tags, lru, dirty, queue)
    dev = tags.device
    _check_state(tags, lru, dirty, queue, dev)
    v, s, w = tags.shape
    tags, lru, dirty = tags.clone(), lru.clone(), dirty.clone()
    flushed = torch.zeros(v, dtype=torch.int32, device=dev)
    if v and s * w and queue.shape[1]:
        ptrs = [x.data_ptr() for x in (tags, lru, dirty, queue, flushed)]
        kernels.launch("evict_scatter", *ptrs, v, s * w, queue.shape[1])
    return tags, lru, dirty, flushed


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

def promote_scatter(tags, lru, dirty, queue, ways, t):
    """Drain unique-address promotion queues into free active ways: per
    set, the k-th eligible entry (valid, not resident in an active way,
    ``ways > 0``) in queue order takes the set's k-th free active way,
    with ``lru = t[v]`` and clean. Returns ``(tags, lru, dirty,
    promoted[V])``."""
    if tags.device.type == "cpu":
        return promote_scatter_plain(tags, lru, dirty, queue, ways, t)
    dev = tags.device
    _check_state(tags, lru, dirty, queue, dev)
    v, s, w = tags.shape
    kernels.check(ways, "ways", torch.int32, (v,), dev)
    kernels.check(t, "t", torch.int32, (v,), dev)
    tags, lru, dirty = tags.clone(), lru.clone(), dirty.clone()
    promoted = torch.zeros(v, dtype=torch.int32, device=dev)
    if v and s and w and queue.shape[1]:
        ptrs = [x.data_ptr() for x in (tags, lru, dirty, queue, ways, t,
                                       promoted)]
        kernels.launch("promote_scatter", *ptrs, v, s, w, queue.shape[1])
    return tags, lru, dirty, promoted


def promote_scatter_plain(tags, lru, dirty, queue, ways, t):
    """The same contract with per-set ranks from cumulative sums."""
    v, s, w = tags.shape
    dev = tags.device
    q = queue.shape[1]
    valid = queue >= 0
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


def promote(state: CacheState, queue, ways, t):
    tags, lru, dirty, n = promote_scatter(*state, queue, ways, t)
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
    ssd, promoted = promote(ssd, pqueue, ways, t)

    # 4) the background cleaner over the post-promotion state
    if clean_quota > 0:
        quota = live.to(torch.int32) * clean_quota
        ssd, cleaned, dirty_left = clean(ssd, ways, quota)
    else:
        cleaned = torch.zeros_like(flushed)
        dirty_left = (ssd.dirty & active).sum(dim=(1, 2), dtype=torch.int32)
    return (ssd, table, flushed, promoted, eqlen, pqlen, drops, cleaned,
            dirty_left)
