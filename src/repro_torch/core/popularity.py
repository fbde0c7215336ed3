"""Popularity detection (paper §4.2.1, Eq. 1) on a device-resident table.

    popularity(B_i) = sum_t exp(-POD(i, t) / cacheSize)

The PyTorch counterpart of the ``[V, K]`` :class:`PopularityTable` path
of :mod:`repro.core.popularity`. The table is compared with the JAX
reference bit for bit, so every float32 step follows XLA:CPU:

  * ``exp`` is :func:`repro_torch._xla_math.exp_xla_f32` and every
    float32 result is flushed with :func:`~repro_torch._xla_math.ftz`;
  * a block's contributions in one window are added left to right
    (:func:`window_runs`: the ``run_sums`` CUDA kernel on the card, a
    stable sort and an in-order loop on the CPU) — never with atomics in
    no fixed order;
  * ties follow the reference: stable sorts, ``searchsorted`` on the
    left side, and ``lax.top_k``'s lower-index-first order reproduced
    by a stable descending sort of the reversed row;
  * JAX's ``.at[...].set(mode="drop")`` scatters are scatters into one
    spare column that is cut off afterwards.

No function here synchronises with the host, so the whole maintenance
interval stays on the device.

:class:`PopularityTracker` and :func:`block_scores` are the reference's
host-side numpy table with its queue methods, kept as it is: the
controller's sequential and staged maintenance modes (``batched=False``,
``fused_maintenance=False``) keep one tracker per VM, and the serving
manager's sequential oracle one per tenant, bit-identical to the device
table's rows. The staged mode gets each window's block scores from the
``popularity`` kernel (:mod:`repro_torch.kernels.popularity.ops`) and
:meth:`PopularityTracker.merge` s them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch._xla_math import exp_xla_f32, f32, ftz

# empty-slot sentinel; sorts after every real block address
TABLE_EMPTY = 2**31 - 1


def contributions(dist: torch.Tensor, served: torch.Tensor,
                  cache_size) -> torch.Tensor:
    """Eq. 1 per-access contribution; ``cache_size`` broadcasts against
    ``dist`` (e.g. ``[V, 1]`` per-VM sizes against ``[V, N]`` windows)."""
    cs = torch.as_tensor(cache_size, device=dist.device).float().clamp(
        min=1.0)
    d = dist.float()
    return torch.where(served & (dist >= 0), exp_xla_f32(ftz(-d / cs)),
                       0.0)


def block_scores(addr: np.ndarray, contrib: np.ndarray):
    """Per-block sums of per-access contributions (float32, access
    order — the device table's segment-sum order)."""
    addr = np.asarray(addr)
    uniq, inv = np.unique(addr, return_inverse=True)
    scores = np.zeros(uniq.shape[0], np.float32)
    np.add.at(scores, inv, np.asarray(contrib, np.float32))
    return uniq, scores


class PopularityTracker:
    """Running per-block popularity with exponential aging across windows:
    a sorted (address, score) numpy table, float32, accumulated in the
    device table's order (decay, per-window block sums, one add)."""

    def __init__(self, decay: float = 0.5):
        self.rate = np.float32(decay)
        self._addr = np.empty(0, np.int64)   # sorted block addresses
        self._val = np.empty(0, np.float32)  # scores, aligned with _addr

    def __len__(self) -> int:
        return int(self._addr.size)

    def update(self, addr: np.ndarray, contrib: np.ndarray) -> None:
        """One window: :meth:`decay`, the window's :func:`block_scores`,
        :meth:`merge`."""
        self.decay()
        self.merge(*block_scores(addr, contrib))

    def decay(self) -> None:
        self._val *= self.rate

    def merge(self, uniq: np.ndarray, scores: np.ndarray) -> None:
        """Add one window's per-block scores (``uniq`` ascending and
        unique): one add for a known block, a new entry otherwise."""
        uniq = np.asarray(uniq).astype(np.int64)
        scores = np.asarray(scores, np.float32)
        found = np.zeros(uniq.size, bool)
        if self._addr.size and uniq.size:
            pos = np.searchsorted(self._addr, uniq)
            in_range = pos < self._addr.size
            found[in_range] = self._addr[pos[in_range]] == uniq[in_range]
            self._val[pos[found]] += scores[found]
        if (~found).any():
            merged_a = np.concatenate([self._addr, uniq[~found]])
            merged_v = np.concatenate([self._val, scores[~found]])
            order = np.argsort(merged_a, kind="stable")
            self._addr, self._val = merged_a[order], merged_v[order]
        # drop negligible entries to bound memory (paper: 0.15% overhead)
        if self._addr.size > 1_000_000:
            thr = np.percentile(self._val, 10)
            keep = self._val > thr
            self._addr, self._val = self._addr[keep], self._val[keep]

    def scores_for(self, addrs: np.ndarray) -> np.ndarray:
        addrs = np.asarray(addrs, np.int64)
        out = np.zeros(addrs.shape, np.float32)
        if self._addr.size and addrs.size:
            pos = np.searchsorted(self._addr, addrs)
            in_range = pos < self._addr.size
            hit = in_range.copy()
            hit[in_range] = self._addr[pos[in_range]] == addrs[in_range]
            out[hit] = self._val[pos[hit]]
        return out

    def most_popular(self, candidates: np.ndarray, frac: float,
                     limit: int | None = None) -> np.ndarray:
        """Top-``frac`` of ``candidates`` by popularity, widened up to
        ``limit`` (the free space); only blocks with a positive score."""
        candidates = np.asarray(candidates)
        if candidates.size == 0:
            return candidates
        s = self.scores_for(candidates)
        k = max(int(np.ceil(np.float32(frac) * np.float32(candidates.size))),
                1)
        if limit is not None:
            k = min(max(k, limit), candidates.size)
        order = np.argsort(-s, kind="stable")
        top = order[:k]
        return candidates[top[s[top] > 0]]

    def top_known(self, exclude: np.ndarray, limit: int) -> np.ndarray:
        """Promotion queue: the highest-scored known blocks not in
        ``exclude``, score descending, address descending on ties, at most
        ``limit``."""
        if limit <= 0 or not self._addr.size:
            return np.empty(0, np.int64)
        cand = self._val > 0
        exclude = np.asarray(exclude)
        if exclude.size:
            cand &= ~np.isin(self._addr, exclude)
        addrs, vals = self._addr[cand], self._val[cand]
        order = np.lexsort((-addrs, -vals))
        return addrs[order[:limit]]

    def least_popular(self, candidates: np.ndarray, frac: float) -> np.ndarray:
        """Eviction queue: the bottom-``frac`` of ``candidates`` (at least
        one), lowest score first, ties in candidate order."""
        candidates = np.asarray(candidates)
        if candidates.size == 0:
            return candidates
        s = self.scores_for(candidates)
        k = max(int(np.ceil(np.float32(frac) * np.float32(candidates.size))),
                1)
        order = np.argsort(s, kind="stable")
        return candidates[order[:k]]


class PopularityTable(NamedTuple):
    """``addr`` int32 ``[V, K]`` sorted ascending per row with
    :data:`TABLE_EMPTY` in free slots; ``val`` float32 ``[V, K]``."""
    addr: torch.Tensor
    val: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.addr.shape[-1]


def table_init(num_vms: int, capacity: int, device="cuda") -> PopularityTable:
    return PopularityTable(
        addr=torch.full((num_vms, capacity), TABLE_EMPTY, dtype=torch.int32,
                        device=device),
        val=torch.zeros((num_vms, capacity), dtype=torch.float32,
                        device=device))


def _scatter_drop(base: torch.Tensor, dest: torch.Tensor, src: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """``base.at[dest].set(src, mode="drop")`` per row: entries with
    ``keep`` false or ``dest`` past the row go to a spare column."""
    k = base.shape[1]
    dest = torch.where(keep & (dest < k), dest, k)
    out = torch.cat([base, base[:, :1]], dim=1)
    out.scatter_(1, dest, src)
    return out[:, :k].contiguous()


def run_sums_plain(head, seg, vals) -> torch.Tensor:
    """In-order run sums of ``[V, N]`` sorted rows whose runs start where
    ``head`` is set (run ordinal ``seg``): out[v, r] is run r's
    left-to-right float32 sum, each partial sum's subnormals flushed, 0
    past the last run."""
    v, n = head.shape
    dev = head.device
    pos = torch.arange(n, device=dev).expand(v, n)
    hpos = torch.full((v, n + 1), n, dtype=torch.int64, device=dev)
    hpos.scatter_(1, torch.where(head, seg, n), pos)
    hpos = hpos[:, :n]                 # start of run r, n past the last run
    nxt = torch.cat([hpos[:, 1:], torch.full((v, 1), n, device=dev)], 1)
    length = torch.where(hpos < n, nxt.clamp(max=n) - hpos, 0)
    out = torch.zeros(v * n, dtype=torch.float32, device=dev)
    # the runs as flat lists (output slot, first value, length), each
    # added left to right; every time the unfinished runs have halved,
    # the finished ones are written out and dropped, so a long run costs
    # its own length in small steps, not in [V, N]-wide ones
    slot = torch.nonzero(length.reshape(-1) > 0).reshape(-1)
    first = (hpos.reshape(-1)[slot]
             + torch.div(slot, n, rounding_mode="floor") * n)
    left = length.reshape(-1)[slot]
    flat_vals = vals.reshape(-1)
    acc = torch.zeros(slot.numel(), dtype=torch.float32, device=dev)
    # unfinished runs after k steps: the runs longer than k
    ends = np.sort(left.cpu().numpy())
    k, live = 0, slot.numel()
    while slot.numel():
        more = k < left
        acc = torch.where(more, ftz(acc + flat_vals[(first + k).clamp(
            max=v * n - 1)]), acc)
        k += 1
        still = ends.size - int(np.searchsorted(ends, k, side="right"))
        if still * 2 <= live:
            done = left <= k
            out[slot[done]] = acc[done]
            keep = ~done
            slot, first, left, acc = (slot[keep], first[keep], left[keep],
                                      acc[keep])
            live = still
    return out.view(v, n)


def _compact_runs(a: torch.Tensor, c: torch.Tensor):
    """Sum runs of equal sorted keys into their run's slot (segment
    order); the tail is :data:`TABLE_EMPTY` with value 0. A subnormal
    value adds as zero, as XLA:CPU's scatter-add treats it."""
    head = torch.ones_like(a, dtype=torch.bool)
    head[:, 1:] = a[:, 1:] != a[:, :-1]
    seg = head.long().cumsum(dim=1) - 1
    caddr = torch.full_like(a, TABLE_EMPTY).scatter_(1, seg, a)
    cval = run_sums_plain(head, seg, ftz(c))
    return caddr, torch.where(caddr == TABLE_EMPTY, 0.0, cval)


def window_runs(waddr, contrib, n_valid):
    """One window's per-block sums, every row: ``(uaddr, uval)`` ``[V,
    N]``, each distinct address of row v's first ``n_valid[v]`` entries
    once, ascending, from slot 0, with its contributions added left to
    right in access order; the tail :data:`TABLE_EMPTY` with 0. The
    reference's stable argsort and ``_compact_runs``. ``waddr``/``contrib``
    ``[V, N]``, ``n_valid`` ``[V]``. A CUDA tensor takes the ``run_sums``
    kernel: rows up to :data:`repro_torch.kernels.ROW_MAX` wide by the
    ``row`` route (each row sorted in one CTA's shared memory), wider ones
    by the ``tiled`` route (:func:`repro_torch.kernels.row_route`); a CPU
    tensor :func:`window_runs_plain`."""
    if waddr.device.type == "cpu":
        return window_runs_plain(waddr, contrib, n_valid)
    dev = waddr.device
    v, n = waddr.shape
    wa = waddr.to(torch.int32).contiguous()
    wc = contrib.to(torch.float32).contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    kernels.check(wa, "waddr", torch.int32, (v, n), dev)
    kernels.check(wc, "contrib", torch.float32, (v, n), dev)
    kernels.check(nv, "n_valid", torch.int32, (v,), dev)
    uaddr = torch.empty((v, n), dtype=torch.int32, device=dev)
    uval = torch.empty((v, n), dtype=torch.float32, device=dev)
    if v and n:
        route = kernels.row_route(n)
        scratch = kernels.row_scratch(v, n, dev) if route == "tiled" else []
        ptrs = [x.data_ptr() for x in (wa, wc, nv, uaddr, uval, *scratch)]
        kernels.launch("run_sums", *ptrs, v, n, route=route)
    return uaddr, uval


def window_runs_plain(waddr, contrib, n_valid):
    """The plain version of :func:`window_runs`: padding masked to
    :data:`TABLE_EMPTY`, a stable sort of each row, then the in-order run
    sums of :func:`_compact_runs`."""
    n = waddr.shape[1]
    valid = (torch.arange(n, device=waddr.device)[None, :]
             < n_valid[:, None])
    wa = torch.where(valid, waddr.to(torch.int32), TABLE_EMPTY)
    wc = torch.where(valid, contrib.float(), 0.0)
    order = torch.sort(wa, dim=1, stable=True).indices
    return _compact_runs(wa.gather(1, order), wc.gather(1, order))


def table_update(table: PopularityTable, waddr, contrib, n_valid, live,
                 decay: float):
    """Merge one window of contributions into every live VM's row.

    ``waddr``/``contrib`` are ``[V, N]`` (entries at or past
    ``n_valid[v]`` are padding); rows with ``live`` false are untouched
    (no decay). Returns ``(table, drops[V])``: ``drops`` counts entries
    pushed past the row's ``K`` slots by the merge."""
    addr, val = table
    v, k = addr.shape
    n = waddr.shape[1]
    dev = addr.device
    uaddr, uval = window_runs(waddr, contrib, n_valid)
    val_d = ftz(val * f32(decay))

    # blocks already in the table: one add each, table + window score
    pos = torch.searchsorted(addr, uaddr)
    pos_c = pos.clamp(max=k - 1)
    found = (pos < k) & (addr.gather(1, pos_c) == uaddr)
    hit = found & (uaddr != TABLE_EMPTY)
    val_d = _scatter_drop(val_d, pos_c,
                          ftz(val_d.gather(1, pos_c) + uval), hit)

    # new blocks: merge by rank — every table slot shifts right by the
    # new addresses before it; each new address lands at its insertion
    # point plus its own rank
    newm = ~found & (uaddr != TABLE_EMPTY)
    rank_new = newm.long().cumsum(dim=1) - newm.long()
    new_sorted = _scatter_drop(torch.full_like(uaddr, TABLE_EMPTY),
                               rank_new, uaddr, newm)
    new_val = _scatter_drop(torch.zeros_like(uval), rank_new, uval, newm)
    kidx = torch.arange(k, device=dev)
    dest_table = kidx[None, :] + torch.searchsorted(new_sorted, addr)
    dest_new = (torch.searchsorted(addr, new_sorted)
                + torch.arange(n, device=dev)[None, :])
    keep_new = new_sorted != TABLE_EMPTY
    every = torch.ones_like(addr, dtype=torch.bool)
    out_addr = _scatter_drop(torch.full_like(addr, TABLE_EMPTY), dest_table,
                             addr, every)
    out_val = _scatter_drop(torch.zeros_like(val), dest_table, val_d, every)
    out_addr = _scatter_drop(out_addr, dest_new, new_sorted, keep_new)
    out_val = _scatter_drop(out_val, dest_new, new_val, keep_new)
    drops = (((addr != TABLE_EMPTY) & (dest_table >= k)).sum(
        dim=1, dtype=torch.int32)
        + (keep_new & (dest_new >= k)).sum(dim=1, dtype=torch.int32))
    lv = live[:, None]
    return (PopularityTable(torch.where(lv, out_addr, addr),
                            torch.where(lv, out_val, val)),
            torch.where(live, drops, 0))


def _scores(addr, val, queries):
    """Per-row table lookup: score of each query (0 when absent)."""
    k = addr.shape[1]
    pos = torch.searchsorted(addr, queries)
    pos_c = pos.clamp(max=k - 1)
    hit = (pos < k) & (addr.gather(1, pos_c) == queries)
    return torch.where(hit, val.gather(1, pos_c), 0.0)


def table_scores(table: PopularityTable, addrs) -> torch.Tensor:
    """``[V, M]`` scores of ``[V, M]`` int32 query addresses (0 when
    unknown)."""
    return _scores(table.addr, table.val, addrs)


def _resident(tags: torch.Tensor, ways: torch.Tensor):
    """Flattened ``[V, S*W]`` tags and the mask of blocks resident in
    each VM's first ``ways[v]`` ways."""
    v, s, w = tags.shape
    flat = tags.reshape(v, s * w)
    widx = torch.arange(w, dtype=torch.int32, device=tags.device)
    active = (widx[None, None, :] < ways[:, None, None]).expand(v, s, w)
    return flat, active.reshape(v, s * w) & (flat >= 0)


def table_least_popular(table: PopularityTable, tags, ways, alloc, live,
                        frac: float):
    """Eviction queues: per VM the bottom-``frac`` of its resident blocks
    (candidates in (set, way) order, stable ties), only when the
    partition is at least 90% full. Returns ``([V, S*W] queue, [V]
    length)``, ``-1``-padded."""
    flat, validc = _resident(tags, ways)
    n_res = validc.sum(dim=1, dtype=torch.int32)
    do = live & (n_res > 0) & (n_res * 10 >= alloc * 9)
    scores = _scores(table.addr, table.val, flat)
    order = torch.sort(torch.where(validc, scores, float("inf")), dim=1,
                       stable=True).indices
    k = torch.ceil(f32(frac) * n_res.float()).clamp(min=1.0).to(
        torch.int32)
    take = do[:, None] & (torch.arange(flat.shape[1], device=flat.device)
                          [None, :] < k[:, None])
    return (torch.where(take, flat.gather(1, order), -1),
            torch.where(do, k, 0))


def table_top_known(table: PopularityTable, tags, ways, limit, live,
                    width: int):
    """Promotion queues: per VM the known blocks with a positive score
    and no copy in its active ways, ordered by (score desc, address
    desc), at most ``limit[v]`` of them. Returns ``([V, width] queue,
    [V] length)``, ``-1``-padded."""
    addr, val = table
    k = addr.shape[1]
    flat, activef = _resident(tags, ways)
    res_sorted = torch.sort(torch.where(activef, flat, TABLE_EMPTY),
                            dim=1).values
    rpos = torch.searchsorted(res_sorted, addr).clamp(max=flat.shape[1] - 1)
    resident = res_sorted.gather(1, rpos) == addr
    cand = (val > 0) & (addr != TABLE_EMPTY) & ~resident
    # lax.top_k of the reversed row breaks ties toward the lower index,
    # i.e. the higher address: a stable descending sort does the same
    key = torch.where(cand, val, float("-inf")).flip(1)
    topv, topi = torch.sort(key, dim=1, descending=True, stable=True)
    m = min(width, k)
    topv, topi = topv[:, :m], topi[:, :m]
    qa = addr.flip(1).gather(1, topi)
    take = ((topv > float("-inf")) & live[:, None]
            & (torch.arange(m, device=addr.device)[None, :]
               < limit[:, None]))
    queue = torch.where(take, qa, -1)
    if width > k:
        queue = truncate_queue(queue, width)
    return queue, take.sum(dim=1, dtype=torch.int32)


def truncate_queue(queue: torch.Tensor, width: int) -> torch.Tensor:
    """Cut or ``-1``-pad a ``[V, Q]`` queue to ``width`` columns."""
    v, q = queue.shape
    if q >= width:
        return queue[:, :width].contiguous()
    return torch.cat([queue, queue.new_full((v, width - q), -1)], dim=1)
