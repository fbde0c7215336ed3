"""Sequential numpy oracles for the maintenance kernels.

The port's copy of :mod:`repro.kernels.maintenance.ref`: the semantics
of :func:`repro_torch.core.simulator.evict_blocks_ref` /
``promote_blocks_ref`` / ``clean_blocks_ref``, lifted to stacked
``[V, S, W]`` numpy states with one (possibly empty, possibly
``-1``-padded) queue per VM — the contract the scatter kernels and their
plain versions are held to bit for bit.
"""
from __future__ import annotations

import numpy as np


def evict_ref(tags, lru, dirty, queues):
    """Per-VM eviction over stacked states.

    ``tags``/``lru``/``dirty`` are ``[V, S, W]`` numpy arrays; ``queues``
    is one 1-D address array per VM (``-1`` entries ignored). Returns
    ``(tags, lru, dirty, flushed[V])`` copies.
    """
    tags = np.asarray(tags).copy()
    lru = np.asarray(lru).copy()
    dirty = np.asarray(dirty).copy()
    flushed = np.zeros(tags.shape[0], np.int32)
    for v, q in enumerate(queues):
        q = np.asarray(q).reshape(-1)
        q = q[q >= 0]
        mask = np.isin(tags[v], q) & (tags[v] >= 0)
        flushed[v] = int((dirty[v].astype(bool) & mask).sum())
        tags[v][mask] = -1
        lru[v][mask] = -1
        dirty[v][mask] = 0
    return tags, lru, dirty, flushed


def clean_ref(tags, lru, dirty, ways, quota):
    """Per-VM background cleaning over stacked states (third stage).

    Flush candidates are the dirty blocks in active ways; age order is
    (``lru`` ascending, flat ``set * W + way`` index ascending) — a total
    order because flat indices are unique. The first ``quota[v]``
    candidates flush: the dirty bit clears, tags/lru stay untouched (a
    flushed block remains resident and clean). Returns ``(tags, lru,
    dirty, flushed[V])`` copies.
    """
    tags = np.asarray(tags).copy()
    lru = np.asarray(lru).copy()
    dirty = np.asarray(dirty).copy()
    ways = np.asarray(ways).reshape(-1)
    quota = np.asarray(quota).reshape(-1)
    num_vms, num_sets, num_ways = tags.shape
    flushed = np.zeros(num_vms, np.int32)
    for v in range(num_vms):
        wa = min(max(int(ways[v]), 0), num_ways)
        cand = [(int(lru[v, s, w]), s * num_ways + w, s, w)
                for s in range(num_sets) for w in range(wa)
                if dirty[v, s, w]]
        cand.sort()
        for _, _, s, w in cand[: max(int(quota[v]), 0)]:
            dirty[v, s, w] = 0
            flushed[v] += 1
    return tags, lru, dirty, flushed


def promote_ref(tags, lru, dirty, queues, ways, t):
    """Per-VM promotion over stacked states (sequential queue drain).

    First occurrence of an address wins; addresses already resident in
    an active way are skipped; each promotion fills the lowest free
    active way of the block's set; a full set starves later entries.
    Returns ``(tags, lru, dirty, promoted[V])`` copies.
    """
    tags = np.asarray(tags).copy()
    lru = np.asarray(lru).copy()
    dirty = np.asarray(dirty).copy()
    ways = np.asarray(ways).reshape(-1)
    t = np.asarray(t).reshape(-1)
    num_sets = tags.shape[1]
    promoted = np.zeros(tags.shape[0], np.int32)
    for v, q in enumerate(queues):
        wa = int(ways[v])
        for a in np.asarray(q).reshape(-1):
            if a < 0 or wa <= 0:
                continue
            s = int(a) % num_sets
            if (tags[v, s, :wa] == a).any():
                continue
            free = np.nonzero(tags[v, s, :wa] < 0)[0]
            if free.size == 0:
                continue
            w = free[0]
            tags[v, s, w] = a
            lru[v, s, w] = int(t[v])
            dirty[v, s, w] = 0
            promoted[v] += 1
    return tags, lru, dirty, promoted
