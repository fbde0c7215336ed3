"""``popularity``: per-block Eq. 1 scores, the kernel's wrapper and its
plain version.

For accesses grouped into segments (blocks)::

    scores[b] = sum over i with seg[i] == b, in access order, of
                exp(-dist[i] / max(cs, 1)) * [served[i] and dist[i] >= 0]

the fused form of ``block_scores(addr, contributions(dist, served, cs))``
(:mod:`repro_torch.core.popularity`), bit for bit: the JAX package's
Pallas ``popularity`` sums each block in another order and agrees with
it within allclose. CUDA tensors go through the ``popularity`` kernel
(``csrc/popularity.cu``); CPU tensors through :func:`popularity_rows_plain`.

  * :func:`popularity` — the Pallas signature: one access stream, dense
    segment ids in ``[0, num_blocks)``, one cache size;
  * :func:`block_popularity` — one window's ``(unique addresses,
    scores)``, with the segment ids from a host ``np.unique`` as in the
    JAX wrapper;
  * :func:`block_popularity_batch` — every VM's ``(unique addresses,
    scores)`` of a ``[V, N]`` window with one cache size per VM, from one
    kernel launch (the staged maintenance mode's scoring);
  * :func:`popularity_ref` — the port's copy of the JAX ``popularity_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import popularity as pop

_NO_BLOCK = 1 << 62      # grouping key of padding; above every (VM, addr)


def popularity_rows(dist, served, seg, num_blocks: int, cs):
    """Scores of the segments of ``[V, N]`` rows: ``dist`` int32, ``served``
    bool, ``seg`` int32 segment ids (``num_blocks`` or more: no segment;
    a segment lies in one row), ``cs`` float32 ``[V]`` the rows' cache
    sizes. Returns float32 ``[num_blocks]``. On the card, rows of up to
    :data:`repro_torch.kernels.ROW_MAX` accesses take the ``row`` route
    (one CTA a row groups its accesses by segment in shared memory and
    sums them there, ``csrc/row_sort.cuh``), wider ones the ``tiled``
    route (tiles sorted, then merged in global memory,
    ``csrc/row_merge.cuh``); :func:`repro_torch.kernels.row_route`."""
    if dist.device.type == "cpu":
        return popularity_rows_plain(dist, served, seg, num_blocks, cs)
    dev = dist.device
    v, n = dist.shape
    kernels.check(dist, "dist", torch.int32, (v, n), dev)
    kernels.check(served, "served", torch.bool, (v, n), dev)
    kernels.check(seg, "seg", torch.int32, (v, n), dev)
    kernels.check(cs, "cs", torch.float32, (v,), dev)
    out = torch.zeros(num_blocks, dtype=torch.float32, device=dev)
    if num_blocks and v and n:
        route = kernels.row_route(n)
        scratch = kernels.row_scratch(v, n, dev)[:4] if route == "tiled" \
            else []
        ptrs = [x.data_ptr() for x in (dist, served, seg, cs, out, *scratch)]
        kernels.launch("popularity", *ptrs, num_blocks, v, n, route=route)
    return out


def popularity_rows_plain(dist, served, seg, num_blocks: int, cs):
    """The plain version: Eq. 1 contributions, then each segment summed
    left to right over its stably sorted positions."""
    contrib = pop.contributions(dist, served, cs[:, None]).reshape(-1)
    sseg, order = torch.sort(seg.reshape(-1), stable=True)
    n = sseg.numel()
    # each padding position is a run of its own, so the in-order loop
    # runs as long as the longest segment, not the padding
    head = torch.ones_like(sseg, dtype=torch.bool)
    head[1:] = (sseg[1:] != sseg[:-1]) | (sseg[1:] >= num_blocks)
    run = head.long().cumsum(0) - 1
    sums = pop.run_sums_plain(head[None], run[None], contrib[order][None])[0]
    # run r's segment id, num_blocks past the last run and for padding
    run_seg = torch.full((n + 1,), num_blocks, dtype=torch.int64,
                         device=dist.device)
    run_seg.scatter_(0, torch.where(head, run, n), sseg.long())
    run_seg = run_seg[:n].clamp(max=num_blocks)
    out = torch.zeros(num_blocks + 1, dtype=torch.float32, device=dist.device)
    return out.scatter_(0, run_seg, sums)[:num_blocks]


def popularity(dist, served, seg, num_blocks: int, cache_size):
    """Per-block scores of one access stream (the Pallas signature):
    ``dist``/``served``/``seg`` ``[N]``, ``seg[i]`` in ``[0, num_blocks)``,
    ``cache_size`` a number or a float32 tensor on the device."""
    cs = torch.as_tensor(cache_size, dtype=torch.float32,
                         device=dist.device).reshape(1)
    return popularity_rows(dist[None], served[None], seg[None], num_blocks,
                           cs)


def popularity_ref(dist, served, seg, num_blocks: int, cache_size):
    """The port's copy of the JAX ``popularity_ref``: the contributions
    scattered into the blocks with ``index_add_``."""
    contrib = pop.contributions(dist, served, cache_size)
    out = torch.zeros(num_blocks, dtype=torch.float32, device=dist.device)
    return out.index_add_(0, seg.long(), contrib)


def block_popularity(addr, dist, served, cache_size):
    """``(unique addresses, scores)`` of one maintenance window: a host
    ``np.unique`` maps addresses to dense segment ids, as the JAX
    ``block_popularity`` does; ``dist``/``served`` are tensors."""
    uniq, seg = np.unique(np.asarray(addr), return_inverse=True)
    seg = torch.from_numpy(seg.reshape(-1).astype(np.int32)).to(dist.device)
    scores = popularity(dist, served, seg, int(uniq.size), cache_size)
    return uniq, scores.cpu().numpy()


def block_popularity_batch(addr, dist, served, cs):
    """Every VM's ``(unique addresses, scores)`` of one ``[V, N]`` window
    in one launch. ``addr`` int32 with ``-1`` padding, ``dist`` int32,
    ``served`` bool, ``cs`` float32 ``[V]`` (each VM's cache size), all
    on one device. Segments are the (VM, address) pairs, grouped by a
    device ``torch.unique`` of ``VM * 2**31 + addr``. Returns a list over
    the VMs: ``None`` for a VM with no valid entry, else its addresses
    ascending (int64) and their float32 scores."""
    v, n = addr.shape
    vm = torch.arange(v, dtype=torch.int64, device=addr.device)[:, None]
    key = torch.where(addr >= 0, (vm << 31) + addr.long(), _NO_BLOCK)
    uniq, inv = torch.unique(key.reshape(-1), sorted=True,
                             return_inverse=True)
    keys = uniq.cpu().numpy()
    nb = int(np.searchsorted(keys, _NO_BLOCK))
    scores = popularity_rows(dist, served,
                             inv.reshape(v, n).to(torch.int32), nb, cs)
    scores = scores.cpu().numpy()
    keys = keys[:nb]
    bounds = np.searchsorted(keys >> 31, np.arange(v + 1))
    addrs = keys & (2**31 - 1)
    return [None if lo == hi else (addrs[lo:hi], scores[lo:hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])]
