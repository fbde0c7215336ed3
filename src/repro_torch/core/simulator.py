"""Two-level set-associative datapath and its between-interval resize.

The PyTorch counterpart of :mod:`repro.core.simulator` for the batched
two-level path. Per-VM caches are stacked: every :class:`CacheState`
tensor is ``[V, S, W]`` (``tags``/``lru`` int32, ``-1`` = empty/never;
``dirty`` bool), and per-VM way counts and clocks are ``[V]`` int32.

:func:`simulate_two_level_batch` runs one ``[V, N]`` request block for
all VMs through the ``two_level`` CUDA kernel (CUDA tensors) or its
plain PyTorch version (CPU tensors) — see
:mod:`repro_torch.kernels.datapath.ops`. Requests with ``addr == -1``
are exact no-ops, which is how ragged per-VM windows batch to a
rectangle. Integer state and counts are bit-identical to the JAX
reference, and ``latency_sum`` is bit-identical because both add each
request's float32 latency in request order.

All functions are functional: they return new tensors and leave their
inputs untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.datapath import ops as datapath_ops


class CacheState(NamedTuple):
    tags: torch.Tensor   # int32 [V, S, W], -1 = invalid
    lru: torch.Tensor    # int32 [V, S, W], last-touch time (-1 = never)
    dirty: torch.Tensor  # bool  [V, S, W]


class Stats(NamedTuple):
    """Per-VM ``[V]`` counters of one block; ``latency_sum`` is float32,
    the rest int32. The last four are maintenance/classifier channels
    the datapath leaves at zero."""
    reads: torch.Tensor
    writes: torch.Tensor
    read_hits_l1: torch.Tensor     # DRAM hits
    read_hits_l2: torch.Tensor     # SSD read hits
    write_hits_l2: torch.Tensor
    cache_writes_l2: torch.Tensor  # endurance metric: writes committed to SSD
    disk_reads: torch.Tensor
    disk_writes: torch.Tensor
    latency_sum: torch.Tensor      # seconds (float32)
    bypassed: torch.Tensor
    pop_drops: torch.Tensor
    flushes: torch.Tensor
    dirty_resident: torch.Tensor


def make_cache_batch(num_vms: int, num_sets: int, ways: int,
                     device="cuda") -> CacheState:
    """Empty stacked per-VM caches on ``device``."""
    shape = (num_vms, num_sets, ways)
    return CacheState(
        tags=torch.full(shape, -1, dtype=torch.int32, device=device),
        lru=torch.full(shape, -1, dtype=torch.int32, device=device),
        dirty=torch.zeros(shape, dtype=torch.bool, device=device))


def capacity_to_ways(capacity_blocks, num_sets: int,
                     max_ways: int) -> np.ndarray:
    """Blocks -> active ways (ceil), clipped to the geometry (host)."""
    w = (np.asarray(capacity_blocks, np.int64) + num_sets - 1) // num_sets
    return np.clip(w, 0, max_ways).astype(np.int32)


def _vec(x, num_vms: int, device) -> torch.Tensor:
    """A ``[V]`` int32 operand on ``device`` (scalars broadcast)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x, np.int32)
    t = torch.as_tensor(x, device=device).to(torch.int32)
    return t.expand(num_vms).contiguous() if t.dim() == 0 else t


def resize(state: CacheState, old_ways, new_ways):
    """Deactivate ways ``>= new_ways[v]`` of every VM that shrinks.

    ``old_ways``/``new_ways`` are ``[V]``. Returns ``(state, flushed[V])``
    where ``flushed`` counts the dirty blocks dropped (the JAX
    ``resize_batch``: ``resize`` mapped over the VM axis)."""
    v, _, w = state.tags.shape
    dev = state.tags.device
    old_ways = _vec(old_ways, v, dev)
    new_ways = _vec(new_ways, v, dev)
    shrink = new_ways < old_ways
    widx = torch.arange(w, dtype=torch.int32, device=dev)
    clear = (shrink[:, None] & (widx[None, :] >= new_ways[:, None]))[:, None]
    flushed = (state.dirty & clear).sum(dim=(1, 2), dtype=torch.int32)
    return CacheState(
        tags=state.tags.masked_fill(clear, -1),
        lru=state.lru.masked_fill(clear, -1),
        dirty=state.dirty.masked_fill(clear, False)), flushed


def resize_levels(dram: CacheState, ssd: CacheState, old_dram, new_dram,
                  old_ssd, new_ssd):
    """Resize both levels; returns ``(dram, ssd, dram_flushed[V],
    ssd_flushed[V])``."""
    dram, fl_d = resize(dram, old_dram, new_dram)
    ssd, fl_s = resize(ssd, old_ssd, new_ssd)
    return dram, ssd, fl_d, fl_s


def simulate_two_level_batch(addr, is_write, dram: CacheState,
                             ssd: CacheState, ways_dram, ways_ssd,
                             mode: str = "full", t0=0):
    """ETICA datapath for V VMs over one ``[V, N]`` block.

    DRAM is RO (reads allocate, writes bypass and invalidate); the SSD is
    WBWO. ``mode="full"`` leaves SSD contents to write hits and the
    maintenance; ``mode="npe"`` lets write misses allocate in the SSD.
    ``addr``/``is_write`` may be numpy or tensors; ``ways_*``/``t0`` are
    ``[V]`` (scalars broadcast). Returns ``(dram, ssd, Stats, t_end)``.
    """
    if mode not in ("full", "npe"):
        raise ValueError(f"mode must be 'full' or 'npe', got {mode!r}")
    dev = dram.tags.device
    if not isinstance(addr, torch.Tensor):
        addr = np.ascontiguousarray(addr, np.int32)
        is_write = np.ascontiguousarray(is_write, bool)
    addr = torch.as_tensor(addr, device=dev).to(torch.int32)
    is_write = torch.as_tensor(is_write, device=dev).to(torch.bool)
    v = addr.shape[0]
    out = datapath_ops.two_level(
        addr.contiguous(), is_write.contiguous(), *dram, *ssd,
        _vec(ways_dram, v, dev), _vec(ways_ssd, v, dev), _vec(t0, v, dev),
        npe=mode == "npe")
    (td, ld, dd, ts, ls, ds, counts, latency, t_end) = out
    zero = torch.zeros(v, dtype=torch.int32, device=dev)
    stats = Stats(*counts.unbind(1), latency, zero, zero, zero, zero)
    return CacheState(td, ld, dd), CacheState(ts, ls, ds), stats, t_end
