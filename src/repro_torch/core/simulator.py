"""Set-associative datapaths, their between-interval resize and the
maintenance ops of the staged and sequential modes.

The PyTorch counterpart of :mod:`repro.core.simulator`, the IO
classifier's datapaths (``simulate_*_classified``) included. Per-VM caches
are stacked: every :class:`CacheState` tensor is ``[V, S, W]``
(``tags``/``lru`` int32, ``-1`` = empty/never; ``dirty`` bool), and
per-VM way counts and clocks are ``[V]`` int32. The per-state entry
points of the sequential oracle (:func:`make_cache`,
:func:`simulate_two_level`, :func:`simulate_single_level`,
:func:`resize`, :func:`evict_blocks`, :func:`promote_blocks`,
:func:`clean_blocks`) take one VM's ``[S, W]`` state and run the same
kernels at V = 1 (:func:`stack_states` / :func:`unstack_states` move
between the two layouts).

:func:`simulate_two_level_batch` (ETICA's DRAM + SSD) and
:func:`simulate_single_level_batch` (the one-level baselines, each VM
under its own :class:`PolicyFlags`) run one ``[V, N]`` request block for
all VMs through a CUDA kernel (``two_level`` / ``single_level``, CUDA
tensors) or its plain PyTorch version (CPU tensors) — see
:mod:`repro_torch.kernels.datapath.ops`. Requests with ``addr == -1``
are exact no-ops, which is how ragged per-VM windows batch to a
rectangle. Integer state and counts are bit-identical to the JAX
reference, and ``latency_sum`` is bit-identical because both add each
request's float32 latency in request order.

The ``*_sharded`` dispatches run the batched functions with the VM rows
split over a :class:`repro_torch.launch.mesh.VMMesh`, one call a shard
(:func:`shard_rows` / :func:`gather_rows` move between a whole operand
and its shards); :func:`aggregate_stats_sharded` is the one sum across
shards.

The staged mode's maintenance dispatches (:func:`evict_blocks_batch`,
:func:`promote_blocks_batch`, :func:`clean_batch`) take ragged per-VM
queues, ``-1``-padded to a power-of-two width, through the scatter
kernels; the numpy ``*_ref`` oracles at the end are the sequential
mode's maintenance and resize.

All functions are functional: they return new tensors and leave their
inputs untouched.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._xla_math import sum_f32
from repro_torch.core.policies import T_SSD, Policy
from repro_torch.kernels.datapath import ops as datapath_ops
from repro_torch.launch.mesh import device_row_blocks, on_device


class CacheState(NamedTuple):
    tags: torch.Tensor   # int32 [V, S, W], -1 = invalid
    lru: torch.Tensor    # int32 [V, S, W], last-touch time (-1 = never)
    dirty: torch.Tensor  # bool  [V, S, W]


class Stats(NamedTuple):
    """Per-VM ``[V]`` counters of one block (0-d from the per-state entry
    points); ``latency_sum`` is float32, the rest int32. The last four
    are maintenance/classifier channels the datapath leaves at zero."""
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

    @staticmethod
    def zero() -> "Stats":
        """0-d CPU counters at zero: int32, ``latency_sum`` float32. A
        0-d CPU tensor adds to a card tensor on the card, with no host
        read, so they merge with counters from either device."""
        z = torch.zeros((), dtype=torch.int32)
        lat = torch.zeros((), dtype=torch.float32)
        return Stats(z, z, z, z, z, z, z, z, lat, z, z, z, z)

    def merge(self, o: "Stats") -> "Stats":
        """Field-wise sums in each field's own dtype (``latency_sum`` in
        float32, as the reference adds it)."""
        return Stats(*[a + b for a, b in zip(self, o)])

    # -- derived metrics -------------------------------------------------
    @property
    def total(self):
        return self.reads + self.writes

    @property
    def hits(self):
        return self.read_hits_l1 + self.read_hits_l2 + self.write_hits_l2

    def hit_ratio(self) -> float:
        return float(self.hits) / max(int(self.total), 1)

    def mean_latency(self) -> float:
        return float(self.latency_sum) / max(int(self.total), 1)


class PolicyFlags(NamedTuple):
    """Per-VM write-policy predicates (:mod:`repro_torch.core.policies`),
    each a ``[V]`` bool tensor, so one block serves VMs with different
    policies."""
    allocates_reads: torch.Tensor
    write_invalidates: torch.Tensor
    holds_dirty: torch.Tensor
    write_through: torch.Tensor


def policy_flags(policies: Sequence[Policy], device="cuda") -> PolicyFlags:
    """:class:`PolicyFlags` for one policy per VM, on ``device``."""
    ps = list(policies)
    return PolicyFlags(*[
        torch.tensor([getattr(p, f) for p in ps], dtype=torch.bool,
                     device=device) for f in PolicyFlags._fields])


def make_cache_batch(num_vms: int, num_sets: int, ways: int,
                     device="cuda") -> CacheState:
    """Empty stacked per-VM caches on ``device``."""
    shape = (num_vms, num_sets, ways)
    return CacheState(
        tags=torch.full(shape, -1, dtype=torch.int32, device=device),
        lru=torch.full(shape, -1, dtype=torch.int32, device=device),
        dirty=torch.zeros(shape, dtype=torch.bool, device=device))


def make_cache(num_sets: int, ways: int, device="cuda") -> CacheState:
    """One VM's empty ``[S, W]`` cache on ``device``."""
    return CacheState(*(x[0] for x in make_cache_batch(1, num_sets, ways,
                                                       device)))


def stack_states(states: Sequence[CacheState]) -> CacheState:
    """Per-VM ``[S, W]`` states as one stacked ``[V, S, W]`` state."""
    return CacheState(*(torch.stack(xs) for xs in zip(*states)))


def unstack_states(state: CacheState) -> list[CacheState]:
    """A stacked ``[V, S, W]`` state as V per-VM ``[S, W]`` views."""
    return [CacheState(*(x[i] for x in state))
            for i in range(state.tags.shape[0])]


def capacity_to_ways(capacity_blocks, num_sets: int,
                     max_ways: int) -> np.ndarray:
    """Blocks -> active ways (ceil), clipped to the geometry (host)."""
    w = (np.asarray(capacity_blocks, np.int64) + num_sets - 1) // num_sets
    return np.clip(w, 0, max_ways).astype(np.int32)


def _vec(x, num_vms: int, device) -> torch.Tensor:
    """A ``[V]`` int32 operand on ``device`` (scalars broadcast)."""
    if not isinstance(x, torch.Tensor):
        # np.ascontiguousarray would make a scalar a [1] array, which the
        # kernels' shape checks refuse
        x = np.ascontiguousarray(x, np.int32) if np.ndim(x) else \
            np.asarray(x, np.int32)
    t = torch.as_tensor(x, device=device).to(torch.int32)
    return t.expand(num_vms).contiguous() if t.dim() == 0 else t


def resize_batch(state: CacheState, old_ways, new_ways):
    """Deactivate ways ``>= new_ways[v]`` of every VM that shrinks.

    ``old_ways``/``new_ways`` are ``[V]``. Returns ``(state, flushed[V])``
    where ``flushed`` counts the dirty blocks dropped."""
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


def resize(state: CacheState, old_ways, new_ways):
    """:func:`resize_batch` for one VM's ``[S, W]`` state: a shrink drops
    the ways ``>= new_ways``, a grow is a no-op. Returns ``(state,
    flushed)``, ``flushed`` the dirty blocks dropped (0-d int32)."""
    st, flushed = resize_batch(_one(state), old_ways, new_ways)
    return CacheState(*_first(*st)), flushed[0]


def resize_levels(dram: CacheState, ssd: CacheState, old_dram, new_dram,
                  old_ssd, new_ssd):
    """Resize both levels; returns ``(dram, ssd, dram_flushed[V],
    ssd_flushed[V])``."""
    dram, fl_d = resize_batch(dram, old_dram, new_dram)
    ssd, fl_s = resize_batch(ssd, old_ssd, new_ssd)
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
    addr, is_write = _block(addr, is_write, dev)
    v = addr.shape[0]
    out = datapath_ops.two_level(
        addr, is_write, *dram, *ssd, _vec(ways_dram, v, dev),
        _vec(ways_ssd, v, dev), _vec(t0, v, dev), npe=mode == "npe")
    (td, ld, dd, ts, ls, ds, counts, latency, t_end) = out
    return (CacheState(td, ld, dd), CacheState(ts, ls, ds),
            _stats(counts, latency), t_end)


def simulate_single_level_batch(addr, is_write, state: CacheState,
                                ways_active, flags: PolicyFlags,
                                t_cache: float = T_SSD, t0=0):
    """One-level datapath for V VMs over one ``[V, N]`` block, each VM
    under the policy its entries of ``flags`` give (:func:`policy_flags`).
    ``ways_active`` and ``t0`` are ``[V]`` (scalars broadcast);
    ``t_cache`` is the cache level's hit latency. Returns ``(state,
    Stats, t_end)``."""
    dev = state.tags.device
    addr, is_write = _block(addr, is_write, dev)
    v = addr.shape[0]
    out = datapath_ops.single_level(
        addr, is_write, *state, _vec(ways_active, v, dev), *flags,
        _vec(t0, v, dev), t_cache=t_cache)
    tags, lru, dirty, counts, latency, t_end = out
    return CacheState(tags, lru, dirty), _stats(counts, latency), t_end


# ---------------------------------------------------------------------------
# sharded dispatches (the VM axis split over a launch.mesh.VMMesh)
# ---------------------------------------------------------------------------
#
# The counterparts of the JAX package's shard_map dispatches. Each runs
# the single-device batched function once a shard, on the shard's V / d
# rows, inside its device's context: kernels launch on the current
# device's stream, so a shard on another card must be current while its
# kernels launch. A sharded operand is a list, one entry a shard, each
# entry's tensors on its shard's device; any other operand is whole and
# is split by rows (a scalar goes to every shard). Outputs come back
# sharded. Every per-VM result is bit-identical to the unsharded batched
# dispatch, since each row's work is the same; the one reduction across
# shards is aggregate_stats_sharded.

def _parts(x, mesh, copy: bool = False) -> list:
    """``x`` as one entry a shard (see above): a list as it is, a
    NamedTuple field by field, a scalar repeated, rows of a tensor or
    numpy array moved to each shard's device (copied with ``copy``)."""
    if isinstance(x, list):
        if len(x) != mesh.size:
            raise ValueError(f"a sharded operand has {len(x)} entries for "
                             f"a mesh of {mesh.size} shards")
        return x
    if isinstance(x, tuple):
        return [type(x)(*fs) for fs in zip(*(_parts(f, mesh, copy)
                                            for f in x))]
    if not isinstance(x, torch.Tensor):
        if np.ndim(x) == 0:
            return [x] * mesh.size
        x = torch.from_numpy(np.array(x))
    if x.dim() == 0:
        return [x] * mesh.size
    return [x[rows].to(dev, copy=copy).contiguous()
            for dev, rows in device_row_blocks(x.shape[0], mesh)]


def shard_rows(x, mesh) -> list:
    """A whole ``[V, ...]`` operand (a tensor, numpy array, or a
    NamedTuple of them such as :class:`CacheState`) as one entry a
    shard: the rows ``device_row_blocks`` gives each device, in tensors
    of their own on that device."""
    return _parts(x, mesh, copy=True)


def gather_rows(shards: list):
    """Sharded entries as one whole operand on the first shard's device,
    rows in shard order."""
    first = shards[0]
    if isinstance(first, tuple):
        return type(first)(*(gather_rows(list(f)) for f in zip(*shards)))
    return torch.cat([s.to(first.device) for s in shards])


def map_shards(fn, mesh, *args) -> tuple[list, ...]:
    """``fn`` once a shard, on each shard's entries, inside its device's
    context; its output tuples transposed into one list an output."""
    parts = [_parts(a, mesh) for a in args]
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            outs.append(fn(*(p[i] for p in parts)))
    return tuple(list(o) for o in zip(*outs))


def simulate_two_level_sharded(addr, is_write, dram, ssd, ways_dram,
                               ways_ssd, mesh, mode: str = "full", t0=0):
    """:func:`simulate_two_level_batch` with the VM rows split over
    ``mesh``. Returns ``(dram, ssd, Stats, t_end)``, each sharded."""
    return map_shards(
        lambda a, w, dr, ss, wd, ws, t: simulate_two_level_batch(
            a, w, dr, ss, wd, ws, mode, t),
        mesh, addr, is_write, dram, ssd, ways_dram, ways_ssd, t0)


def simulate_single_level_sharded(addr, is_write, state, ways_active, flags,
                                  mesh, t_cache: float = T_SSD, t0=0):
    """:func:`simulate_single_level_batch` with the VM rows split over
    ``mesh``. Returns ``(state, Stats, t_end)``, each sharded."""
    return map_shards(
        lambda a, w, st, wa, fl, t: simulate_single_level_batch(
            a, w, st, wa, fl, t_cache, t),
        mesh, addr, is_write, state, ways_active, flags, t0)


def resize_levels_sharded(dram, ssd, old_dram, new_dram, old_ssd, new_ssd,
                          mesh):
    """:func:`resize_levels` with the VM rows split over ``mesh``.
    Returns ``(dram, ssd, dram_flushed, ssd_flushed)``, each sharded."""
    return map_shards(resize_levels, mesh, dram, ssd, old_dram, new_dram,
                      old_ssd, new_ssd)


def resize_batch_sharded(state, old_ways, new_ways, mesh):
    """:func:`resize_batch` with the VM rows split over ``mesh``. Returns
    ``(state, flushed)``, each sharded."""
    return map_shards(resize_batch, mesh, state, old_ways, new_ways)


def aggregate_stats_sharded(stats, mesh) -> Stats:
    """Total :class:`Stats` over sharded ``[V]`` per-VM stats, as 0-d
    tensors on the first shard's device: each field summed within each
    shard, then the shard sums added in shard order, the JAX package's
    ``psum(jnp.sum(x, 0))`` (``latency_sum`` in XLA:CPU's float32 order,
    :func:`repro_torch._xla_math.sum_f32`). The only reduction across
    shards of a sharded run."""
    home = mesh.devices[0]
    parts = _parts(stats, mesh)
    out = []
    for k in range(len(Stats._fields)):
        total = None
        for st in parts:
            x = st[k]
            s = (sum_f32(x) if x.dtype == torch.float32
                 else x.sum(dtype=x.dtype)).to(home)
            total = s if total is None else total + s
        out.append(total)
    return Stats(*out)


# ---------------------------------------------------------------------------
# classified datapaths (IO-class sub-partitions — repro_torch.classify)
# ---------------------------------------------------------------------------
#
# The classified datapaths take a per-request class id ``cls`` beside
# ``addr``/``is_write`` and per-class tables: insertion way bounds (per
# level for the two-level path), per-class policy flags (one level only;
# the two-level hierarchy keeps DRAM-RO / SSD-WBWO) and a ``[C]`` bypass
# mask. A bypassed read goes to disk touching nothing; a bypassed write
# goes to disk and drops any cached copy unflushed. Both count in
# ``Stats.bypassed``. Lookups stay over the VM's active ways: classes
# partition insertion, not residency. With one match-all class the
# results equal the unclassified datapaths'. They also return the
# per-class served hits and misses of the non-bypassed requests.

def _table(x, dtype, device) -> torch.Tensor:
    """A per-class table (numpy or tensor) as a contiguous tensor."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x, np.int32 if dtype == torch.int32
                                 else bool)
    return torch.as_tensor(x, device=device).to(dtype).contiguous()


def _row(x):
    """One VM's operand (numpy or tensor) with a leading ``[1]`` axis."""
    return x[None] if isinstance(x, torch.Tensor) else np.asarray(x)[None]


def _class_stats(counts, latency) -> Stats:
    """:class:`Stats` from a classified kernel's ``[V, 9]`` counts."""
    zero = torch.zeros_like(counts[:, 0])
    return Stats(*counts[:, :8].unbind(1), latency, counts[:, 8], zero,
                 zero, zero)


def simulate_two_level_classified_batch(addr, is_write, cls,
                                        dram: CacheState, ssd: CacheState,
                                        ways_dram, ways_ssd, bypass, lo_d,
                                        hi_d, lo_s, hi_s,
                                        mode: str = "full", t0=0):
    """Classified :func:`simulate_two_level_batch`: ``cls`` is ``[V,
    N]``, the way bounds ``[V, C]``, ``bypass`` a shared ``[C]`` mask.
    Returns ``(dram, ssd, Stats, t_end, cls_hits [V, C], cls_miss [V,
    C])``, the last two the served hits (a read's hit at either level, a
    write's SSD hit) and misses of each class's non-bypassed requests."""
    if mode not in ("full", "npe"):
        raise ValueError(f"mode must be 'full' or 'npe', got {mode!r}")
    dev = dram.tags.device
    addr, is_write = _block(addr, is_write, dev)
    v = addr.shape[0]
    out = datapath_ops.two_level_classified(
        addr, is_write, _table(cls, torch.int32, dev), *dram, *ssd,
        _vec(ways_dram, v, dev), _vec(ways_ssd, v, dev), _vec(t0, v, dev),
        _table(bypass, torch.bool, dev),
        *(_table(x, torch.int32, dev) for x in (lo_d, hi_d, lo_s, hi_s)),
        npe=mode == "npe")
    (td, ld, dd, ts, ls, ds, counts, latency, t_end, hits, miss) = out
    return (CacheState(td, ld, dd), CacheState(ts, ls, ds),
            _class_stats(counts, latency), t_end, hits, miss)


def simulate_single_level_classified_batch(addr, is_write, cls,
                                           state: CacheState, ways_active,
                                           flags: PolicyFlags, way_lo,
                                           way_hi, bypass,
                                           t_cache: float = T_SSD, t0=0):
    """Classified :func:`simulate_single_level_batch`: ``cls`` is ``[V,
    N]``, each :class:`PolicyFlags` field and the way bounds ``[V, C]``,
    ``bypass`` a shared ``[C]`` mask. Returns ``(state, Stats, t_end,
    cls_hits [V, C], cls_miss [V, C])``."""
    dev = state.tags.device
    addr, is_write = _block(addr, is_write, dev)
    v = addr.shape[0]
    out = datapath_ops.single_level_classified(
        addr, is_write, _table(cls, torch.int32, dev), *state,
        _vec(ways_active, v, dev),
        *(_table(f, torch.bool, dev) for f in flags), _vec(t0, v, dev),
        _table(bypass, torch.bool, dev), _table(way_lo, torch.int32, dev),
        _table(way_hi, torch.int32, dev), t_cache=t_cache)
    tags, lru, dirty, counts, latency, t_end, hits, miss = out
    return (CacheState(tags, lru, dirty), _class_stats(counts, latency),
            t_end, hits, miss)


def simulate_two_level_classified(addr, is_write, cls, dram: CacheState,
                                  ssd: CacheState, ways_dram: int,
                                  ways_ssd: int, bypass, lo_d, hi_d, lo_s,
                                  hi_s, mode: str = "full", t0: int = 0):
    """:func:`simulate_two_level_classified_batch` for one VM: ``[N]``
    requests and class ids, ``[C]`` way bounds per level. Returns
    ``(dram, ssd, Stats, t_end, cls_hits [C], cls_miss [C])`` with 0-d
    counts."""
    dram, ssd, st, t_end, hits, miss = simulate_two_level_classified_batch(
        _row(addr), _row(is_write), _row(cls), _one(dram), _one(ssd),
        ways_dram, ways_ssd, bypass, _row(lo_d), _row(hi_d), _row(lo_s),
        _row(hi_s), mode, t0)
    return (CacheState(*_first(*dram)), CacheState(*_first(*ssd)),
            _stats_one(st), t_end[0], hits[0], miss[0])


def simulate_single_level_classified(addr, is_write, cls, state: CacheState,
                                     ways_active: int, flags: PolicyFlags,
                                     way_lo, way_hi, bypass,
                                     t_cache: float = T_SSD, t0: int = 0):
    """:func:`simulate_single_level_classified_batch` for one VM: ``[N]``
    requests and class ids, ``[C]`` flags and way bounds. Returns
    ``(state, Stats, t_end, cls_hits [C], cls_miss [C])`` with 0-d
    counts."""
    state, st, t_end, hits, miss = simulate_single_level_classified_batch(
        _row(addr), _row(is_write), _row(cls), _one(state), ways_active,
        PolicyFlags(*(_row(f) for f in flags)), _row(way_lo), _row(way_hi),
        bypass, t_cache, t0)
    return (CacheState(*_first(*state)), _stats_one(st), t_end[0], hits[0],
            miss[0])


def _one(state: CacheState) -> CacheState:
    return CacheState(*(x[None] for x in state))


def _first(*xs):
    return tuple(x[0] for x in xs)


def _stats_one(st: Stats) -> Stats:
    return Stats(*(x[0] for x in st))


def simulate_two_level(addr, is_write, dram: CacheState, ssd: CacheState,
                       ways_dram: int, ways_ssd: int, mode: str = "full",
                       t0: int = 0):
    """:func:`simulate_two_level_batch` for one VM: ``[N]`` requests over
    ``[S, W]`` states. Returns ``(dram, ssd, Stats, t_end)`` with 0-d
    counts."""
    dram, ssd, st, t_end = simulate_two_level_batch(
        np.asarray(addr)[None], np.asarray(is_write)[None], _one(dram),
        _one(ssd), ways_dram, ways_ssd, mode, t0)
    return (CacheState(*_first(*dram)), CacheState(*_first(*ssd)),
            _stats_one(st), t_end[0])


def simulate_single_level(addr, is_write, state: CacheState,
                          ways_active: int, policy: Policy,
                          t_cache: float = T_SSD, t0: int = 0):
    """:func:`simulate_single_level_batch` for one VM under ``policy``.
    Returns ``(state, Stats, t_end)`` with 0-d counts."""
    state, st, t_end = simulate_single_level_batch(
        np.asarray(addr)[None], np.asarray(is_write)[None], _one(state),
        ways_active, policy_flags([policy], state.tags.device), t_cache, t0)
    return CacheState(*_first(*state)), _stats_one(st), t_end[0]


def _block(addr, is_write, device):
    """A ``[V, N]`` request block (numpy or tensors) as contiguous int32
    / bool tensors on ``device``. A read-only array (a trace store's
    memory-mapped shard) is copied once here, so no tensor aliases the
    mapping."""
    if not isinstance(addr, torch.Tensor):
        addr = np.require(addr, np.int32, ("C", "W"))
        is_write = np.require(is_write, bool, ("C", "W"))
    addr = torch.as_tensor(addr, device=device).to(torch.int32)
    is_write = torch.as_tensor(is_write, device=device).to(torch.bool)
    return addr.contiguous(), is_write.contiguous()


def _stats(counts, latency) -> Stats:
    """:class:`Stats` from a datapath kernel's ``[V, 8]`` counts and
    ``[V]`` latency sums (the four maintenance channels zero)."""
    zero = torch.zeros_like(counts[:, 0])
    return Stats(*counts.unbind(1), latency, zero, zero, zero, zero)


# ---------------------------------------------------------------------------
# maintenance ops of the staged and sequential modes
# ---------------------------------------------------------------------------

def resident_blocks(state: CacheState, ways_active: int) -> np.ndarray:
    """Blocks resident in one VM's first ``ways_active`` ways (host)."""
    tags = state.tags[:, :max(ways_active, 0)].cpu().numpy()
    return tags[tags >= 0]


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pad_addrs(addrs) -> np.ndarray:
    """A queue as int32, ``-1``-padded to a power-of-two length."""
    a = np.asarray(addrs).reshape(-1).astype(np.int32)
    return np.pad(a, (0, _next_pow2(a.size) - a.size), constant_values=-1)


def _pad_addrs_batch(queues: Sequence[np.ndarray]) -> np.ndarray:
    """Ragged per-VM queues as a ``[V, Q]`` rectangle of a power-of-two
    width, padded with ``-1``."""
    q = _next_pow2(max((np.size(a) for a in queues), default=0))
    out = np.full((len(queues), max(q, 1)), -1, np.int32)
    for v, a in enumerate(queues):
        a = np.asarray(a).reshape(-1)
        out[v, :a.size] = a
    return out


def _queue(queues: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(queues).to(device)


def evict_blocks(state: CacheState, addrs):
    """Evict the given blocks from one VM's ``[S, W]`` state (``-1``
    entries ignored). Returns ``(state, flushed)``, ``flushed`` the dirty
    blocks dropped (0-d)."""
    from repro_torch.kernels.maintenance import ops as maint_ops
    if np.size(addrs) == 0:
        return state, torch.zeros((), dtype=torch.int32)
    st, flushed = maint_ops.evict(
        _one(state), _queue(_pad_addrs(addrs)[None], state.tags.device))
    return CacheState(*_first(*st)), flushed[0]


def promote_blocks(state: CacheState, addrs, ways_active: int, t: int):
    """Insert blocks into FREE active ways of one VM's ``[S, W]`` state:
    the first occurrence of an address wins, resident blocks are skipped,
    each set's free ways fill in way order in queue order (``-1`` entries
    ignored). Returns ``(state, n_promoted)`` (0-d)."""
    from repro_torch.kernels.maintenance import ops as maint_ops
    if np.size(addrs) == 0:
        return state, torch.zeros((), dtype=torch.int32)
    dev = state.tags.device
    st, n = maint_ops.promote(
        _one(state), _queue(_pad_addrs(addrs)[None], dev),
        _vec(ways_active, 1, dev), _vec(t, 1, dev))
    return CacheState(*_first(*st)), n[0]


def evict_blocks_batch(state: CacheState, queues: Sequence[np.ndarray]):
    """Per-VM :func:`evict_blocks` over a stacked ``[V, S, W]`` state in
    one launch. ``queues`` is one (possibly empty) address array per VM;
    returns ``(state, flushed[V])``."""
    from repro_torch.kernels.maintenance import ops as maint_ops
    return maint_ops.evict(state, _queue(_pad_addrs_batch(queues),
                                         state.tags.device))


def promote_blocks_batch(state: CacheState, queues: Sequence[np.ndarray],
                         ways_active, t):
    """Per-VM :func:`promote_blocks` over a stacked ``[V, S, W]`` state in
    one launch, with the first-occurrence dedupe; ``ways_active``/``t``
    are ``[V]``. Returns ``(state, promoted[V])``."""
    from repro_torch.kernels.maintenance import ops as maint_ops
    v = state.tags.shape[0]
    dev = state.tags.device
    return maint_ops.promote(state, _queue(_pad_addrs_batch(queues), dev),
                             _vec(ways_active, v, dev), _vec(t, v, dev))


def clean_batch(state: CacheState, ways_active, quota):
    """The background cleaner over a stacked ``[V, S, W]`` state: flush
    up to ``quota[v]`` of VM v's oldest dirty active blocks. Returns
    ``(state, flushed[V], dirty_left[V])``."""
    from repro_torch.kernels.maintenance import ops as maint_ops
    v = state.tags.shape[0]
    dev = state.tags.device
    return maint_ops.clean(state, _vec(ways_active, v, dev),
                           _vec(quota, v, dev))


def clean_blocks(state: CacheState, ways_active, quota):
    """:func:`clean_batch` for one VM's ``[S, W]`` state: the ``quota``
    oldest dirty blocks in active ways, by (lru, ``set * W + way``),
    become clean and stay resident. Returns ``(state, flushed,
    dirty_left)``, both 0-d int32 counts from the one ``clean`` call."""
    st, flushed, left = clean_batch(_one(state), ways_active, quota)
    return CacheState(*_first(*st)), flushed[0], left[0]


# ---------------------------------------------------------------------------
# numpy reference oracles (the sequential mode's resize and maintenance)
# ---------------------------------------------------------------------------

def _host(state: CacheState):
    return tuple(x.cpu().numpy().copy() for x in state)


def _like(state: CacheState, tags, lru, dirty) -> CacheState:
    dev = state.tags.device
    return CacheState(*(torch.from_numpy(x).to(dev)
                        for x in (tags, lru, dirty)))


def resize_ref(state: CacheState, old_ways: int, new_ways: int):
    """Sequential numpy reference for one VM's resize: shrinking drops
    the ways ``>= new_ways``. Returns ``(state, flushed)``."""
    if new_ways >= old_ways:
        return state, 0
    tags, lru, dirty = _host(state)
    flushed = int(dirty[:, new_ways:].sum())
    tags[:, new_ways:] = -1
    lru[:, new_ways:] = -1
    dirty[:, new_ways:] = False
    return _like(state, tags, lru, dirty), flushed


def evict_blocks_ref(state: CacheState, addrs: np.ndarray):
    """Sequential numpy reference for :func:`evict_blocks`."""
    tags, lru, dirty = _host(state)
    mask = np.isin(tags, addrs) & (tags >= 0)
    flushed = int((dirty & mask).sum())
    tags[mask] = -1
    lru[mask] = -1
    dirty[mask] = False
    return _like(state, tags, lru, dirty), flushed


def promote_blocks_ref(state: CacheState, addrs: np.ndarray,
                       ways_active: int, t: int):
    """Sequential numpy reference for :func:`promote_blocks`."""
    tags, lru, dirty = _host(state)
    num_sets, _ = tags.shape
    n = 0
    for a in np.asarray(addrs):
        if a < 0:
            continue
        s = int(a) % num_sets
        if (tags[s, :ways_active] == a).any():
            continue
        free = np.nonzero(tags[s, :ways_active] < 0)[0]
        if free.size == 0:
            continue
        w = free[0]
        tags[s, w] = a
        lru[s, w] = t
        dirty[s, w] = False
        n += 1
    return _like(state, tags, lru, dirty), n


def clean_blocks_ref(state: CacheState, ways_active: int, quota: int):
    """Sequential numpy reference of the background cleaner for one VM:
    the ``quota`` oldest dirty active blocks, by (lru, ``set * W + way``),
    become clean. Returns ``(state, flushed, dirty_left)``."""
    tags, lru, dirty = _host(state)
    num_sets, num_ways = tags.shape
    wa = min(max(int(ways_active), 0), num_ways)
    cand = [(int(lru[s, w]), s * num_ways + w, s, w)
            for s in range(num_sets) for w in range(wa) if dirty[s, w]]
    cand.sort()
    take = min(max(int(quota), 0), len(cand))
    for _, _, s, w in cand[:take]:
        dirty[s, w] = False
    return _like(state, tags, lru, dirty), take, len(cand) - take
