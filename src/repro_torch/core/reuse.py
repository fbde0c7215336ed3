"""Reuse-distance engine: TRD, URD and the paper's POD metric (§4.3.1).

The PyTorch counterpart of :mod:`repro.core.reuse` for the controller's
main path. Every function works on ``[V, N]`` rows at once (the JAX
package vmaps one row function). Per policy the decomposition picks

  * ``touch[j]``  — access j occupies or refreshes a block;
  * ``served[i]`` — access i would hit an infinite cache under the policy;
  * ``dist[i]``   — for served i, the distinct blocks touched strictly
    between the previous touch of ``addr[i]`` and i (``-1`` otherwise),

with the policy filters

  * POD(WB/WT), URD : touch = all,   served = reads with an earlier access;
  * POD(RO)         : touch = reads, served = reads whose previous access
                      to the address is a read;
  * POD(WBWO/WO)    : touch = writes + served reads, served = reads with
                      an earlier write to the address;
  * TRD             : WB with ``sizing_reads_only=False`` (every re-access).

The O(N^2) count is :func:`repro_torch.kernels.reuse_distance.ops
.count_between` (the CUDA kernel on the card); the previous/next-touch
indices come from one stable sort and a segmented running maximum, with
no loop over requests. Host-side analytics (:func:`demand_blocks`,
:func:`hit_counts_at_sizes`) stay numpy. :func:`pod`, :func:`urd`,
:func:`trd` (a trace's largest distance) and :func:`mrc` (its hit-ratio
curve) take one trace through one decomposition pass.

:func:`sizing_metrics_batch` is the one-level baselines' sizing: one of
four metrics (:data:`SIZING_KINDS`) for every VM, reduced on the device
from one decomposition pass, with one copy to the host at the end;
:class:`SizingMetric` binds a kind to its size grid for the chassis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.policies import Policy
from repro_torch.kernels import resolve_device, upload
from repro_torch.kernels.reuse_distance.ops import count_between
from repro_torch.launch.mesh import device_row_blocks, on_device

COLD = -1   # distance of a cold / not-served access


@dataclasses.dataclass
class DistResult:
    """Per-access reuse-distance decomposition (numpy or tensors)."""
    dist: np.ndarray     # int32 [N]; -1 where not served
    served: np.ndarray   # bool  [N]
    touch: np.ndarray    # bool  [N]

    @property
    def max(self) -> int:
        d = np.where(np.asarray(self.served), np.asarray(self.dist), COLD)
        return int(d.max(initial=COLD))


def _prev_same(addr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """prev[v, i] = largest j < i with addr[v, j] == addr[v, i] and
    mask[v, j]; else -1. Defined for every i, masked or not.

    A stable sort groups each address's accesses in index order; a
    running maximum of the masked indices, reset at each address run,
    then gives every position its nearest masked predecessor."""
    v, n = addr.shape
    order = torch.sort(addr, dim=1, stable=True).indices
    s_addr = addr.gather(1, order)
    s_mask = mask.gather(1, order)
    head = torch.ones_like(s_mask)
    head[:, 1:] = s_addr[:, 1:] != s_addr[:, :-1]
    run = head.cumsum(dim=1)                       # run id, int64
    base = run * (n + 1)
    key = base + torch.where(s_mask, order + 1, 0)
    incl = key.cummax(dim=1).values - base - 1     # masked index <= p
    prev_sorted = torch.full_like(incl, -1)
    prev_sorted[:, 1:] = torch.where(head[:, 1:], -1, incl[:, :-1])
    out = torch.empty_like(prev_sorted)
    out.scatter_(1, order, prev_sorted)
    return out.to(torch.int32)


def _next_same(addr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """next[v, i] = smallest j > i with addr[v, j] == addr[v, i] and
    mask[v, j]; else N."""
    n = addr.shape[1]
    rev = _prev_same(addr.flip(1), mask.flip(1)).flip(1)
    return torch.where(rev >= 0, n - 1 - rev, n).to(torch.int32)


def decompose(addr: torch.Tensor, is_write: torch.Tensor, policy: Policy,
              *, sizing_reads_only: bool = True):
    """``(dist, served, touch)`` tensors for ``[V, N]`` rows."""
    is_read = ~is_write
    all_mask = torch.ones_like(is_write)
    prev_any = _prev_same(addr, all_mask)
    has_prev = prev_any >= 0
    if policy in (Policy.WB, Policy.WT):
        touch = all_mask
        served = is_read & has_prev
    elif policy is Policy.RO:
        touch = is_read
        prev_is_read = ~is_write.gather(1, prev_any.clamp(min=0).long())
        served = is_read & has_prev & prev_is_read
    elif policy in (Policy.WBWO, Policy.WO):
        served = is_read & (_prev_same(addr, is_write) >= 0)
        touch = is_write | served
    else:  # pragma: no cover
        raise ValueError(policy)
    dist = count_between(_prev_same(addr, touch), touch.contiguous(),
                         _next_same(addr, touch))
    if not sizing_reads_only:
        served = served | (is_write & has_prev)
    return torch.where(served, dist, COLD), served, touch


# Rows are padded to a power-of-two bucket with trailing writes to fresh,
# never-reused addresses: they sit after every real access, are cold
# writes (never served), and as touches only occupy positions after all
# real windows — so padding is exact.

_PAD_BASE = np.int32(2**30)


def _bucket(n: int, min_size: int = 256) -> int:
    return max(min_size, 1 << (n - 1).bit_length())


def _pad_rows(addrs, writes, live: list[int], lens: list[int]):
    """Stack the live rows of ragged per-VM request lists into ``[L, b]``
    numpy arrays padded to a common bucket (exact, see above)."""
    b = _bucket(max(lens[v] for v in live))
    amat = np.empty((len(live), b), np.int32)
    wmat = np.empty((len(live), b), bool)
    for i, v in enumerate(live):
        pad_addr = _PAD_BASE + np.arange(b - lens[v], dtype=np.int32)
        amat[i] = np.concatenate([np.asarray(addrs[v], np.int32), pad_addr])
        wmat[i] = np.concatenate(
            [np.asarray(writes[v], bool), np.ones(b - lens[v], bool)])
    return amat, wmat


def _block_rows(addr: torch.Tensor, is_write: torch.Tensor,
                lens: torch.Tensor, width: int):
    """The rows :func:`_pad_rows` builds for every VM, derived on the
    device from a ``[V, chunk]`` datapath block whose row v holds
    ``lens[v]`` requests: the requests, then fresh cold writes, to
    ``width`` (at least ``max(lens)``) columns."""
    v, chunk = addr.shape
    keep = min(width, chunk)
    a = addr.new_full((v, width), -1)
    w = is_write.new_zeros((v, width))
    a[:, :keep] = addr[:, :keep]
    w[:, :keep] = is_write[:, :keep]
    col = torch.arange(width, dtype=torch.int32, device=addr.device)[None, :]
    pad = col >= lens[:, None]
    return (torch.where(pad, int(_PAD_BASE) + col - lens[:, None], a),
            w | pad)


def _distances_batch(addrs, writes, policy: Policy, sizing_reads_only: bool,
                     device, host: bool = True,
                     mesh=None) -> list[DistResult | None]:
    """Decompose ragged per-VM traces in one batched pass; per-VM results
    (numpy, or tensors on the device with ``host=False``), ``None`` for
    empty traces. With ``mesh`` every row, empty ones included (as
    pure-pad rows), is decomposed on its shard's device, one pass a
    shard, and the results come to the host."""
    lens = [int(np.shape(a)[0]) for a in addrs]
    live = [v for v, n in enumerate(lens) if n > 0]
    if not live:
        return [None] * len(lens)
    if mesh is not None:
        idx = list(range(len(lens)))
        amat, wmat = _pad_rows(addrs, writes, idx, lens)
        dist, served, touch = _decompose_sharded(mesh, amat, wmat, policy,
                                                 sizing_reads_only)
    else:
        idx = live
        dev = resolve_device(device)
        amat, wmat = _pad_rows(addrs, writes, live, lens)
        dist, served, touch = decompose(upload(amat, dev), upload(wmat, dev),
                                        policy,
                                        sizing_reads_only=sizing_reads_only)
        if host:
            dist, served, touch = (x.cpu().numpy() for x in (dist, served,
                                                             touch))
    out: list[DistResult | None] = [None] * len(lens)
    for i, v in enumerate(idx):
        if lens[v]:
            out[v] = DistResult(dist[i, :lens[v]], served[i, :lens[v]],
                                touch[i, :lens[v]])
    return out


def _decompose_sharded(mesh, amat, wmat, policy: Policy,
                       sizing_reads_only: bool):
    """:func:`decompose` of ``[V, b]`` host rows split over ``mesh``: one
    pass (one ``count_between`` launch) a shard on its own rows, then
    one copy of all shards' channels to the host (numpy)."""
    parts = []
    for dev, rows in device_row_blocks(amat.shape[0], mesh):
        with on_device(dev):
            parts.append(decompose(upload(amat[rows], dev),
                                   upload(wmat[rows], dev), policy,
                                   sizing_reads_only=sizing_reads_only))
    return tuple(_host_cat(p[k] for p in parts) for k in range(3))


def _host_cat(xs) -> np.ndarray:
    """Shards' tensors concatenated on the first one's device, then one
    copy to the host."""
    xs = list(xs)
    return torch.cat([x.to(xs[0].device) for x in xs]).cpu().numpy()


def pod_distances(addr, is_write, policy: Policy, device="cuda",
                  host: bool = True) -> DistResult:
    """POD decomposition of one trace (one ``[1, b]`` row of
    :func:`pod_distances_batch`). With ``host=False`` the channels stay on
    the device as tensors."""
    r = _distances_batch([addr], [is_write], policy, True, device, host)[0]
    if r is None:                      # empty trace: empty channels
        e = np.empty(0, np.int32)
        chans = (e, e.astype(bool), e.astype(bool))
        if not host:
            dev = resolve_device(device)
            chans = tuple(torch.from_numpy(x).to(dev) for x in chans)
        r = DistResult(*chans)
    return r


def urd_distances(addr, is_write, device="cuda") -> DistResult:
    """URD (ECI-Cache) of one trace: read re-references over WB content
    semantics (host numpy)."""
    return pod_distances(addr, is_write, Policy.WB, device)


def trd_distances(addr, is_write, device="cuda") -> DistResult:
    """TRD (Centaur) of one trace: every re-access is served (host
    numpy)."""
    r = _distances_batch([addr], [is_write], Policy.WB, False, device)[0]
    if r is None:
        e = np.empty(0, np.int32)
        r = DistResult(e, e.astype(bool), e.astype(bool))
    return r


def pod_distances_batch(addrs, writes, policy: Policy, device="cuda",
                        mesh=None) -> list[DistResult | None]:
    """Per-VM POD decompositions in one batched pass (ragged input).
    ``mesh`` (a :class:`repro_torch.launch.mesh.VMMesh`, the VM count a
    multiple of its size) splits the rows over its devices, one pass a
    shard; ``device`` is then unused."""
    return _distances_batch(addrs, writes, policy, True, device, mesh=mesh)


def trd_distances_batch(addrs, writes, device="cuda",
                        mesh=None) -> list[DistResult | None]:
    """Per-VM TRD decompositions (every re-access is served); ``mesh``
    as in :func:`pod_distances_batch`."""
    return _distances_batch(addrs, writes, Policy.WB, False, device,
                            mesh=mesh)


def pod(trace, policy: Policy, device="cuda") -> int:
    """Max POD of one trace under ``policy`` (-1 if nothing is served):
    one :func:`pod_distances` pass."""
    return pod_distances(trace.addr, trace.is_write, policy, device).max


def urd(trace, device="cuda") -> int:
    """Max URD of one trace (-1 if no read is re-referenced)."""
    return urd_distances(trace.addr, trace.is_write, device).max


def trd(trace, device="cuda") -> int:
    """Max TRD of one trace (-1 if nothing is re-accessed)."""
    return trd_distances(trace.addr, trace.is_write, device).max


def demand_blocks(metric_value: int) -> int:
    """Cache size (blocks) implied by a max reuse distance (POD + 1)."""
    return int(metric_value) + 1 if metric_value >= 0 else 0


def hit_counts_at_sizes(dist, served, sizes) -> np.ndarray:
    """hits[s] = #served accesses with dist < sizes[s] (LRU inclusion)."""
    d = np.where(np.asarray(served), np.asarray(dist), np.int32(2**30))
    return np.sum(d[None, :] < np.asarray(sizes)[:, None], axis=1,
                  dtype=np.int64)


def hit_counts_at_sizes_weighted(dist, served, sizes, weights) -> np.ndarray:
    """:func:`hit_counts_at_sizes` with per-request sizing weights (the
    classified controllers: each request adds its IO class's weight, not
    1). Host float64 in the reference's order of operations, so curves
    with non-dyadic weights equal the reference's to the last bit; with
    all-one weights the sums are the unweighted counts."""
    d = np.where(np.asarray(served), np.asarray(dist), np.int32(2**30))
    w = np.asarray(weights, np.float64)
    return ((d[None, :] < np.asarray(sizes)[:, None]) * w[None, :]).sum(axis=1)


def mrc(trace, policy: Policy, sizes, device="cuda") -> np.ndarray:
    """Hit-ratio curve H(c) of one trace under ``policy`` at ``sizes``
    (blocks): by LRU stack inclusion a served access hits iff its
    policy-filtered distance is below the size. The ratio is over all
    requests, so curves compare across policies. One
    :func:`pod_distances` pass; the counts are numpy float64."""
    r = pod_distances(trace.addr, trace.is_write, policy, device)
    hits = hit_counts_at_sizes(r.dist, r.served, np.asarray(sizes, np.int32))
    return np.asarray(hits, dtype=np.float64) / max(len(trace), 1)


# ---------------------------------------------------------------------------
# batched sizing reductions (the one-level baselines' metrics, §2.1)
# ---------------------------------------------------------------------------
#
#   kind               demand (blocks)              hit-curve channel
#   "urd"              max URD + 1                  URD (WB dist, read re-refs)
#   "trd"              max TRD + 1                  TRD (WB dist, all re-refs)
#   "wss"              distinct blocks touched      TRD
#   "reuse_intensity"  re-referenced read blocks    POD(RO)

SIZING_KINDS = ("urd", "trd", "wss", "reuse_intensity")

_SERVED_BIG = 2**30   # not-served sentinel of the hit counts


def read_count(is_write: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """``[V]`` int32: reads among the first ``n_valid[v]`` requests of
    each ``[V, N]`` row (the ECI-style policy choosers' read ratio)."""
    col = torch.arange(is_write.shape[1], device=is_write.device)
    return (~is_write & (col[None, :] < n_valid[:, None])).sum(
        dim=1, dtype=torch.int32)


def sizing_policy(kind: str) -> tuple[Policy, bool]:
    """The (policy, sizing_reads_only) decomposition a sizing kind rides."""
    if kind == "reuse_intensity":
        return Policy.RO, True
    return Policy.WB, False


def sizing_from_dists(addr, is_write, dist, served, n_valid, grid, kind: str):
    """``(demand[V], hits[V, G])`` int32 from the :func:`sizing_policy`
    decomposition of ``[V, N]`` rows padded as :func:`_pad_rows` pads
    them; ``grid`` is an ascending int32 ``[G]`` tensor of cache sizes.
    ``n_valid`` masks the pad tail out of the WSS distinct count (the
    other reductions are pad-invariant: pads are cold writes to fresh
    addresses)."""
    is_read = ~is_write
    if kind == "urd":
        served = served & is_read
    d = torch.where(served, dist, _SERVED_BIG)
    hits = torch.searchsorted(
        torch.sort(d, dim=1).values,
        grid[None, :].expand(d.shape[0], -1).contiguous()).to(torch.int32)
    n = addr.shape[1]
    if kind == "wss":
        col = torch.arange(n, device=addr.device)
        first = _prev_same(addr, torch.ones_like(is_write)) < 0
        demand = (first & (col[None, :] < n_valid[:, None])).sum(
            dim=1, dtype=torch.int32)
    elif kind == "reuse_intensity":
        demand = (is_read & (_prev_same(addr, is_read) < 0)
                  & (_next_same(addr, is_read) < n)).sum(
                      dim=1, dtype=torch.int32)
    else:
        demand = (torch.where(served, dist, COLD).max(dim=1).values
                  + 1).clamp(min=0)
    return demand, hits


def _to(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _sizing_reduce(a, w, nvec, grid, kind: str) -> torch.Tensor:
    """``[L, 2 + G]`` int32 rows ``(demand, reads, hits...)`` of the
    :func:`sizing_policy` decomposition of ``[L, b]`` padded rows."""
    policy, reads_only = sizing_policy(kind)
    dist, served, _ = decompose(a, w, policy, sizing_reads_only=reads_only)
    d, h = sizing_from_dists(a, w, dist, served, nvec, grid, kind)
    return torch.cat([d[:, None], read_count(w, nvec)[:, None], h], dim=1)


def sizing_metrics_batch(addrs, writes, kind: str, grid, device="cuda",
                         mesh=None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One sizing metric for every VM sub-trace in one batched pass.

    ``addrs``/``writes`` are ragged per-VM request arrays (empty rows
    allowed); ``grid`` the ascending candidate sizes (blocks). Returns
    int64 ``(demands[V], hit_counts[V, G], read_counts[V])``, zero rows
    for empty traces — the live rows are decomposed and reduced on
    ``device`` and copied to the host once. The decomposition runs
    ``count_between`` on the card, so this is also the port of the JAX
    package's kernel-backed twin
    (``repro.kernels.reuse_distance.ops.sizing_metrics_batch``). With
    ``mesh`` every row (empty ones as pure-pad rows, which reduce to
    zeros) is reduced on its shard's device, one pass a shard."""
    if kind not in SIZING_KINDS:
        raise ValueError(f"kind must be one of {SIZING_KINDS}, got {kind!r}")
    lens = [int(np.shape(a)[0]) for a in addrs]
    grid = np.asarray(grid, np.int32)
    demands = np.zeros(len(lens), np.int64)
    hits = np.zeros((len(lens), grid.size), np.int64)
    reads = np.zeros(len(lens), np.int64)
    live = [v for v, n in enumerate(lens) if n > 0]
    if not live:
        return demands, hits, reads
    if mesh is not None:
        live = list(range(len(lens)))
        amat, wmat = _pad_rows(addrs, writes, live, lens)
        nvec = np.asarray(lens, np.int32)
        parts = []
        for dev, rows in device_row_blocks(len(lens), mesh):
            with on_device(dev):
                parts.append(_sizing_reduce(*(
                    _to(x, dev) for x in (amat[rows], wmat[rows],
                                          nvec[rows], grid)), kind))
        out = _host_cat(parts).astype(np.int64)
    else:
        dev = resolve_device(device)
        amat, wmat = _pad_rows(addrs, writes, live, lens)
        nvec = np.asarray([lens[v] for v in live], np.int32)
        out = _sizing_reduce(*(_to(x, dev) for x in (amat, wmat, nvec,
                                                     grid)),
                             kind).cpu().numpy().astype(np.int64)
    demands[live], reads[live], hits[live] = out[:, 0], out[:, 1], out[:, 2:]
    return demands, hits, reads


@dataclasses.dataclass(frozen=True)
class SizingMetric:
    """A baseline sizing metric in batched and sequential forms: one of
    :data:`SIZING_KINDS` over its own MRC size grid (blocks), and ``ref``,
    the per-VM closure ``sub -> (demand, grid, curve)`` that the
    sequential chassis (``batched=False``) runs, bit-identically."""

    kind: str
    grid: np.ndarray = dataclasses.field(compare=False)
    ref: Callable = dataclasses.field(compare=False)

    def batch(self, addrs: list[np.ndarray], writes: list[np.ndarray],
              device="cuda", mesh=None):
        """``(demands[V], grid[G], curves[V, G], reads[V])`` for all VMs:
        curves are hit counts over each VM's request count, ``reads``
        the per-VM read counts the policy choosers take; empty VMs give
        zero rows. ``mesh`` splits the rows over its devices."""
        demands, hits, reads = sizing_metrics_batch(
            addrs, writes, self.kind, self.grid, device, mesh)
        ns = np.array([max(np.shape(a)[0], 1) for a in addrs], np.float64)
        return demands, self.grid, hits.astype(np.float64) / ns[:, None], \
            reads
