"""``count_between``: the kernel's wrapper and its plain PyTorch version.

For ``[V, N]`` rows (``prev``/``nt`` int32, ``touch`` bool)::

    count[v, i] = #{ j : prev[v, i] < j < i, touch[v, j], nt[v, j] >= i }

the number of distinct blocks touched between an access and the
previous touch of its block (each qualifying j is the last touch of its
address before i). CUDA tensors go through the ``count_between`` kernel
(``csrc/count_between.cu``: a group of lanes a row, planned by
:func:`count_plan`); CPU tensors through :func:`count_between_plain`.
Counts are int32 and exact either way.

:func:`reuse_distances` and :func:`sizing_reduction` are the
reference's one-trace entry points over that count (the port of
``repro.kernels.reuse_distance.ops``): the POD / URD / TRD distances of
one trace, and one sizing metric's reduction of them, both from
:func:`repro_torch.core.reuse.decompose` on a ``[1, N]`` row, so the
distance channel goes through ``count_between`` on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels

_PLAIN_ELEMS = 1 << 24   # pair-mask elements per plain-version chunk
COUNT_THREADS = 256      # threads a CTA, at most (csrc kThreads)
COUNT_MAX_ROWS = 256     # rows a CTA, at most (csrc kMaxRows)
COUNT_WAVE = 1024        # threads an SM that the rows' lanes may fill


def count_plan(v: int, n: int, sms: int) -> tuple[int, int, int]:
    """``(lanes, rows, threads)`` of a ``count_between`` launch, from
    shapes alone. ``lanes`` a row: 32 for rows of more than 512 columns,
    16 up to 512, 8 up to 256, so that a window takes few rounds (4
    columns a lane a round); halved, down to 8, while the rows' lanes
    would overfill ``COUNT_WAVE`` threads an SM, since then each row's
    fixed cost (its sum across the lanes) outweighs its rounds. ``rows``
    consecutive rows a CTA: a power of two, about two CTAs an SM, at most
    ``COUNT_MAX_ROWS`` and the row's length, at least four warps' worth.
    ``threads`` a CTA: a lane for every (row, lane) pair, at most
    ``COUNT_THREADS``, the rest of the rows taken in turn."""
    lanes = 32 if n > 512 else 16 if n > 256 else 8
    while lanes > 8 and v * n * lanes > sms * COUNT_WAVE:
        lanes //= 2
    fill = max(1, v * n // (2 * max(sms, 1)))
    rows = min(COUNT_MAX_ROWS, 1 << (fill.bit_length() - 1),
               1 << max(n - 1, 0).bit_length())
    rows = max(128 // lanes, rows)
    return lanes, rows, min(COUNT_THREADS, rows * lanes)


def count_between(prev: torch.Tensor, touch: torch.Tensor,
                  nt: torch.Tensor) -> torch.Tensor:
    if prev.device.type == "cpu":
        return count_between_plain(prev, touch, nt)
    dev = prev.device
    v, n = prev.shape
    kernels.check(prev, "prev", torch.int32, (v, n), dev)
    kernels.check(touch, "touch", torch.bool, (v, n), dev)
    kernels.check(nt, "nt", torch.int32, (v, n), dev)
    out = torch.empty((v, n), dtype=torch.int32, device=dev)
    if v and n:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ptrs = [x.data_ptr() for x in (prev, touch, nt, out)]
        kernels.launch("count_between", *ptrs, v, n,
                       *count_plan(v, n, sms))
    return out


def count_between_plain(prev: torch.Tensor, touch: torch.Tensor,
                        nt: torch.Tensor) -> torch.Tensor:
    """The pairwise definition, evaluated in row blocks of the ``[V, i,
    j]`` mask so memory stays bounded."""
    v, n = prev.shape
    dev = prev.device
    j = torch.arange(n, dtype=torch.int32, device=dev)
    out = torch.empty((v, n), dtype=torch.int32, device=dev)
    rows = max(1, _PLAIN_ELEMS // max(v * n, 1))
    tj = touch[:, None, :]
    ntj = nt[:, None, :]
    for lo in range(0, n, rows):
        i = j[lo:lo + rows]
        p = prev[:, lo:lo + rows]
        m = ((j[None, None, :] > p[:, :, None])
             & (j[None, None, :] < i[None, :, None])
             & tj & (ntj >= i[None, :, None]))
        out[:, lo:lo + rows] = m.sum(dim=2, dtype=torch.int32)
    return out


def reuse_distances(addr, is_write, policy, *, sizing_reads_only: bool = True,
                    device="cuda"):
    """The policy-filtered reuse distances of one trace as a
    :class:`repro_torch.core.reuse.DistResult` of ``[N]`` tensors on
    ``device``: ``dist`` (int32, ``COLD`` where not served), ``served``
    and ``touch``. ``sizing_reads_only=False`` widens the served set to
    write re-references too (the TRD convention)."""
    from repro_torch.core.reuse import DistResult, decompose
    from repro_torch.kernels import resolve_device, upload
    dev = resolve_device(device)
    a = upload(np.asarray(addr, np.int32)[None], dev)
    w = upload(np.asarray(is_write, bool)[None], dev)
    dist, served, touch = decompose(a, w, policy,
                                    sizing_reads_only=sizing_reads_only)
    return DistResult(dist[0], served[0], touch[0])


def sizing_reduction(addr, is_write, kind: str, grid, *, n_valid=None,
                     with_reads: bool = False, device="cuda"):
    """``(demand, hit_counts[G])`` int32 tensors on ``device`` for one
    trace (with ``with_reads`` also its read count): the
    :func:`~repro_torch.core.reuse.sizing_policy` decomposition of the
    trace reduced by :func:`~repro_torch.core.reuse.sizing_from_dists`,
    the batched sizing path's own code. ``kind`` is one of
    ``SIZING_KINDS``; ``n_valid`` (default: the trace's length) masks a
    pad tail out of the WSS distinct count when the caller hands in a
    bucket-padded row."""
    from repro_torch.core import reuse
    from repro_torch.kernels import resolve_device, upload
    if kind not in reuse.SIZING_KINDS:
        raise ValueError(
            f"kind must be one of {reuse.SIZING_KINDS}, got {kind!r}")
    dev = resolve_device(device)
    a = upload(np.asarray(addr, np.int32)[None], dev)
    w = upload(np.asarray(is_write, bool)[None], dev)
    g = upload(np.asarray(grid, np.int32), dev)
    nv = torch.tensor([a.shape[1] if n_valid is None else int(n_valid)],
                      dtype=torch.int32, device=dev)
    policy, reads_only = reuse.sizing_policy(kind)
    dist, served, _ = reuse.decompose(a, w, policy,
                                      sizing_reads_only=reads_only)
    demand, hits = reuse.sizing_from_dists(a, w, dist, served, nv, g, kind)
    if with_reads:
        return demand[0], hits[0], reuse.read_count(w, nv)[0]
    return demand[0], hits[0]
