"""Streaming ``[V, chunk]`` request-block ingestion for the controllers.

The batched controllers consume multi-VM traces as a sequence of resize
windows, each demuxed per VM and simulated in rectangular ``[V, chunk]``
blocks (``addr = -1`` padded). The paper evaluates on million-request
traces (§5.1) that need not fit in host memory, so this module takes
its windows from either kind of source:

* :class:`StreamingTraceSource` — iterates resize windows from an
  on-disk :class:`~repro_torch.traces.store.TraceStore` (or an
  in-memory ``Trace``) and performs the per-VM demux with **one stable
  sort per shard** (``np.argsort(vm, kind="stable")`` groups requests by
  VM while preserving per-VM arrival order), serving each window's
  per-VM sub-traces by binary-searching the sorted global-index
  segments. Only the shards overlapping the current window are
  resident, so peak host memory is O(shard + window + V·chunk) —
  independent of trace length. The demux copies what it keeps out of
  the shards' read-only memory maps. VM ids at or above ``num_vms`` are
  dropped, as :func:`~repro_torch.core.trace.split_by_vm` drops them.

* **Depth-``d`` host→device prefetch** — :meth:`StreamWindow.blocks`
  keeps ``prefetch_depth`` blocks in flight beyond the one being
  consumed. On the card each block is built in a pinned host buffer and
  copied with ``non_blocking=True`` on the current stream, so the copy
  of block k+1 overlaps the simulation of block k; PyTorch's
  pinned-memory allocator keeps a buffer alive until its copy has run.
  Depth 0 (or ``prefetch=False`` on the source) copies each block when
  it is consumed. Results are identical at every depth.

* **Sharded feeding** — with ``sharding`` (a
  :class:`~repro_torch.launch.mesh.VMMesh`) each block is split into its
  per-shard ``[V / d, chunk]`` row blocks, each copied straight to its
  shard's device (pinned and ``non_blocking`` on the card when
  prefetching), and ``pad_vms`` appends that many dead VM rows (all
  ``addr = -1``, ``lens`` 0: exact no-ops) so that the row count
  divides the mesh size. The per-VM chunk lists the maintenance takes
  hold the real VMs only.

Both controllers accept a ``Trace``, a ``TraceStore`` or a pre-built
``StreamingTraceSource`` in ``run`` and produce bit-identical results for
all three: the demux equals :func:`~repro_torch.core.trace.split_by_vm`
on the materialised window and padding and chunking are shared with the
in-memory path (:func:`~repro_torch.core.trace.pad_batch`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.trace import Trace, pad_batch, split_by_vm
from repro_torch.launch.mesh import VMMesh, device_row_blocks, on_device

from .store import TraceStore


@dataclasses.dataclass
class StreamWindow:
    """One resize window: per-VM sub-traces + padded datapath blocks."""

    index: int                  # window ordinal
    subs: list[Trace]           # per-VM demux (sizing / maintenance)
    chunk: int                  # datapath block width
    prefetch_depth: int = 2     # blocks in flight beyond the consumed one
    device: torch.device | None = None  # where blocks go (None: the CPU)
    pad_vms: int = 0            # dead VM rows appended to each block
    sharding: VMMesh | None = None  # split each block's rows over a mesh

    def chunk_lists(self) -> list[list[Trace]]:
        return [list(sub.intervals(self.chunk)) for sub in self.subs]

    def blocks(self) -> Iterator[tuple]:
        """Yield ``(addr [V, chunk], is_write [V, chunk], lens [V], kth)``
        with the tensors on the device; ``lens[v]`` is VM v's request
        count in the block and ``kth`` the ragged per-VM chunk list of
        the real VMs (``None`` where a VM has no k-th chunk). ``V``
        counts the ``pad_vms`` dead rows; with ``sharding`` each of the
        three tensors is a list, one ``[V / d, ...]`` row block a shard
        on its shard's device."""
        lists = self.chunk_lists()
        n_chunks = max(map(len, lists), default=0)
        pad = [None] * self.pad_vms

        def block(k: int):
            kth = [c[k] if k < len(c) else None for c in lists]
            a, w = pad_batch(kth + pad, self.chunk)
            lens = np.array([0 if c is None else len(c) for c in kth + pad],
                            np.int32)
            return self._put(a, w, lens), kth

        if self.prefetch_depth <= 0:
            for k in range(n_chunks):
                tensors, kth = block(k)
                yield (*tensors, kth)
            return
        pending: deque = deque()
        for k in range(min(self.prefetch_depth, n_chunks)):
            pending.append(block(k))
        k = len(pending)
        while pending:
            tensors, kth = pending.popleft()
            if k < n_chunks:        # start the next copy before the
                pending.append(block(k))  # consumer launches this block
                k += 1
            yield (*tensors, kth)

    def _put(self, *arrays: np.ndarray) -> tuple:
        if self.sharding is not None:
            blocks = device_row_blocks(arrays[0].shape[0], self.sharding)
            return tuple([self._copy(x[rows], dev) for dev, rows in blocks]
                         for x in arrays)
        dev = torch.device("cpu" if self.device is None else self.device)
        return tuple(self._copy(x, dev) for x in arrays)

    def _copy(self, x: np.ndarray, dev: torch.device) -> torch.Tensor:
        if dev.type != "cuda" or self.prefetch_depth <= 0:
            return torch.from_numpy(x).to(dev)
        with on_device(dev):
            return torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)


@dataclasses.dataclass
class _DemuxedShard:
    """One shard after its single stable sort: requests grouped by VM
    (arrival order preserved within each VM), with global indices."""

    base: int                   # global index of the shard's first request
    length: int
    addr: np.ndarray            # [n] sorted by (vm, arrival)
    is_write: np.ndarray        # [n]
    gidx: np.ndarray            # [n] ascending global index per VM segment
    bounds: np.ndarray          # [num_vms + 1] VM segment boundaries
    size: np.ndarray | None = None  # [n] request sizes (sized stores only)

    @classmethod
    def demux(cls, shard: Trace, base: int, num_vms: int) -> "_DemuxedShard":
        vm = np.asarray(shard.vm)
        order = np.argsort(vm, kind="stable")
        bounds = np.searchsorted(vm[order], np.arange(num_vms + 1))
        return cls(base=base, length=len(shard),
                   addr=np.asarray(shard.addr, np.int32)[order],
                   is_write=np.asarray(shard.is_write, bool)[order],
                   gidx=(base + order).astype(np.int64), bounds=bounds,
                   size=(None if shard.size is None
                         else np.asarray(shard.size, np.int32)[order]))

    def vm_part(self, v: int, start: int, stop: int):
        """This shard's (addr, is_write, size) for VM ``v`` restricted to
        global request range ``[start, stop)`` — a binary search, no
        scan. ``size`` is ``None`` for size-less stores."""
        lo, hi = int(self.bounds[v]), int(self.bounds[v + 1])
        g = self.gidx[lo:hi]
        a = int(np.searchsorted(g, start))
        b = int(np.searchsorted(g, stop))
        return (self.addr[lo + a: lo + b], self.is_write[lo + a: lo + b],
                None if self.size is None else self.size[lo + a: lo + b])


@dataclasses.dataclass
class StreamingTraceSource:
    """Resize-window iterator over a ``TraceStore`` or in-memory ``Trace``.

    Yields :class:`StreamWindow`\\ s whose per-VM sub-traces are
    bit-identical to ``split_by_vm(trace[s:e], num_vms)`` on the
    materialised trace. ``window`` is the controller's resize interval,
    ``chunk`` its datapath block width, ``device`` where the blocks go
    (``None``: the CPU; :func:`window_source` sets the controller's).
    """

    source: "TraceStore | Trace"
    num_vms: int
    window: int
    chunk: int
    prefetch: bool = True       # master switch (False: copy when consumed)
    prefetch_depth: int = 2     # pipeline depth when prefetch is on
    device: torch.device | None = None
    pad_vms: int = 0            # dead VM rows appended to datapath blocks
    sharding: VMMesh | None = None  # per-shard block placement

    @property
    def depth(self) -> int:
        return self.prefetch_depth if self.prefetch else 0

    def _window(self, i: int, subs: list[Trace]) -> StreamWindow:
        return StreamWindow(i, subs, self.chunk, self.depth, self.device,
                            self.pad_vms, self.sharding)

    def windows(self) -> Iterator[StreamWindow]:
        if isinstance(self.source, Trace):
            yield from self._windows_from_trace(self.source)
        elif self.source.has_vm:
            yield from self._windows_from_store(self.source)
        else:
            yield from self._windows_from_vmless_store(self.source)

    # -- in-memory ---------------------------------------------------------
    def _windows_from_trace(self, trace: Trace) -> Iterator[StreamWindow]:
        for i, window in enumerate(trace.intervals(self.window)):
            yield self._window(i, split_by_vm(window, self.num_vms))

    # -- on-disk, vm channel ----------------------------------------------
    def _windows_from_store(self, store: TraceStore) -> Iterator[StreamWindow]:
        total = len(store)
        active: deque[_DemuxedShard] = deque()
        shard_idx, loaded = 0, 0
        sized = store.has_size
        empty = (np.empty(0, np.int32), np.empty(0, bool),
                 np.empty(0, np.int32) if sized else None)
        for i, ws in enumerate(range(0, total, self.window)):
            we = min(ws + self.window, total)
            while loaded < we:            # one stable sort per shard, once
                sh = store.shard(shard_idx)
                active.append(_DemuxedShard.demux(sh, loaded, self.num_vms))
                loaded += len(sh)
                shard_idx += 1
            while active and active[0].base + active[0].length <= ws:
                active.popleft()          # shard fully behind this window
            subs = []
            for v in range(self.num_vms):
                parts = [d.vm_part(v, ws, we) for d in active]
                parts = [p for p in parts if p[0].size]
                if not parts:
                    subs.append(Trace(empty[0], empty[1], size=empty[2]))
                elif len(parts) == 1:
                    subs.append(Trace(parts[0][0], parts[0][1],
                                      size=parts[0][2]))
                else:
                    subs.append(Trace(
                        np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        size=(np.concatenate([p[2] for p in parts])
                              if sized else None)))
            yield self._window(i, subs)

    # -- on-disk, no vm channel (single-stream convention) -----------------
    def _windows_from_vmless_store(self, store) -> Iterator[StreamWindow]:
        # mirrors the controllers' Trace(vm=None) convention: every VM
        # sees the whole window
        for i, window in enumerate(store.iter_windows(self.window)):
            yield self._window(i, [window] * self.num_vms)


def window_source(trace, num_vms: int, window: int, chunk: int,
                  prefetch: bool = True, prefetch_depth: int = 2,
                  device: torch.device | None = None, pad_vms: int = 0,
                  sharding: VMMesh | None = None) -> StreamingTraceSource:
    """Normalise any accepted trace input into a StreamingTraceSource.

    ``trace`` may be an in-memory :class:`Trace`, an on-disk
    :class:`TraceStore`, or an existing :class:`StreamingTraceSource`
    (re-parameterised to the controller's intervals, prefetch, device
    and mesh). Anything else raises ``TypeError``, the JAX package's
    ``Trace`` and ``TraceStore`` included."""
    if isinstance(trace, StreamingTraceSource):
        return dataclasses.replace(trace, num_vms=num_vms, window=window,
                                   chunk=chunk, prefetch=prefetch,
                                   prefetch_depth=prefetch_depth,
                                   device=device, pad_vms=pad_vms,
                                   sharding=sharding)
    if not isinstance(trace, (Trace, TraceStore)):
        raise TypeError(f"expected Trace, TraceStore or "
                        f"StreamingTraceSource, got {type(trace).__name__}")
    return StreamingTraceSource(trace, num_vms, window, chunk, prefetch,
                                prefetch_depth, device, pad_vms, sharding)
