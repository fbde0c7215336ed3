"""Resize windows and ``[V, chunk]`` request blocks for the controller.

The in-memory half of :mod:`repro.traces.stream`: an in-memory
:class:`~repro_torch.core.trace.Trace` is cut into resize windows, each
demuxed per VM with one stable sort (:func:`split_by_vm`), and each
window into rectangular ``[V, chunk]`` blocks padded with ``addr = -1``
no-ops (:func:`pad_batch`).

:meth:`StreamWindow.blocks` keeps ``prefetch_depth`` blocks in flight
beyond the one being consumed. On the card each block is built in a
pinned host buffer and copied with ``non_blocking=True`` on the current
stream, so the copy of block k+1 overlaps the simulation of block k;
PyTorch's pinned-memory allocator keeps a buffer alive until its copy
has run. Depth 0 copies each block when it is consumed. Results are
identical at every depth.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.trace import Trace, pad_batch, split_by_vm


@dataclasses.dataclass
class StreamWindow:
    """One resize window: per-VM sub-traces + padded datapath blocks."""

    index: int                  # window ordinal
    subs: list[Trace]           # per-VM demux (sizing / maintenance)
    chunk: int                  # datapath block width
    device: torch.device
    prefetch_depth: int = 2     # blocks in flight beyond the consumed one

    def chunk_lists(self) -> list[list[Trace]]:
        return [list(sub.intervals(self.chunk)) for sub in self.subs]

    def blocks(self) -> Iterator[tuple]:
        """Yield ``(addr [V, chunk], is_write [V, chunk], lens [V], kth)``
        with the tensors on the device; ``lens[v]`` is VM v's request
        count in the block and ``kth`` the ragged per-VM chunk list
        (``None`` where a VM has no k-th chunk)."""
        lists = self.chunk_lists()
        n_chunks = max(map(len, lists), default=0)

        def block(k: int):
            kth = [c[k] if k < len(c) else None for c in lists]
            a, w = pad_batch(kth, self.chunk)
            lens = np.array([0 if c is None else len(c) for c in kth],
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
        if self.device.type != "cuda" or self.prefetch_depth <= 0:
            return tuple(torch.from_numpy(x).to(self.device) for x in arrays)
        return tuple(torch.from_numpy(x).pin_memory().to(
            self.device, non_blocking=True) for x in arrays)


@dataclasses.dataclass
class StreamingTraceSource:
    """Resize-window iterator over an in-memory multi-VM ``Trace``."""

    source: Trace
    num_vms: int
    window: int
    chunk: int
    device: torch.device
    prefetch_depth: int = 2     # 0 copies each block when consumed

    def windows(self) -> Iterator[StreamWindow]:
        yield from self._windows_from_trace(self.source)

    def _windows_from_trace(self, trace: Trace) -> Iterator[StreamWindow]:
        for i, window in enumerate(trace.intervals(self.window)):
            yield StreamWindow(i, split_by_vm(window, self.num_vms),
                               self.chunk, self.device, self.prefetch_depth)


def window_source(trace, num_vms: int, window: int, chunk: int,
                  device: torch.device,
                  prefetch_depth: int = 2) -> StreamingTraceSource:
    """The window source for ``run``'s input: an in-memory ``Trace``.
    On-disk ``TraceStore`` and pre-built streaming inputs are not ported
    yet and raise."""
    if not isinstance(trace, Trace):
        raise NotImplementedError(
            f"{type(trace).__name__} input is not ported yet: pass an "
            "in-memory repro_torch.core.trace.Trace")
    return StreamingTraceSource(trace, num_vms, window, chunk, device,
                                prefetch_depth)
