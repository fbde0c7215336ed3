"""Block-I/O trace representation.

A trace is a pair of equal-length numpy arrays: block addresses and a
write flag. Multi-VM traces additionally carry a ``vm`` id per request.
Traces stay on the host; the controllers demux them per VM and move
rectangular ``[V, chunk]`` blocks to the device
(:mod:`repro_torch.traces.stream`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Trace:
    addr: np.ndarray        # int32 [N] block addresses
    is_write: np.ndarray    # bool  [N]
    vm: np.ndarray | None = None  # int32 [N] (optional)
    size: np.ndarray | None = None  # int32 [N] request size in blocks
                                    # (optional; absent means 1 block each)

    # -- conveniences ------------------------------------------------------
    def __len__(self) -> int:
        return int(np.shape(self.addr)[0])

    def __getitem__(self, sl) -> "Trace":
        return Trace(
            addr=self.addr[sl],
            is_write=self.is_write[sl],
            vm=None if self.vm is None else self.vm[sl],
            size=None if self.size is None else self.size[sl],
        )

    @property
    def n_reads(self) -> int:
        return int(np.sum(~np.asarray(self.is_write)))

    @property
    def n_writes(self) -> int:
        return int(np.sum(np.asarray(self.is_write)))

    def sizes(self) -> np.ndarray:
        """Request sizes in blocks; all-ones when no size channel."""
        if self.size is None:
            return np.ones(len(self), np.int32)
        return np.asarray(self.size, np.int32)

    def for_vm(self, vm_id: int) -> "Trace":
        """Reference per-VM demux: one boolean-mask scan per VM. The
        controllers use :func:`split_by_vm` (one stable sort for all VMs,
        the same sub-traces); this stays as its oracle."""
        assert self.vm is not None
        m = np.asarray(self.vm) == vm_id
        return Trace(np.asarray(self.addr)[m], np.asarray(self.is_write)[m],
                     size=None if self.size is None
                     else np.asarray(self.size)[m])

    def intervals(self, interval: int) -> Iterator["Trace"]:
        """Yield consecutive fixed-size request windows (paper: 10k reqs)."""
        for start in range(0, len(self), interval):
            yield self[start : start + interval]

    @staticmethod
    def concat(traces: list["Trace"]) -> "Trace":
        """The traces one after another; ``vm`` is kept when every trace
        has it, ``size`` when any has it (all-ones for those without)."""
        vm = None
        if all(t.vm is not None for t in traces):
            vm = np.concatenate([np.asarray(t.vm) for t in traces])
        size = None
        if any(t.size is not None for t in traces):
            size = np.concatenate([t.sizes() for t in traces])
        return Trace(
            addr=np.concatenate([np.asarray(t.addr) for t in traces]),
            is_write=np.concatenate([np.asarray(t.is_write) for t in traces]),
            vm=vm,
            size=size,
        )

    @staticmethod
    def from_ops(ops: list[tuple[str, int]]) -> "Trace":
        """Build a trace from [('R', sector), ('W', sector), ...] tuples.

        Used by the unit tests to transcribe the paper's worked examples
        (Figs. 5, 8, 9) verbatim.
        """
        addr = np.array([a for _, a in ops], dtype=np.int32)
        is_write = np.array([op.upper() == "W" for op, _ in ops], dtype=bool)
        return Trace(addr=addr, is_write=is_write)


def split_by_vm(window: Trace, num_vms: int) -> list[Trace]:
    """Demux a multi-VM window into per-VM sub-traces with ONE stable sort.

    ``np.argsort(vm, kind="stable")`` groups requests by VM while
    preserving each VM's arrival order (O(N log N), no per-VM mask
    scan). Windows without a ``vm`` channel keep the
    single-trace-shared-by-all-VMs convention the controllers use.
    """
    if window.vm is None:
        return [window] * num_vms
    vm = np.asarray(window.vm)
    order = np.argsort(vm, kind="stable")
    addr = np.asarray(window.addr)[order]
    is_write = np.asarray(window.is_write)[order]
    size = None if window.size is None else np.asarray(window.size)[order]
    bounds = np.searchsorted(vm[order], np.arange(num_vms + 1))
    return [Trace(addr[bounds[v]:bounds[v + 1]],
                  is_write[bounds[v]:bounds[v + 1]],
                  size=None if size is None
                  else size[bounds[v]:bounds[v + 1]])
            for v in range(num_vms)]


def pad_batch(chunks: list[Trace | None], n: int):
    """Stack per-VM request chunks into rectangular ``[V, n]`` arrays,
    padding ragged tails (and VMs with no chunk) with ``addr = -1``
    no-ops — the shape contract of the batched datapath simulators."""
    v = len(chunks)
    addr = np.full((v, n), -1, np.int32)
    is_write = np.zeros((v, n), bool)
    for i, c in enumerate(chunks):
        if c is None or len(c) == 0:
            continue
        k = min(len(c), n)
        addr[i, :k] = np.asarray(c.addr, np.int32)[:k]
        is_write[i, :k] = np.asarray(c.is_write)[:k]
    return addr, is_write


def interleave(traces: list[Trace], seed: int = 0) -> Trace:
    """Randomly interleave per-VM traces into one multi-VM trace,
    preserving each VM's internal request order (hypervisor arrival order).
    """
    rng = np.random.default_rng(seed)
    lengths = [len(t) for t in traces]
    vm_stream = np.repeat(np.arange(len(traces)), lengths)
    rng.shuffle(vm_stream)
    cursors = [0] * len(traces)
    has_size = any(t.size is not None for t in traces)
    sizes = [t.sizes() for t in traces] if has_size else None
    addr = np.empty(sum(lengths), dtype=np.int32)
    is_write = np.empty(sum(lengths), dtype=bool)
    size = np.empty(sum(lengths), dtype=np.int32) if has_size else None
    for i, v in enumerate(vm_stream):
        t = traces[v]
        addr[i] = t.addr[cursors[v]]
        is_write[i] = t.is_write[cursors[v]]
        if has_size:
            size[i] = sizes[v][cursors[v]]
        cursors[v] += 1
    return Trace(addr=addr, is_write=is_write, vm=vm_stream.astype(np.int32),
                 size=size)
