"""Chunked, columnar, on-disk trace store.

ETICA is evaluated on multi-million-request MSR Cambridge and
FIO/Filebench traces (§5.1); holding such traces as one in-memory
:class:`~repro_torch.core.trace.Trace` is the scalability wall this
module removes. A :class:`TraceStore` is a directory of fixed-size
**shards**, one column file per channel:

    store/
      meta.json                  # version, shard_size, per-shard lengths,
                                 # total length, num_vms
      shard_00000.addr.npy       # int32  [n]  block addresses
      shard_00000.w.npy          # bool   [n]  write flags
      shard_00000.vm.npy         # int32  [n]  vm ids (multi-VM stores only)
      shard_00000.sz.npy         # int32  [n]  request sizes in blocks
                                 #             (sized stores only)
      shard_00001.addr.npy
      ...

The format is that of :mod:`repro.traces.store` byte for byte (the
same ``meta.json`` keys and layout, file names and dtypes), so a store
written by either package opens in the other. This module is numpy
only, like the reference.

Shards are plain ``.npy`` files opened with ``np.load(mmap_mode="r")``,
so iterating a store touches one shard of host memory at a time no
matter how long the trace is. The arrays of :meth:`TraceStore.shard`
are read-only mappings; the controllers' window source copies what it
keeps (:mod:`repro_torch.traces.stream`), and the simulators copy a
read-only array before it becomes a tensor. Appends are buffered and
flushed one full shard at a time; ``flush()``/``close()`` persist a
partial tail shard and the metadata, and re-opening with ``mode="a"``
re-absorbs that tail so appends can resume.

Ingestion paths:

  * :meth:`TraceStore.from_trace` — deterministic conversion of any
    in-memory :class:`Trace` (exact round-trip);
  * :func:`parse_msr_csv` / :meth:`TraceStore.from_msr_csv` —
    MSR-Cambridge-style CSV
    (``Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime``);
  * :func:`parse_blktrace` / :meth:`TraceStore.from_blktrace` —
    blktrace/blkparse text logs (the format FIO's ``blktrace`` backend
    and ``blkparse`` emit).

Both parsers stream their input line-by-line and yield bounded
chunk-:class:`Trace`\\ s, so importing a 100M-request trace never holds
more than one chunk in memory. A small CLI covers the common ops::

    PYTHONPATH=src python -m repro_torch.traces.store import --format msr \\
        trace.csv store_dir
    PYTHONPATH=src python -m repro_torch.traces.store info store_dir

Consumption at bounded memory is the job of
:class:`repro_torch.traces.stream.StreamingTraceSource`, which both
controllers accept directly (``cache.run(store)``).
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core.trace import Trace

META_NAME = "meta.json"
VERSION = 1
DEFAULT_SHARD_SIZE = 1 << 18        # 256k requests (= 3 MiB of columns)
SECTOR = 512                        # blktrace sector size (bytes)
DEFAULT_BLOCK = 4096                # cache block size (bytes), paper §5.1

_COLS = (("addr", np.int32), ("w", np.bool_), ("vm", np.int32))


def _shard_file(path: Path, i: int, col: str) -> Path:
    return path / f"shard_{i:05d}.{col}.npy"


@dataclasses.dataclass
class _Meta:
    shard_size: int
    shards: list[int]               # per-shard lengths
    has_vm: bool
    num_vms: int | None             # max vm id + 1 (None for vm-less stores)
    has_size: bool = False          # optional request-size column (blocks)

    @property
    def total(self) -> int:
        return int(sum(self.shards))


class TraceStore:
    """A chunked on-disk multi-VM block-I/O trace (see module docstring).

    Use :meth:`create` / :meth:`open` rather than the constructor.
    Stores are context managers; writers must :meth:`close` (or exit the
    ``with`` block) to persist the tail shard and metadata.
    """

    def __init__(self, path: Path, meta: _Meta, writable: bool):
        self.path = Path(path)
        self._meta = meta
        self._writable = writable
        self._buf_addr: list[np.ndarray] = []
        self._buf_w: list[np.ndarray] = []
        self._buf_vm: list[np.ndarray] = []
        self._buf_sz: list[np.ndarray] = []
        self._buffered = 0

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, path, shard_size: int = DEFAULT_SHARD_SIZE) -> "TraceStore":
        """Create an empty writable store at ``path`` (dir must not hold a
        store already). Whether the store carries a ``vm`` channel is
        fixed by the first :meth:`append`."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        if (path / META_NAME).exists():
            raise FileExistsError(f"{path} already contains a trace store")
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        return cls(path, _Meta(int(shard_size), [], False, None),
                   writable=True)

    @classmethod
    def open(cls, path, mode: str = "r") -> "TraceStore":
        """Open an existing store: ``"r"`` read-only, ``"a"`` append (a
        partial tail shard is re-absorbed on the first append)."""
        path = Path(path)
        with (path / META_NAME).open() as f:
            raw = json.load(f)
        if raw.get("version") != VERSION:
            raise ValueError(f"unsupported store version {raw.get('version')}")
        meta = _Meta(int(raw["shard_size"]), [int(n) for n in raw["shards"]],
                     bool(raw["has_vm"]),
                     None if raw["num_vms"] is None else int(raw["num_vms"]),
                     bool(raw.get("has_size", False)))
        return cls(path, meta, writable=(mode == "a"))

    def __enter__(self) -> "TraceStore":
        return self

    def __exit__(self, *exc) -> None:
        if self._writable:
            self.close()

    # -- write path --------------------------------------------------------
    def append(self, trace: Trace) -> None:
        """Append a chunk of requests; full shards are flushed to disk
        immediately, so peak memory is O(shard_size) regardless of how
        much is appended."""
        if not self._writable:
            raise PermissionError("store opened read-only")
        n = len(trace)
        if n == 0:
            return
        self._absorb_tail()
        has_vm = trace.vm is not None
        has_size = trace.size is not None
        if self._meta.total == 0 and self._buffered == 0:
            self._meta.has_vm = has_vm
            self._meta.has_size = has_size
        elif has_vm != self._meta.has_vm:
            raise ValueError("cannot mix vm-tagged and vm-less appends")
        elif has_size != self._meta.has_size:
            raise ValueError("cannot mix sized and size-less appends")
        self._buf_addr.append(np.asarray(trace.addr, np.int32))
        self._buf_w.append(np.asarray(trace.is_write, bool))
        if has_size:
            self._buf_sz.append(np.asarray(trace.size, np.int32))
        if has_vm:
            vm = np.asarray(trace.vm, np.int32)
            if vm.size and vm.min() < 0:
                raise ValueError("vm ids must be non-negative")
            self._buf_vm.append(vm)
            hi = int(vm.max()) + 1 if vm.size else 0
            self._meta.num_vms = max(self._meta.num_vms or 0, hi)
        self._buffered += n
        while self._buffered >= self._meta.shard_size:
            self._flush_shard(self._meta.shard_size)

    def _take(self, bufs: list[np.ndarray], k: int) -> np.ndarray:
        out, got = [], 0
        while got < k:
            b = bufs[0]
            take = min(k - got, b.shape[0])
            out.append(b[:take])
            if take == b.shape[0]:
                bufs.pop(0)
            else:
                bufs[0] = b[take:]
            got += take
        return np.concatenate(out) if len(out) != 1 else np.array(out[0])

    def _flush_shard(self, k: int) -> None:
        i = len(self._meta.shards)
        np.save(_shard_file(self.path, i, "addr"),
                self._take(self._buf_addr, k))
        np.save(_shard_file(self.path, i, "w"), self._take(self._buf_w, k))
        if self._meta.has_vm:
            np.save(_shard_file(self.path, i, "vm"),
                    self._take(self._buf_vm, k))
        if self._meta.has_size:
            np.save(_shard_file(self.path, i, "sz"),
                    self._take(self._buf_sz, k))
        self._meta.shards.append(k)
        self._buffered -= k

    def _absorb_tail(self) -> None:
        """Pull a previously flushed partial tail shard back into the
        append buffer so the shard sequence stays [full..., tail]."""
        if (self._buffered == 0 and self._meta.shards
                and self._meta.shards[-1] < self._meta.shard_size):
            tail = self.shard(len(self._meta.shards) - 1)
            self._buf_addr = [np.array(tail.addr, np.int32)]
            self._buf_w = [np.array(tail.is_write, bool)]
            if self._meta.has_vm:
                self._buf_vm = [np.array(tail.vm, np.int32)]
            if self._meta.has_size:
                self._buf_sz = [np.array(tail.size, np.int32)]
            self._buffered = len(tail)
            self._meta.shards.pop()

    def flush(self) -> None:
        """Persist any buffered tail as a (short) final shard + metadata.
        The store remains usable; a later append re-absorbs the tail."""
        if self._buffered:
            self._flush_shard(self._buffered)
        with (self.path / META_NAME).open("w") as f:
            json.dump({"version": VERSION,
                       "shard_size": self._meta.shard_size,
                       "shards": self._meta.shards,
                       "has_vm": self._meta.has_vm,
                       "num_vms": self._meta.num_vms,
                       "has_size": self._meta.has_size,
                       "total": self._meta.total}, f, indent=1)

    def close(self) -> None:
        if self._writable:
            self.flush()
            self._writable = False

    # -- read path ---------------------------------------------------------
    def _check_readable(self) -> None:
        if self._writable and self._buffered:
            raise RuntimeError(
                "store has unflushed appends; call flush() or close() "
                "before reading")

    def __len__(self) -> int:
        return self._meta.total + (self._buffered if self._writable else 0)

    @property
    def num_shards(self) -> int:
        return len(self._meta.shards)

    @property
    def shard_size(self) -> int:
        return self._meta.shard_size

    @property
    def has_vm(self) -> bool:
        return self._meta.has_vm

    @property
    def num_vms(self) -> int | None:
        return self._meta.num_vms

    @property
    def has_size(self) -> bool:
        return self._meta.has_size

    def shard(self, i: int) -> Trace:
        """Shard ``i`` as a Trace of memory-mapped (read-only) arrays."""
        self._check_readable()
        addr = np.load(_shard_file(self.path, i, "addr"), mmap_mode="r")
        w = np.load(_shard_file(self.path, i, "w"), mmap_mode="r")
        vm = (np.load(_shard_file(self.path, i, "vm"), mmap_mode="r")
              if self._meta.has_vm else None)
        sz = (np.load(_shard_file(self.path, i, "sz"), mmap_mode="r")
              if self._meta.has_size else None)
        return Trace(addr=addr, is_write=w, vm=vm, size=sz)

    def iter_shards(self) -> Iterator[Trace]:
        for i in range(self.num_shards):
            yield self.shard(i)

    def read(self, start: int, stop: int) -> Trace:
        """Materialize requests ``[start, stop)`` (crossing shard
        boundaries; out-of-range tails are clipped)."""
        self._check_readable()
        stop = min(stop, self._meta.total)
        parts, base = [], 0
        for i, n in enumerate(self._meta.shards):
            if base + n > start and base < stop:
                sh = self.shard(i)
                parts.append(sh[max(start - base, 0): stop - base])
            base += n
            if base >= stop:
                break
        if not parts:
            return Trace(np.empty(0, np.int32), np.empty(0, bool),
                         np.empty(0, np.int32) if self._meta.has_vm else None,
                         np.empty(0, np.int32) if self._meta.has_size
                         else None)
        return Trace.concat(parts) if len(parts) > 1 else parts[0]

    def iter_windows(self, window: int) -> Iterator[Trace]:
        """Yield consecutive fixed-size request windows (the on-disk
        analogue of :meth:`Trace.intervals`) at O(window) memory."""
        for start in range(0, self._meta.total, window):
            yield self.read(start, start + window)

    def to_trace(self) -> Trace:
        """Materialize the whole store (tests / small stores only)."""
        return self.read(0, self._meta.total)

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_trace(cls, path, trace: Trace,
                   shard_size: int = DEFAULT_SHARD_SIZE) -> "TraceStore":
        """Deterministically convert an in-memory Trace (exact round-trip:
        ``TraceStore.from_trace(p, t).to_trace() == t``)."""
        with cls.create(path, shard_size=shard_size) as store:
            store.append(trace)
        return store

    @classmethod
    def from_chunks(cls, path, chunks: Iterable[Trace],
                    shard_size: int = DEFAULT_SHARD_SIZE) -> "TraceStore":
        with cls.create(path, shard_size=shard_size) as store:
            for chunk in chunks:
                store.append(chunk)
        return store

    @classmethod
    def from_msr_csv(cls, path, csv_path, *, block_size: int = DEFAULT_BLOCK,
                     shard_size: int = DEFAULT_SHARD_SIZE) -> "TraceStore":
        with Path(csv_path).open() as f:
            return cls.from_chunks(path, parse_msr_csv(f, block_size=block_size),
                                   shard_size=shard_size)

    @classmethod
    def from_blktrace(cls, path, log_path, *,
                      block_size: int = DEFAULT_BLOCK,
                      shard_size: int = DEFAULT_SHARD_SIZE) -> "TraceStore":
        with Path(log_path).open() as f:
            return cls.from_chunks(path, parse_blktrace(f, block_size=block_size),
                                   shard_size=shard_size)


# ---------------------------------------------------------------------------
# external-format parsers (streaming, bounded memory)
# ---------------------------------------------------------------------------

class _ChunkBuilder:
    """Accumulates block spans, expanding to per-block requests lazily.

    One Python-level append per *record*; the per-block expansion (a
    64 KiB request touches 16 x 4 KiB blocks) happens vectorized at
    :meth:`pop` time via ``np.repeat`` — the importer stays O(records)
    in interpreter work even for large-request traces."""

    def __init__(self, chunk: int):
        self.chunk = chunk
        self.first: list[int] = []
        self.last: list[int] = []
        self.w: list[bool] = []
        self.vm: list[int] = []
        self._blocks = 0

    def add_span(self, first: int, last: int, is_write: bool, vm: int) -> None:
        self.first.append(first)
        self.last.append(last)
        self.w.append(is_write)
        self.vm.append(vm)
        self._blocks += last - first + 1

    def ready(self) -> bool:
        return self._blocks >= self.chunk

    @property
    def pending(self) -> bool:
        return bool(self.first)

    def pop(self) -> Trace:
        first = np.asarray(self.first, np.int64)
        last = np.asarray(self.last, np.int64)
        hi, lo = int(last.max()), int(first.min())
        if hi >= 2**31 or lo < 0:
            # out-of-range block ids would wrap/land on negative int32
            # addresses — the datapath's pad/no-op convention — silently
            # dropping requests from the simulation
            raise ValueError(
                f"block address {lo if lo < 0 else hi} outside int32 range "
                f"[0, 2^31) — corrupt offset or device region too large; "
                f"check the input or re-import with a larger block size")
        counts = last - first + 1
        # addr = each span's first block + its within-span offset 0..len-1
        offset = np.arange(self._blocks, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        t = Trace((np.repeat(first, counts) + offset).astype(np.int32),
                  np.repeat(np.asarray(self.w, bool), counts),
                  np.repeat(np.asarray(self.vm, np.int32), counts))
        self.first, self.last, self.w, self.vm = [], [], [], []
        self._blocks = 0
        return t


def parse_msr_csv(lines: Iterable[str], *, block_size: int = DEFAULT_BLOCK,
                  chunk: int = 1 << 16) -> Iterator[Trace]:
    """Parse MSR-Cambridge-style CSV into bounded Trace chunks.

    Line format (SNIA IOTTA block-I/O release)::

        Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime

    ``Offset``/``Size`` are bytes; each record expands to every
    ``block_size`` block it spans. VM ids are assigned to
    ``(Hostname, DiskNumber)`` pairs in order of first appearance — the
    paper's "one MSR volume = one VM" convention. A header line and
    blank/malformed lines are skipped.
    """
    vm_ids: dict[tuple[str, str], int] = {}
    out = _ChunkBuilder(chunk)
    for line in lines:
        parts = line.strip().split(",")
        if len(parts) < 6:
            continue
        ts, host, disk, typ, off, size = parts[:6]
        typ = typ.strip().lower()
        if typ not in ("read", "write", "r", "w"):
            continue  # header or foreign row
        try:
            off_b, size_b = int(off), int(size)
        except ValueError:
            continue
        key = (host.strip(), disk.strip())
        vm = vm_ids.setdefault(key, len(vm_ids))
        first = off_b // block_size
        last = (off_b + max(size_b - 1, 0)) // block_size
        out.add_span(first, last, typ.startswith("w"), vm)
        if out.ready():
            yield out.pop()
    if out.pending:
        yield out.pop()


# blkparse default line, e.g.:
#   8,16   1   42   0.000104 1234  Q   R 223490 + 8 [fio]
_BLK_RE = re.compile(
    r"^\s*(?P<dev>\d+,\d+)\s+\d+\s+\d+\s+[\d.]+\s+\d+\s+"
    r"(?P<action>[A-Z])\s+(?P<rwbs>[A-Z]+)\s+(?P<sector>\d+)\s*\+\s*"
    r"(?P<count>\d+)")


def parse_blktrace(lines: Iterable[str], *, block_size: int = DEFAULT_BLOCK,
                   actions: str = "Q", chunk: int = 1 << 16) -> Iterator[Trace]:
    """Parse blktrace/blkparse text logs (FIO's blktrace output) into
    bounded Trace chunks.

    Keeps lines whose action is in ``actions`` (default ``Q`` = queued,
    one event per submitted I/O) and whose RWBS field carries ``R`` or
    ``W``. Sectors are 512-byte units; each request expands to every
    ``block_size`` block it spans. VM ids are assigned per device
    (``maj,min``) in order of first appearance. Unparsable lines are
    skipped.
    """
    vm_ids: dict[str, int] = {}
    out = _ChunkBuilder(chunk)
    for line in lines:
        m = _BLK_RE.match(line)
        if m is None or m.group("action") not in actions:
            continue
        rwbs = m.group("rwbs")
        if "R" in rwbs:
            is_write = False
        elif "W" in rwbs:
            is_write = True
        else:
            continue  # barriers / discards
        vm = vm_ids.setdefault(m.group("dev"), len(vm_ids))
        off_b = int(m.group("sector")) * SECTOR
        size_b = int(m.group("count")) * SECTOR
        first = off_b // block_size
        last = (off_b + max(size_b - 1, 0)) // block_size
        out.add_span(first, last, is_write, vm)
        if out.ready():
            yield out.pop()
    if out.pending:
        yield out.pop()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.traces.store {import,info} ...``"""
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.traces.store",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import", help="import an external trace file")
    imp.add_argument("src", help="trace file (CSV or blktrace text)")
    imp.add_argument("dest", help="store directory to create")
    imp.add_argument("--format", choices=("msr", "blktrace"), default="msr")
    imp.add_argument("--block-size", type=int, default=DEFAULT_BLOCK)
    imp.add_argument("--shard-size", type=int, default=DEFAULT_SHARD_SIZE)
    info = sub.add_parser("info", help="describe an existing store")
    info.add_argument("store", help="store directory")
    args = ap.parse_args(argv)

    if args.cmd == "import":
        conv = (TraceStore.from_msr_csv if args.format == "msr"
                else TraceStore.from_blktrace)
        store = conv(args.dest, args.src, block_size=args.block_size,
                     shard_size=args.shard_size)
        print(f"imported {len(store)} requests from {args.src} -> "
              f"{args.dest} ({store.num_shards} shards, "
              f"num_vms={store.num_vms})")
    else:
        store = TraceStore.open(args.store)
        reads = sum(int(np.sum(~np.asarray(s.is_write)))
                    for s in store.iter_shards())
        print(f"{args.store}: {len(store)} requests in {store.num_shards} "
              f"shards of {store.shard_size} "
              f"(num_vms={store.num_vms}, reads={reads}, "
              f"writes={len(store) - reads})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
