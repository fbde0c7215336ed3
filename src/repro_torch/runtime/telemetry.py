"""Interval telemetry for the port's controller.

The parts of :mod:`repro.runtime.telemetry` that the two-level
controller's main path uses, without JAX:

* :class:`Journal` — a bounded columnar ring of per-interval samples
  (O(window) host memory); the JSONL spill and :func:`load_journal` of
  the reference are not ported yet. ``cache_clean_log`` /
  ``cache_dirty_log`` are the background cleaner's views of it.
* :class:`TelemetryRecorder` — ``sample_cache`` turns host-side stats the
  controller already fetched into per-interval deltas (no device
  transfers of its own), and ``span`` times a dispatch. Span timing is
  off by default (a shared no-op span, no synchronisation). When it is
  on, a span on the card is timed with CUDA events recorded on the
  current stream and waits for the end event at close, which is the one
  synchronisation it adds; elsewhere it reads the host clock.
* :func:`overload_flags` — LBICA-style per-interval overload detection.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import numpy as np
import torch

DISPATCH_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

CACHE_DELTA_KEYS = ("reads", "writes", "read_hits_l1", "read_hits_l2",
                    "write_hits_l2", "cache_writes_l2", "disk_reads",
                    "disk_writes", "flushes", "evict_flushes", "bypassed",
                    "pop_drops", "latency_sum")


class Journal:
    """Bounded columnar ring of per-interval rows.

    ``append(row)`` takes a ``{name: scalar | ndarray}`` dict; each column
    keeps the last ``window`` values in a preallocated ``[window, ...]``
    ring (shape and dtype fixed by the column's first appearance), so
    memory is O(window · columns), never O(run length).
    """

    window = 512

    def __init__(self):
        self.total = 0                 # rows ever appended
        self._cols: dict[str, np.ndarray] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return self.total

    @property
    def retained(self) -> int:
        """Rows currently held in memory (≤ ``window``)."""
        return min(self.total, self.window)

    def append(self, row: dict) -> None:
        pos = self.total % self.window
        for name, value in row.items():
            a = np.asarray(value)
            buf = self._cols.get(name)
            if buf is None:
                buf = np.zeros((self.window,) + a.shape, a.dtype)
                self._cols[name] = buf
            elif buf.shape[1:] != a.shape:
                raise ValueError(
                    f"journal column {name!r}: shape {a.shape} != "
                    f"established {buf.shape[1:]}")
            buf[pos] = a
        self.total += 1

    def _order(self) -> np.ndarray:
        n = self.retained
        if self.total <= self.window:
            return np.arange(n)
        pos = self.total % self.window
        return np.r_[pos:self.window, 0:pos]

    def column(self, name: str) -> np.ndarray:
        """Retained values of one column, oldest first — ``[retained, ...]``."""
        return self._cols[name][self._order()]

    def last_row(self) -> dict:
        """The most recent row as ``{name: ndarray | scalar}``."""
        if self.total == 0:
            raise IndexError("empty journal")
        pos = (self.total - 1) % self.window
        return {k: buf[pos] for k, buf in self._cols.items()}

# ---------------------------------------------------------------------------
# dispatch-span histograms (opt-in: waits for the span to finish)
# ---------------------------------------------------------------------------

class SpanStats:
    """One wall-clock histogram: fixed bucket edges, per-bucket counts
    (the last slot is the +Inf overflow bucket), running sum."""

    __slots__ = ("buckets", "counts", "total", "n")

    def __init__(self):
        self.buckets = DISPATCH_BUCKETS
        self.counts = np.zeros(len(self.buckets) + 1, np.int64)
        self.total = 0.0
        self.n = 0

    def observe(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, seconds)] += 1
        self.total += float(seconds)
        self.n += 1


class _Span:
    """Times a block: with CUDA events on the current stream when the
    value handed to :meth:`ready` is a CUDA tensor (waiting for the end
    event at close — the synchronisation that makes the time mean
    "dispatch complete", and the reason span timing is opt-in), else with
    the host clock."""

    __slots__ = ("_rec", "_name", "_t0", "_ev0", "_val")

    def __init__(self, rec, name):
        self._rec = rec
        self._name = name
        self._val = None
        self._ev0 = None

    def ready(self, value) -> None:
        """Register a tensor the dispatch produced."""
        self._val = value

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            on_card = (self._ev0 is not None
                       and isinstance(self._val, torch.Tensor)
                       and self._val.is_cuda)
            if on_card:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                seconds = self._ev0.elapsed_time(end) / 1e3
            else:
                seconds = time.perf_counter() - self._t0
            self._rec._observe_span(self._name, seconds)
        return False


class _NullSpan:
    """Shared no-op span: zero overhead, zero added syncs."""

    __slots__ = ()

    def ready(self, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# LBICA-style overload detection (detection only — no rebalancing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OverloadConfig:
    """Windowed hit-ratio-collapse + queue-pressure detection knobs."""
    window: int = 8          # intervals of baseline history per VM/tenant
    drop: float = 0.6        # flag when ratio < drop * best recent ratio
    min_requests: int = 32   # interval request floor for a verdict
    pressure: float = 0.95   # occupancy/allocation fraction that flags


def overload_flags(prev_hits: np.ndarray, prev_reqs: np.ndarray,
                   hits: np.ndarray, reqs: np.ndarray,
                   pressure: np.ndarray, ocfg: OverloadConfig) -> np.ndarray:
    """Per-entity overload flags for one interval.

    ``prev_hits``/``prev_reqs`` are ``[n, V]`` per-interval deltas of the
    up-to-``ocfg.window`` preceding intervals; ``hits``/``reqs`` the
    current interval's ``[V]`` deltas; ``pressure`` a ``[V]`` bool of
    queue-pressure verdicts the caller computed (e.g. dirty occupancy vs
    allocation). An entity is overloaded when its current hit ratio falls
    below ``drop ×`` the best ratio any *qualified* baseline interval
    (``>= min_requests`` requests) achieved, or when pressure flags it.
    Deterministic and pure — exactness-tested on synthetic collapses.
    """
    hits = np.asarray(hits, np.float64)
    reqs = np.asarray(reqs, np.float64)
    flags = np.zeros(hits.shape, bool)
    prev_reqs = np.asarray(prev_reqs, np.float64).reshape(-1, hits.shape[0])
    prev_hits = np.asarray(prev_hits, np.float64).reshape(-1, hits.shape[0])
    if prev_reqs.shape[0]:
        valid = prev_reqs >= ocfg.min_requests
        ratio_prev = np.where(valid, prev_hits / np.maximum(prev_reqs, 1.0),
                              -1.0)
        base = ratio_prev.max(axis=0)          # -1 when no qualified interval
        ratio = hits / np.maximum(reqs, 1.0)
        flags = ((reqs >= ocfg.min_requests) & (base > 0.0)
                 & (ratio < ocfg.drop * base))
    return flags | np.asarray(pressure, bool)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class TelemetryRecorder:
    """Per-interval telemetry sink threaded through the controllers.

    One recorder belongs to one controller: it keeps the previous
    cumulative-stats snapshot to compute interval deltas, so sharing an
    instance between controllers would interleave their deltas.

    Guarantees: ``sample_cache`` only reads host-side values the
    controller already fetched and never touches cache state, so results
    are identical with telemetry on or off. ``span_timing`` is the opt-in
    exception that adds synchronisation.
    """

    def __init__(self, span_timing: bool = False):
        self.journal = Journal()
        self.span_timing = bool(span_timing)
        self.spans: dict[str, SpanStats] = {}
        self.overload = OverloadConfig()
        self._prev: dict[str, np.ndarray] = {}
        self._ov_hits = collections.deque(maxlen=self.overload.window)
        self._ov_reqs = collections.deque(maxlen=self.overload.window)

    # -- spans ------------------------------------------------------------
    def span(self, name: str):
        """Context manager timing one dispatch; hand the dispatch output
        to ``.ready(out)`` so close can wait for it. A no-op (and
        sync-free) unless ``span_timing`` is on."""
        return _Span(self, name) if self.span_timing else _NULL_SPAN

    def _observe_span(self, name: str, seconds: float) -> None:
        s = self.spans.get(name)
        if s is None:
            s = self.spans[name] = SpanStats()
        s.observe(seconds)

    # -- interval samples -------------------------------------------------
    def _deltas(self, cur: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        out = {k: v - self._prev.get(k, np.zeros_like(v))
               for k, v in cur.items()}
        self._prev = cur
        return out

    def _flag(self, hits, reqs, pressure) -> np.ndarray:
        n = len(self._ov_hits)
        prev_h = (np.stack(self._ov_hits) if n
                  else np.zeros((0, len(hits))))
        prev_r = (np.stack(self._ov_reqs) if n
                  else np.zeros((0, len(reqs))))
        flags = overload_flags(prev_h, prev_r, hits, reqs, pressure,
                               self.overload)
        self._ov_hits.append(np.asarray(hits, np.float64))
        self._ov_reqs.append(np.asarray(reqs, np.float64))
        return flags

    def sample_cache(self, stats: list[dict], *, alloc_l1=None, alloc_l2=None,
                     promoted=None, evict_queue=None, cleaned=None,
                     dirty=None, clean_ran: bool = False) -> dict:
        """One interval sample from the controller's per-VM stats dicts
        (cumulative, host-side) plus the maintenance counts the interval
        already fetched."""
        num_vms = len(stats)
        cur = {k: np.asarray([float(d.get(k, 0.0)) for d in stats])
               for k in CACHE_DELTA_KEYS}
        d = self._deltas(cur)
        zeros = np.zeros(num_vms, np.int64)
        alloc_l1 = np.asarray(alloc_l1 if alloc_l1 is not None else zeros,
                              np.int64)
        alloc_l2 = np.asarray(alloc_l2 if alloc_l2 is not None else zeros,
                              np.int64)
        dirty = np.asarray(dirty if dirty is not None else zeros, np.int64)
        reqs = d["reads"] + d["writes"]
        hits = d["read_hits_l1"] + d["read_hits_l2"] + d["write_hits_l2"]
        pressure = (alloc_l2 > 0) & (dirty >= self.overload.pressure
                                     * alloc_l2)
        row = {
            "requests": reqs,
            "hits": hits,
            "ssd_writes": d["cache_writes_l2"],
            "disk_reads": d["disk_reads"],
            "disk_writes": d["disk_writes"],
            "flushes": d["flushes"],
            "evict_flushes": d["evict_flushes"],
            "bypassed": d["bypassed"],
            "pop_drops": d["pop_drops"],
            "latency": d["latency_sum"],
            "dirty_resident": dirty,
            "alloc_l1": alloc_l1,
            "alloc_l2": alloc_l2,
            "promoted": np.asarray(promoted if promoted is not None
                                   else zeros, np.int64),
            "evict_queue": np.asarray(evict_queue if evict_queue is not None
                                      else zeros, np.int64),
            "cleaned": np.asarray(cleaned if cleaned is not None else zeros,
                                  np.int64),
            "clean_ran": bool(clean_ran),
            "overloaded": self._flag(hits, reqs, pressure),
        }
        self.journal.append(row)
        return row

    # -- cleaner-log views --------------------------------------------------
    # The rows where the background cleaner ran (bounded by the journal
    # window): per-VM flush counts and the dirty blocks it left.
    def cache_clean_log(self) -> list[np.ndarray]:
        return self._clean_rows("cleaned")

    def cache_dirty_log(self) -> list[np.ndarray]:
        return self._clean_rows("dirty_resident")

    def _clean_rows(self, column: str) -> list[np.ndarray]:
        if "clean_ran" not in self.journal:
            return []
        col = self.journal.column(column)
        return [col[i] for i in np.flatnonzero(
            self.journal.column("clean_ran"))]
