"""Interval telemetry for the port's controller.

The parts of :mod:`repro.runtime.telemetry` that the cache controllers
and the serving manager use, without JAX:

* :class:`Journal` — a bounded columnar ring of per-interval samples
  (O(window) host memory), with an optional JSONL spill of every row
  (:func:`load_journal` reads it back). ``cache_clean_log`` /
  ``cache_dirty_log`` are the background cleaner's views of it.
* :class:`TelemetryRecorder` — ``sample_cache`` / ``sample_serving`` turn
  host-side stats the controller already fetched into per-interval
  deltas (no device transfers of their own), and ``span`` times a
  dispatch. Span timing is
  off by default (a shared no-op span, no synchronisation). When it is
  on, a span on the card is timed with CUDA events recorded on the
  current stream and waits for the end event at close, which is the one
  synchronisation it adds; elsewhere it reads the host clock.
  ``profile()`` records a ``torch.profiler`` trace of a region into
  ``profile_dir`` (opt-in as well).
* :func:`overload_flags` — LBICA-style per-interval overload detection.
* :func:`summarize_journal` / :func:`format_report` — a journal's
  per-interval series and totals, and the report lines
  ``examples/torch_run_report.py`` prints.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "DISPATCH_BUCKETS", "Journal", "OverloadConfig", "SpanStats",
    "TelemetryRecorder", "format_report", "load_journal", "overload_flags",
    "summarize_journal",
]

DISPATCH_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

CACHE_DELTA_KEYS = ("reads", "writes", "read_hits_l1", "read_hits_l2",
                    "write_hits_l2", "cache_writes_l2", "disk_reads",
                    "disk_writes", "flushes", "evict_flushes", "bypassed",
                    "pop_drops", "latency_sum")

SERVING_DELTA_KEYS = ("activations", "hits", "appends", "dma_read_bytes",
                      "dma_write_bytes", "latency_s", "sessions_ended",
                      "pop_drops", "flushes", "evict_flushes",
                      "dirty_dropped")


class Journal:
    """Bounded columnar ring of per-interval rows.

    ``append(row)`` takes a ``{name: scalar | ndarray}`` dict; each column
    keeps the last ``window`` values in a preallocated ``[window, ...]``
    ring (shape and dtype fixed by the column's first appearance), so
    memory is O(window · columns), never O(run length). With ``spill``
    set, every row is also written to that path as one JSON line
    (``{"i": <row index>, <column>: <value>, ...}``) and flushed at once.
    """

    def __init__(self, window: int = 512, spill=None):
        if window <= 0:
            raise ValueError("journal window must be positive")
        self.window = int(window)
        self.total = 0                 # rows ever appended
        self._cols: dict[str, np.ndarray] = {}
        self._spill_path = spill
        self._spill_f = None

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return self.total

    @property
    def retained(self) -> int:
        """Rows currently held in memory (≤ ``window``)."""
        return min(self.total, self.window)

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(self._cols)

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
        if self._spill_path is not None:
            if self._spill_f is None:
                # one journal owns one spill file: truncate on first row
                self._spill_f = open(self._spill_path, "w")
            line = {"i": self.total - 1}
            line.update({k: np.asarray(v).tolist() for k, v in row.items()})
            self._spill_f.write(json.dumps(line) + "\n")
            self._spill_f.flush()

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

    def rows(self) -> list[dict]:
        """Retained rows oldest-first (each a plain column dict)."""
        return [{k: buf[i] for k, buf in self._cols.items()}
                for i in self._order()]

    def close(self) -> None:
        if self._spill_f is not None:
            self._spill_f.close()
            self._spill_f = None


def load_journal(path) -> dict[str, np.ndarray]:
    """A JSONL spill read back as ``{column: [rows, ...] ndarray}``; rows
    whose columns differ from the first row's are rejected."""
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: line {ln}: {e}") from None
    if not rows:
        return {}
    keys = set(rows[0])
    for ln, r in enumerate(rows, 1):
        if set(r) != keys:
            raise ValueError(f"{path}: row {ln} schema {sorted(r)} != "
                             f"{sorted(keys)}")
    return {k: np.asarray([r[k] for r in rows]) for k in keys}

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


@contextlib.contextmanager
def _profile(out_dir: Path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_{time.time_ns()}.json"))


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

    Guarantees: ``sample_*`` only reads host-side values the controller
    already fetched and never touches cache state, so results are
    identical with telemetry on or off. ``span_timing`` and
    ``profile_dir`` are the opt-in exceptions that add synchronisation.
    """

    def __init__(self, window: int = 512, spill=None,
                 span_timing: bool = False,
                 overload: OverloadConfig | None = None,
                 profile_dir=None):
        self.journal = Journal(window=window, spill=spill)
        self.span_timing = bool(span_timing)
        self.spans: dict[str, SpanStats] = {}
        self.overload = overload if overload is not None else OverloadConfig()
        self.profile_dir = profile_dir
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

    def profile(self):
        """A ``torch.profiler`` trace of the region (CPU, and CUDA where
        a card is present), written as a Chrome trace
        ``trace_<ns>.json`` under ``profile_dir`` when the region ends;
        a null context when ``profile_dir`` is None."""
        if self.profile_dir is None:
            return contextlib.nullcontext()
        return _profile(Path(self.profile_dir))

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
                     dirty=None, clean_ran: bool = False,
                     cls_hits=None, cls_miss=None) -> dict:
        """One interval sample from the controller's per-VM stats dicts
        (cumulative, host-side) plus the maintenance counts the interval
        already fetched; with a classifier, the cumulative ``[V, C]``
        per-class served hits and misses, journaled as this interval's
        deltas."""
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
        if cls_hits is not None:
            ch = np.asarray(cls_hits, np.int64)
            cm = np.asarray(cls_miss, np.int64)
            prev_ch = self._prev.get("_cls_hits", np.zeros_like(ch))
            prev_cm = self._prev.get("_cls_miss", np.zeros_like(cm))
            row["cls_hits"] = ch - prev_ch
            row["cls_miss"] = cm - prev_cm
            self._prev["_cls_hits"] = ch.copy()
            self._prev["_cls_miss"] = cm.copy()
        self.journal.append(row)
        return row

    def sample_serving(self, stats, *, quota, used) -> dict:
        """One maintenance-tick sample from a serving manager's ``Stats``
        plus the per-tenant quota state (all host-side already)."""
        cur = {k: np.asarray([float(getattr(stats, k))])
               for k in SERVING_DELTA_KEYS}
        dirty = int(stats.dirty_resident)
        d = self._deltas(cur)
        quota = np.asarray(quota, np.int64)
        used = np.asarray(used, np.int64)
        # queue pressure per tenant: resident pages pressing the quota
        pressure = (quota > 0) & (used >= np.ceil(
            self.overload.pressure * quota).astype(np.int64))
        global_flag = self._flag(d["hits"], d["activations"],
                                 np.zeros(1, bool))
        row = {
            "requests": d["activations"][0],
            "hits": d["hits"][0],
            "appends": d["appends"][0],
            "dma_read_bytes": d["dma_read_bytes"][0],
            "dma_write_bytes": d["dma_write_bytes"][0],
            "latency": d["latency_s"][0],
            "flushes": d["flushes"][0],
            "evict_flushes": d["evict_flushes"][0],
            "dirty_dropped": d["dirty_dropped"][0],
            "sessions_ended": d["sessions_ended"][0],
            "pop_drops": d["pop_drops"][0],
            "dirty_resident": dirty,
            "quota": quota,
            "used": used,
            "overloaded": pressure | bool(global_flag[0]),
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


# ---------------------------------------------------------------------------
# journal summaries (examples/torch_run_report.py and fig17 render these)
# ---------------------------------------------------------------------------

def summarize_journal(cols: dict[str, np.ndarray]) -> dict:
    """Aggregate a loaded (or in-memory) journal's columns.

    ``cols`` maps column name -> ``[rows, ...]`` arrays (the shape
    :func:`load_journal` returns). Returns per-interval 1-D series
    (requests, hit_ratio, dirty, overloaded count) plus scalar totals.
    """
    if not cols:
        return {"intervals": 0}
    reqs = np.asarray(cols["requests"], np.float64)
    hits = np.asarray(cols["hits"], np.float64)
    if reqs.ndim > 1:                      # per-VM rows -> per-interval sums
        reqs_i, hits_i = reqs.sum(axis=1), hits.sum(axis=1)
    else:
        reqs_i, hits_i = reqs, hits
    dirty = np.asarray(cols.get("dirty_resident", np.zeros_like(reqs)),
                       np.float64)
    dirty_i = dirty.sum(axis=1) if dirty.ndim > 1 else dirty
    over = np.asarray(cols.get("overloaded", np.zeros_like(reqs)), bool)
    over_i = over.sum(axis=1) if over.ndim > 1 else over.astype(np.int64)
    ratio = hits_i / np.maximum(reqs_i, 1.0)
    return {
        "intervals": int(reqs_i.shape[0]),
        "requests": reqs_i,
        "hit_ratio": ratio,
        "dirty": dirty_i,
        "overloaded": over_i,
        "total_requests": float(reqs_i.sum()),
        "mean_hit_ratio": float(hits_i.sum() / max(reqs_i.sum(), 1.0)),
        "peak_dirty": float(dirty_i.max(initial=0.0)),
        "overloaded_intervals": int((over_i > 0).sum()),
    }


def format_report(cols: dict[str, np.ndarray], last: int | None = None,
                  vm: int | None = None) -> list[str]:
    """Per-interval report lines of a journal (``last``: only the last
    intervals; ``vm``: one VM's columns of a per-VM journal), then a
    summary line."""
    s = summarize_journal(cols)
    if not s["intervals"]:
        return ["empty journal"]
    idx = np.asarray(cols.get("i", np.arange(s["intervals"])), np.int64)
    reqs, ratio = s["requests"], s["hit_ratio"]
    dirty, over = s["dirty"], s["overloaded"]
    if vm is not None:
        r = np.asarray(cols["requests"], np.float64)
        if r.ndim < 2:
            raise ValueError("journal has no per-VM columns (serving run?)")
        h = np.asarray(cols["hits"], np.float64)
        reqs, ratio = r[:, vm], h[:, vm] / np.maximum(r[:, vm], 1.0)
        d = np.asarray(cols["dirty_resident"], np.float64)
        o = np.asarray(cols["overloaded"], bool)
        dirty, over = d[:, vm], o[:, vm].astype(np.int64)
    lines = [f"{'interval':>8} {'requests':>9} {'hit_ratio':>9} "
             f"{'dirty':>7} {'overloaded':>10}"]
    sel = range(s["intervals"]) if last is None else \
        range(max(s["intervals"] - last, 0), s["intervals"])
    for i in sel:
        lines.append(f"{int(idx[i]):>8} {reqs[i]:>9.0f} {ratio[i]:>9.3f} "
                     f"{dirty[i]:>7.0f} {int(over[i]):>10}")
    lines.append(
        f"summary: intervals={s['intervals']} "
        f"requests={s['total_requests']:.0f} "
        f"mean_hit_ratio={s['mean_hit_ratio']:.3f} "
        f"peak_dirty={s['peak_dirty']:.0f} "
        f"overloaded_intervals={s['overloaded_intervals']}")
    return lines
