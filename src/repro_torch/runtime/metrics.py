"""Prometheus text-format telemetry export for the cache controllers.

The PyTorch port's own copy of :mod:`repro.runtime.metrics` for the
block-cache controllers and the two-tier KV serving manager:

* :class:`Metric` + :func:`render` — a dependency-free renderer of the
  Prometheus text exposition format v0.0.4 (``# HELP`` / ``# TYPE``
  headers, ``name{label="v"} value`` samples, stable ordering, label
  escaping), with counter, gauge and histogram families
  (:class:`HistogramValue` renders the cumulative ``_bucket{le=...}`` /
  ``_sum`` / ``_count`` triplet).
* :func:`collect_cache` — the per-VM stats dicts of
  :class:`~repro_torch.core.controller.EticaCache` or
  ``PartitionedSingleLevelCache`` as metric families, including the
  background cleaner's channels (``flushes``, ``evict_flushes``,
  ``dirty_resident``), the popularity-table overflow counter and, with
  an IO classifier, the per-(VM, class) served hit/miss family;
  :func:`collect_serving` — a serving manager's ``Stats`` as the
  ``etica_serving_*`` families.
* :func:`collect_telemetry` — the ``{prefix}_dispatch_seconds`` span
  histograms, the journal row counter, and the last interval's
  request/hit deltas and overload flags of a
  :class:`~repro_torch.runtime.telemetry.TelemetryRecorder`, per VM or
  per tenant.
* :func:`parse_exposition` — a strict parser/validator for the same
  format. Histogram families accept exactly the suffixed sample triplet
  and are checked for cumulative buckets, a ``+Inf`` bucket, and
  bucket/count agreement.

Metric names are the reference's, and :func:`render_cache` /
:func:`render_serving` render the reference's text byte for byte from
equal stats.
"""
from __future__ import annotations

import dataclasses
import re

__all__ = [
    "HistogramValue", "Metric", "render", "render_cache", "render_serving",
    "collect_cache", "collect_serving", "collect_telemetry",
    "parse_exposition",
]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
_SAMPLE_RE = re.compile(
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)\Z")
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*(?:,|\Z)')


@dataclasses.dataclass
class Metric:
    """One metric family: a name, a type, help text, and samples.

    ``samples`` is a list of ``(labels, value)`` pairs where ``labels``
    is a plain ``{label: value}`` dict (may be empty). For histogram
    families the value must be a :class:`HistogramValue`; for counters
    and gauges it must be a plain number."""
    name: str
    mtype: str                     # "counter" | "gauge" | "histogram"
    help: str
    samples: list = dataclasses.field(default_factory=list)

    def add(self, labels: dict, value) -> "Metric":
        self.samples.append((dict(labels), value))
        return self


@dataclasses.dataclass(frozen=True)
class HistogramValue:
    """One histogram sample: fixed finite bucket bounds, *per-bucket*
    (non-cumulative) counts with a trailing +Inf overflow slot, and the
    running sum of observations. The renderer emits the standard
    cumulative ``_bucket`` series plus ``_sum`` / ``_count``."""
    le: tuple                      # finite upper bounds, strictly ascending
    counts: tuple                  # len(le) + 1; last slot = +Inf overflow
    sum: float

    def validate(self) -> None:
        if len(self.counts) != len(self.le) + 1:
            raise ValueError(
                f"histogram needs {len(self.le) + 1} bucket counts "
                f"(incl. +Inf), got {len(self.counts)}")
        if any(b >= a for b, a in zip(self.le, self.le[1:])):
            raise ValueError(f"histogram bounds not ascending: {self.le}")
        if any(c < 0 for c in self.counts):
            raise ValueError(f"negative bucket count in {self.counts}")

    @property
    def count(self) -> int:
        return sum(self.counts)


def _escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _format_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def render(metrics: list) -> str:
    """Render metric families as Prometheus text exposition v0.0.4.

    Deterministic: families render in list order, samples in insertion
    order, label keys in insertion order — collectors insert in a fixed
    order, so the full text is stable run to run (the golden tests rely
    on this)."""
    out = []
    for m in metrics:
        if not _NAME_RE.match(m.name):
            raise ValueError(f"bad metric name: {m.name!r}")
        if m.mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"bad metric type: {m.mtype!r}")
        out.append(f"# HELP {m.name} {_escape_help(m.help)}")
        out.append(f"# TYPE {m.name} {m.mtype}")
        for labels, value in m.samples:
            for k in labels:
                if not _LABEL_RE.match(k):
                    raise ValueError(f"bad label name: {k!r}")
            if m.mtype == "histogram":
                if not isinstance(value, HistogramValue):
                    raise ValueError(
                        f"{m.name}: histogram sample must be a "
                        f"HistogramValue, got {type(value).__name__}")
                if "le" in labels:
                    raise ValueError(f"{m.name}: reserved label 'le'")
                value.validate()
                bounds = tuple(_format_value(b) for b in value.le) + ("+Inf",)
                cum = 0
                for bound, c in zip(bounds, value.counts):
                    cum += int(c)
                    pairs = list(labels.items()) + [("le", bound)]
                    lbl = ",".join(f'{k}="{_escape_label(v)}"'
                                   for k, v in pairs)
                    out.append(f"{m.name}_bucket{{{lbl}}} {cum}")
                lbl = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in labels.items())
                lbl = "{" + lbl + "}" if lbl else ""
                out.append(f"{m.name}_sum{lbl} {_format_value(value.sum)}")
                out.append(f"{m.name}_count{lbl} {cum}")
                continue
            if isinstance(value, HistogramValue):
                raise ValueError(
                    f"{m.name}: {m.mtype} sample cannot be a HistogramValue")
            lbl = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in labels.items())
            lbl = "{" + lbl + "}" if lbl else ""
            out.append(f"{m.name}{lbl} {_format_value(value)}")
    return "\n".join(out) + "\n"


def parse_exposition(text: str) -> dict:
    """Parse (and thereby validate) Prometheus exposition text.

    Returns ``{name: {"type": t, "help": h, "samples": {label_key:
    value}}}`` with ``label_key`` a tuple of sorted ``(k, v)`` pairs.
    For histogram families the only legal sample names are
    ``name_bucket`` (with an ``le`` label), ``name_sum`` and
    ``name_count``; their keys are prefixed with ``("bucket"|"sum"|
    "count",)`` and the bucket series is validated (cumulative
    non-decreasing, ``+Inf`` present and equal to ``_count``). Raises
    ``ValueError`` on malformed lines, samples without a preceding
    ``# TYPE``, or duplicate samples."""
    families: dict = {}
    current = None
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": {}})
            families[name]["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, mtype = rest.partition(" ")
            if mtype not in ("counter", "gauge", "histogram", "summary",
                             "untyped"):
                raise ValueError(f"line {ln}: bad TYPE {mtype!r}")
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": {}})
            families[name]["type"] = mtype
            current = name
            continue
        if line.startswith("#"):
            continue                           # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, suffix = m.group("name"), None
        if name not in families or families[name]["type"] is None:
            for sfx in ("_bucket", "_sum", "_count"):
                base = name[:-len(sfx)]
                if name.endswith(sfx) and \
                        families.get(base, {}).get("type") == "histogram":
                    name, suffix = base, sfx[1:]
                    break
            else:
                raise ValueError(f"line {ln}: sample {m.group('name')!r} "
                                 f"without # TYPE")
        if families[name]["type"] == "histogram" and suffix is None:
            raise ValueError(f"line {ln}: histogram family {name!r} only "
                             f"emits _bucket/_sum/_count samples")
        if current != name:
            raise ValueError(f"line {ln}: sample {name!r} outside its "
                             f"family block")
        labels = {}
        raw = m.group("labels")
        if raw is not None:
            pos = 0
            while pos < len(raw):
                pm = _LABEL_PAIR_RE.match(raw, pos)
                if not pm:
                    raise ValueError(f"line {ln}: malformed labels {raw!r}")
                labels[pm.group("k")] = pm.group("v")
                pos = pm.end()
        if suffix == "bucket" and "le" not in labels:
            raise ValueError(f"line {ln}: _bucket sample without 'le'")
        key = tuple(sorted(labels.items()))
        if suffix is not None:
            key = (suffix,) + key
        if key in families[name]["samples"]:
            raise ValueError(f"line {ln}: duplicate sample {name}{key}")
        families[name]["samples"][key] = float(m.group("value"))
    for name, fam in families.items():
        if fam["type"] == "histogram" and fam["samples"]:
            _validate_histogram_family(name, fam["samples"])
    return families


def _validate_histogram_family(name: str, samples: dict) -> None:
    """Check each label group's bucket series is cumulative
    non-decreasing, carries ``+Inf``, and agrees with ``_count``."""
    groups: dict = {}
    for key, value in samples.items():
        suffix, labels = key[0], dict(key[1:])
        base = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        g = groups.setdefault(base, {"buckets": {}, "sum": None,
                                     "count": None})
        if suffix == "bucket":
            g["buckets"][labels["le"]] = value
        else:
            g[suffix] = value
    for base, g in groups.items():
        where = f"{name}{dict(base)}"
        if g["sum"] is None or g["count"] is None:
            raise ValueError(f"{where}: missing _sum/_count")
        if "+Inf" not in g["buckets"]:
            raise ValueError(f"{where}: missing le=\"+Inf\" bucket")
        les = sorted(g["buckets"],
                     key=lambda s: float("inf") if s == "+Inf" else float(s))
        series = [g["buckets"][le] for le in les]
        if any(b < a for a, b in zip(series, series[1:])):
            raise ValueError(f"{where}: bucket series not cumulative")
        if series[-1] != g["count"]:
            raise ValueError(f"{where}: +Inf bucket {series[-1]} != "
                             f"_count {g['count']}")


# ---------------------------------------------------------------------------
# collectors
# ---------------------------------------------------------------------------

def _stat(d: dict, key: str) -> float:
    return float(d.get(key, 0.0))


def collect_cache(cache) -> list:
    """Metric families from an interval controller — works for both
    :class:`~repro_torch.core.controller.EticaCache` and the one-level
    :class:`~repro_torch.core.controller.PartitionedSingleLevelCache`
    (the DRAM-level hit family simply stays 0 there).

    Every family emits a sample for every VM even when the count is 0,
    so scrapes are fixed-shape and rate() never sees series appear."""
    stats = cache.stats
    vms = [str(v) for v in range(len(stats))]
    req = Metric("etica_requests_total", "counter",
                 "Requests entering the cache datapath, by operation.")
    hits = Metric("etica_hits_total", "counter",
                  "Served cache hits, by level and operation.")
    ssd_w = Metric("etica_ssd_writes_total", "counter",
                   "Blocks committed to the SSD level (endurance metric).")
    disk_r = Metric("etica_disk_reads_total", "counter",
                    "Blocks read from the disk subsystem.")
    disk_w = Metric("etica_disk_writes_total", "counter",
                    "Blocks written to the disk subsystem "
                    "(misses, flushes, cleaning).")
    flushes = Metric("etica_flushes_total", "counter",
                     "Dirty blocks flushed by the background cleaner.")
    ev_fl = Metric("etica_evict_flushes_total", "counter",
                   "Dirty blocks flushed by eviction or resize.")
    dirty = Metric("etica_dirty_resident", "gauge",
                   "Dirty SSD blocks resident after the last "
                   "maintenance interval.")
    byp = Metric("etica_bypassed_total", "counter",
                 "Requests routed straight to disk by the IO classifier.")
    drops = Metric("etica_pop_drops_total", "counter",
                   "Popularity-table merge-overflow drops.")
    lat = Metric("etica_latency_seconds_total", "counter",
                 "Modeled service latency, summed over requests.")
    for v, d in zip(vms, stats):
        req.add({"vm": v, "op": "read"}, _stat(d, "reads"))
        req.add({"vm": v, "op": "write"}, _stat(d, "writes"))
        hits.add({"vm": v, "level": "dram", "op": "read"},
                 _stat(d, "read_hits_l1"))
        hits.add({"vm": v, "level": "ssd", "op": "read"},
                 _stat(d, "read_hits_l2"))
        hits.add({"vm": v, "level": "ssd", "op": "write"},
                 _stat(d, "write_hits_l2"))
        ssd_w.add({"vm": v}, _stat(d, "cache_writes_l2"))
        disk_r.add({"vm": v}, _stat(d, "disk_reads"))
        disk_w.add({"vm": v}, _stat(d, "disk_writes"))
        flushes.add({"vm": v}, _stat(d, "flushes"))
        ev_fl.add({"vm": v}, _stat(d, "evict_flushes"))
        dirty.add({"vm": v}, _stat(d, "dirty_resident"))
        byp.add({"vm": v}, _stat(d, "bypassed"))
        drops.add({"vm": v}, _stat(d, "pop_drops"))
        lat.add({"vm": v}, _stat(d, "latency_sum"))
    out = [req, hits, ssd_w, disk_r, disk_w, flushes, ev_fl, dirty, byp,
           drops, lat]
    if getattr(cache, "classifier", None) is not None:
        names = [c.name for c in cache.classifier.classes]
        cls = Metric("etica_class_requests_total", "counter",
                     "Served requests by VM, IO class, and hit/miss "
                     "outcome (bypassed requests excluded).")
        for v in range(len(stats)):
            for ci, cname in enumerate(names):
                cls.add({"vm": str(v), "io_class": cname, "result": "hit"},
                        int(cache.cls_hits[v, ci]))
                cls.add({"vm": str(v), "io_class": cname, "result": "miss"},
                        int(cache.cls_miss[v, ci]))
        out.append(cls)
    return out


def collect_serving(mgr) -> list:
    """Metric families from a :class:`~repro_torch.kvcache.manager
    .TwoTierKVManager`'s ``Stats``, with the deferred write-back
    channels."""
    s = mgr.stats

    def counter(name, help_, value):
        return Metric(f"etica_serving_{name}", "counter",
                      help_).add({}, value)
    dirty = Metric("etica_serving_dirty_resident", "gauge",
                   "Uncommitted (dirty) KV pages resident in HBM.")
    dirty.add({}, s.dirty_resident)
    return [
        counter("activations_total",
                "Session activations (tier-1 reads).", s.activations),
        counter("hits_total",
                "Fully HBM-resident activations.", s.hits),
        counter("appends_total",
                "KV pages generated (WBWO commits).", s.appends),
        counter("dma_read_bytes_total",
                "Host-to-HBM DMA bytes (misses, promotions).",
                s.dma_read_bytes),
        counter("dma_write_bytes_total",
                "HBM-to-host DMA bytes (the wear analog).",
                s.dma_write_bytes),
        counter("latency_seconds_total",
                "Modeled DMA latency, summed.", s.latency_s),
        counter("sessions_ended_total",
                "Retired sessions (churn).", s.sessions_ended),
        counter("pop_drops_total",
                "Popularity-table merge-overflow drops.", s.pop_drops),
        counter("flushes_total",
                "Dirty pages committed by the background cleaner.",
                s.flushes),
        counter("evict_flushes_total",
                "Dirty pages committed on forced slot release.",
                s.evict_flushes),
        counter("dirty_dropped_total",
                "Dirty pages retired with their session (no DMA).",
                s.dirty_dropped),
        dirty,
    ]


def _vector(x) -> tuple[bool, list]:
    """(is_vector, values) of a journal cell: an array or a scalar."""
    try:
        return True, list(x)
    except TypeError:
        return False, [x]


def collect_telemetry(rec, prefix: str = "etica",
                      label: str = "vm") -> list:
    """Metric families from a :class:`~repro_torch.runtime.telemetry
    .TelemetryRecorder`: the dispatch-span wall-clock histograms, the
    journal row counter, and the *last* recorded interval's request/hit
    deltas and LBICA-style overload flags (``{prefix}_overloaded``).
    ``label`` names the per-entity axis (``vm`` for the cache
    controllers, ``tenant`` for the serving manager); a scalar cell (the
    serving journal's requests and hits) is one unlabelled sample."""
    hist = Metric(f"{prefix}_dispatch_seconds", "histogram",
                  "Wall-clock seconds per fused dispatch span "
                  "(opt-in timers; waits for the span's work at close).")
    for name in sorted(rec.spans):
        s = rec.spans[name]
        hist.add({"span": name},
                 HistogramValue(tuple(s.buckets),
                                tuple(int(c) for c in s.counts),
                                float(s.total)))
    ivals = Metric(f"{prefix}_telemetry_intervals_total", "counter",
                   "Interval samples appended to the telemetry journal.")
    ivals.add({}, rec.journal.total)
    i_req = Metric(f"{prefix}_interval_requests", "gauge",
                   "Requests observed in the last telemetry interval.")
    i_hit = Metric(f"{prefix}_interval_hits", "gauge",
                   "Cache hits observed in the last telemetry interval.")
    over = Metric(f"{prefix}_overloaded", "gauge",
                  "LBICA-style overload flag from the last interval "
                  "(windowed hit-ratio collapse or queue pressure).")
    if rec.journal.total:
        row = rec.journal.last_row()
        for metric, col in ((i_req, "requests"), (i_hit, "hits"),
                            (over, "overloaded")):
            if col not in rec.journal:
                continue
            vec, values = _vector(row[col])
            for i, x in enumerate(values):
                metric.add({label: str(i)} if vec else {}, float(x))
    return [hist, ivals, i_req, i_hit, over]


def render_cache(cache) -> str:
    return render(collect_cache(cache))


def render_serving(mgr) -> str:
    return render(collect_serving(mgr))
