"""Port parity for the journal reports and the journal API:
``summarize_journal`` and ``format_report`` on the same JSONL spill,
``Journal(window=...)`` rings, the properties of ``tests/test_telemetry.py``
that apply to the port, and ``TelemetryRecorder.profile``."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.runtime import telemetry as JT
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

from repro_torch.core import EticaCache, EticaConfig, Geometry, interleave
from repro_torch.core import make_eci_cache
from repro_torch.runtime import telemetry as T
from repro_torch.traces import make

NAMES = ("hm_1", "web_3", "usr_0")


def _mixes(n=800):
    kw = [dict(seed=i, addr_offset=i * 10_000_000, scale=0.25)
          for i in range(len(NAMES))]
    return (interleave([make(w, n, **k) for w, k in zip(NAMES, kw)], seed=42),
            jinterleave([jmake(w, n, **k) for w, k in zip(NAMES, kw)],
                        seed=42))


def _cfgs(**kw):
    args = dict(dram_capacity=40, ssd_capacity=80, resize_interval=600,
                promo_interval=200, clean_quota=2, **kw)
    return (EticaConfig(geometry_dram=Geometry(8, 16),
                        geometry_ssd=Geometry(8, 16), **args),
            JConfig(geometry_dram=JGeometry(8, 16),
                    geometry_ssd=JGeometry(8, 16), **args))


@pytest.fixture(scope="module")
def spills(tmp_path_factory):
    """The same run through both controllers, each spilling its journal,
    plus a serving-shaped journal (scalar columns, per-tenant quota)
    written by the port's recorder."""
    d = tmp_path_factory.mktemp("spills")
    trace, jtrace = _mixes()
    tcfg, jcfg = _cfgs()
    rec = T.TelemetryRecorder(window=8, spill=d / "port.jsonl")
    tcfg.telemetry = rec
    res = EticaCache(tcfg, len(NAMES), device="cpu").run(trace)
    rec.journal.close()
    jrec = JT.TelemetryRecorder(window=8, spill=d / "jax.jsonl")
    jcfg.telemetry = jrec
    jres = JCache(jcfg, len(NAMES)).run(jtrace)
    jrec.journal.close()
    assert [r.stats for r in res] == [r.stats for r in jres]
    srec = T.TelemetryRecorder(spill=d / "serving.jsonl")
    keys = T.SERVING_DELTA_KEYS + ("dirty_resident",)
    rng = np.random.default_rng(3)
    cum = dict.fromkeys(keys, 0.0)
    for _ in range(12):
        for k in keys:
            cum[k] += float(rng.integers(0, 50))
        cum["hits"] = min(cum["hits"], cum["activations"])
        srec.sample_serving(types.SimpleNamespace(**cum),
                            quota=rng.integers(1, 20, 3),
                            used=rng.integers(0, 20, 3))
    srec.journal.close()
    return d


def _same_summary(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


def test_port_and_jax_runs_spill_the_same_journal(spills):
    """Row for row, the port's spill is the reference's."""
    port = [json.loads(x) for x in (spills / "port.jsonl").read_text()
            .splitlines()]
    ref = [json.loads(x) for x in (spills / "jax.jsonl").read_text()
           .splitlines()]
    assert len(port) >= 4 and port == ref


@pytest.mark.parametrize("name", ["port.jsonl", "jax.jsonl",
                                  "serving.jsonl"])
def test_summarize_journal_matches_jax(spills, name):
    cols = T.load_journal(spills / name)
    jcols = JT.load_journal(spills / name)
    _same_summary(T.summarize_journal(cols), JT.summarize_journal(jcols))
    assert T.summarize_journal({}) == JT.summarize_journal({})


@pytest.mark.parametrize("last", [None, 0, 3, 100])
@pytest.mark.parametrize("vm", [None, 0, 2])
def test_format_report_matches_jax(spills, last, vm):
    cols = T.load_journal(spills / "port.jsonl")
    jcols = JT.load_journal(spills / "port.jsonl")
    got = T.format_report(cols, last=last, vm=vm)
    assert got == JT.format_report(jcols, last=last, vm=vm)
    assert got[-1].startswith("summary: intervals=")


@pytest.mark.parametrize("last", [None, 5])
def test_format_report_serving_matches_jax(spills, last):
    cols = T.load_journal(spills / "serving.jsonl")
    jcols = JT.load_journal(spills / "serving.jsonl")
    assert T.format_report(cols, last=last) == \
        JT.format_report(jcols, last=last)
    with pytest.raises(ValueError, match="per-VM"):
        T.format_report(cols, vm=0)
    assert T.format_report({}) == JT.format_report({}) == ["empty journal"]


def test_in_memory_journal_reports_like_its_spill(spills, tmp_path):
    """``summarize_journal`` of a ring's columns (window above the row
    count) equals that of its spill, less the ``i`` column."""
    rec = T.TelemetryRecorder(window=64, spill=tmp_path / "j.jsonl")
    tcfg, _ = _cfgs(telemetry=rec)
    trace, _ = _mixes(400)
    EticaCache(tcfg, len(NAMES), device="cpu").run(trace)
    rec.journal.close()
    ring = {k: rec.journal.column(k) for k in rec.journal.columns}
    _same_summary(T.summarize_journal(ring),
                  T.summarize_journal(T.load_journal(tmp_path / "j.jsonl")))


@pytest.mark.parametrize("argv", [[], ["--last", "3"], ["--vm", "1"]])
def test_run_report_cli_matches_tools(spills, argv, capsys):
    """``examples/torch_run_report.py`` prints what ``tools/run_report.py``
    prints for the same spill."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = []
    for path in (root / "examples" / "torch_run_report.py",
                 root / "tools" / "run_report.py"):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.main([str(spills / "port.jsonl"), *argv]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].count("\n") >= 3


# ---------------------------------------------------------------------------
# Journal rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 3, 7, 20, 50])
def test_journal_ring_matches_jax(window, tmp_path):
    rng = np.random.default_rng(window)
    j = T.Journal(window=window, spill=tmp_path / "p.jsonl")
    jj = JT.Journal(window=window, spill=tmp_path / "j.jsonl")
    for i in range(20):
        row = {"x": rng.integers(0, 9, 3), "s": float(rng.random()),
               "b": bool(i % 3 == 0), "n": i}
        j.append(row)
        jj.append(row)
    j.close()
    jj.close()
    assert (j.total, j.retained, len(j)) == (jj.total, jj.retained, len(jj))
    assert j.columns == jj.columns == ("x", "s", "b", "n")
    for k in j.columns:
        a, b = j.column(k), jj.column(k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for r, jr in zip(j.rows(), jj.rows(), strict=True):
        assert r.keys() == jr.keys()
        assert all(np.array_equal(r[k], jr[k]) for k in r)
    assert all(np.array_equal(v, jj.last_row()[k])
               for k, v in j.last_row().items())
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's properties, on the port
# ---------------------------------------------------------------------------

def test_journal_ring_and_spill_roundtrip(tmp_path):
    spill = tmp_path / "j.jsonl"
    j = T.Journal(window=4, spill=spill)
    for i in range(10):
        j.append({"x": np.array([i, 2 * i]), "s": i})
    j.close()
    assert j.total == 10 and j.retained == 4
    assert j._cols["x"].shape == (4, 2)
    assert np.array_equal(j.column("x"),
                          [[6, 12], [7, 14], [8, 16], [9, 18]])
    assert np.array_equal(j.column("s"), [6, 7, 8, 9])
    assert j.last_row()["s"] == 9
    assert [r["s"] for r in j.rows()] == [6, 7, 8, 9]
    cols = T.load_journal(spill)
    assert np.array_equal(cols["i"], np.arange(10))
    assert cols["x"].shape == (10, 2)
    assert np.array_equal(cols["x"][-4:], j.column("x"))


def test_journal_rejects_bad_shapes_and_schemas(tmp_path):
    with pytest.raises(ValueError):
        T.Journal(window=0)
    j = T.Journal(window=4)
    j.append({"x": np.zeros(3)})
    with pytest.raises(ValueError):
        j.append({"x": np.zeros(2)})
    ragged = tmp_path / "ragged.jsonl"
    ragged.write_text('{"i": 0, "a": 1}\n{"i": 1, "b": 2}\n')
    with pytest.raises(ValueError):
        T.load_journal(ragged)
    garbled = tmp_path / "garbled.jsonl"
    garbled.write_text('{"i": 0}\nnot json\n')
    with pytest.raises(ValueError):
        T.load_journal(garbled)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert T.load_journal(empty) == {}


def test_span_timing_opt_in():
    rec = T.TelemetryRecorder()
    assert rec.span("x") is T._NULL_SPAN
    with rec.span("x") as sp:
        sp.ready(torch.arange(4))
    assert rec.spans == {}
    rec = T.TelemetryRecorder(span_timing=True)
    with rec.span("demo") as sp:
        sp.ready(torch.arange(8) * 2)
    s = rec.spans["demo"]
    assert s.n == 1 and s.total > 0.0 and int(s.counts.sum()) == 1
    with pytest.raises(RuntimeError):
        with rec.span("demo"):
            raise RuntimeError("boom")
    assert rec.spans["demo"].n == 1


def test_span_stats_buckets():
    """The pinned bucket edges, the +Inf slot last, as the reference's."""
    s, js = T.SpanStats(), JT.SpanStats()
    for v in (0.00005, 0.0005, 0.005, 0.005, 0.3, 9.0):
        s.observe(v)
        js.observe(v)
    assert s.buckets == js.buckets == T.DISPATCH_BUCKETS
    assert list(s.counts) == list(js.counts) and s.counts[-1] == 1
    assert (s.n, s.total) == (js.n, js.total)


def _cum(reads, hits):
    return [{"reads": float(sum(r[v] for r in reads)),
             "read_hits_l1": float(sum(h[v] for h in hits))}
            for v in range(len(reads[0]))]


def test_overload_through_sample_cache():
    rec = T.TelemetryRecorder(overload=T.OverloadConfig(
        window=4, drop=0.6, min_requests=32))
    reads, hits = [], []
    for delta_h in ([80, 80], [80, 80], [80, 80], [80, 80], [30, 70]):
        reads.append([100, 100])
        hits.append(delta_h)
        row = rec.sample_cache(_cum(reads, hits))
    assert row["overloaded"].tolist() == [True, False]
    assert rec.journal.column("overloaded")[:-1].sum() == 0
    reads.append([100, 100])
    hits.append([70, 70])
    row = rec.sample_cache(_cum(reads, hits))
    assert row["overloaded"].tolist() == [False, False]
    row = rec.sample_cache(_cum(reads, hits), alloc_l2=[100, 100],
                           dirty=[96, 10])
    assert row["overloaded"].tolist() == [True, False]


def test_recorder_leaves_results_unchanged(tmp_path):
    """A configured recorder (small window, spill, overload settings)
    changes nothing in ETICA's or ECI-Cache's results; the journal's
    deltas sum to the Stats; the clean log is the ring's cleaner rows."""
    trace, _ = _mixes(500)
    base_cfg, _ = _cfgs()
    base = [r.stats for r in EticaCache(base_cfg, 3, device="cpu").run(trace)]
    rec = T.TelemetryRecorder(window=4, spill=tmp_path / "c.jsonl",
                              overload=T.OverloadConfig(window=2))
    cfg, _ = _cfgs(telemetry=rec)
    cache = EticaCache(cfg, 3, device="cpu")
    res = [r.stats for r in cache.run(trace)]
    rec.journal.close()
    assert res == base and rec.journal.retained == 4
    cols = T.load_journal(tmp_path / "c.jsonl")
    assert cols["requests"].sum() == sum(s["reads"] + s["writes"]
                                         for s in res)
    assert len(cache.clean_log) == int(rec.journal.column("clean_ran").sum())
    geo = Geometry(8, 16)
    eci_base = make_eci_cache(120, 3, geometry=geo, resize_interval=600,
                              device="cpu").run(trace)
    erec = T.TelemetryRecorder(window=8, spill=tmp_path / "e.jsonl")
    eci = make_eci_cache(120, 3, geometry=geo, resize_interval=600,
                         telemetry=erec, device="cpu").run(trace)
    erec.journal.close()
    assert [r.stats for r in eci] == [r.stats for r in eci_base]
    assert T.load_journal(tmp_path / "e.jsonl")["requests"].shape[1] == 3


# ---------------------------------------------------------------------------
# profile()
# ---------------------------------------------------------------------------

def test_profile_writes_a_trace(tmp_path):
    assert isinstance(T.TelemetryRecorder().profile(),
                      type(T.contextlib.nullcontext()))
    out = tmp_path / "prof"
    rec = T.TelemetryRecorder(profile_dir=out)
    with rec.profile():
        (torch.arange(1000, dtype=torch.float32) * 2).sum()
    files = list(out.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mul" in str(e.get("name", "")) for e in events)
