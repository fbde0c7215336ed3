"""Port parity: the Prometheus exporter vs ``repro.runtime.metrics``.

``render_cache`` of the port's cleaner run and ECI-Cache run is byte
for byte the JAX package's text for the matching JAX runs; the strict
parser rejects what the reference's rejects; the telemetry families
render and parse.
"""
import numpy as np
import pytest

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core import baselines as jbase
from repro.core.trace import interleave as jinterleave
from repro.runtime import metrics as jmetrics
from repro.traces import make as jmake

from repro_torch.core import baselines as tbase
from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.trace import interleave
from repro_torch.runtime import metrics
from repro_torch.runtime.telemetry import TelemetryRecorder
from repro_torch.traces.generators import make

NAMES = ["web_3", "stg_1", "rsrch_0"]


def _mix(reqs=1000):
    j = jinterleave([jmake(n, reqs, seed=i, addr_offset=i * 10_000_000,
                           scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    t = interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                         scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    return j, t


def test_render_cache_is_byte_identical():
    jtrace, ttrace = _mix()
    common = dict(dram_capacity=300, ssd_capacity=600, resize_interval=1500,
                  promo_interval=500, clean_quota=4)
    jc = JCache(JConfig(geometry_dram=JGeometry(16, 32),
                        geometry_ssd=JGeometry(16, 32), **common), 3)
    tc = EticaCache(EticaConfig(geometry_dram=Geometry(16, 32),
                                geometry_ssd=Geometry(16, 32), **common), 3,
                    device="cpu")
    jres, tres = jc.run(jtrace), tc.run(ttrace)
    text = metrics.render_cache(tc)
    assert text == jmetrics.render_cache(jc)
    fams = metrics.parse_exposition(text)
    assert fams == jmetrics.parse_exposition(text)
    for v, r in enumerate(tres):
        assert fams["etica_flushes_total"]["samples"][
            (("vm", str(v)),)] == r.stats["flushes"] == jres[v].stats[
                "flushes"]
    assert sum(r.stats["flushes"] for r in tres) > 0

    je = jbase.make_eci_cache(900, 3, geometry=JGeometry(16, 32),
                              resize_interval=1500)
    te = tbase.make_eci_cache(900, 3, geometry=Geometry(16, 32),
                              resize_interval=1500, device="cpu")
    je.run(jtrace)
    te.run(ttrace)
    assert metrics.render_cache(te) == jmetrics.render_cache(je)


def test_collect_telemetry_renders_and_parses():
    _, ttrace = _mix(400)
    rec = TelemetryRecorder(span_timing=True)
    cfg = EticaConfig(dram_capacity=100, ssd_capacity=200,
                      geometry_dram=Geometry(8, 16),
                      geometry_ssd=Geometry(8, 16), resize_interval=600,
                      promo_interval=200, clean_quota=2, telemetry=rec)
    EticaCache(cfg, 3, device="cpu").run(ttrace)
    fams = metrics.parse_exposition(metrics.render(
        metrics.collect_telemetry(rec)))
    hist = fams["etica_dispatch_seconds"]["samples"]
    assert hist[("count", ("span", "datapath"))] == rec.spans["datapath"].n
    assert fams["etica_telemetry_intervals_total"]["samples"][()] == len(
        rec.journal)
    last = rec.journal.last_row()
    for v in range(3):
        assert fams["etica_interval_requests"]["samples"][
            (("vm", str(v)),)] == float(last["requests"][v])


@pytest.mark.parametrize("bad", [
    "orphan_sample 1\n",                                   # no # TYPE
    "# TYPE a counter\na 1\na 1\n",                        # duplicate
    "# TYPE a counter\na{x=1} 1\n",                        # unquoted label
    "# TYPE a counter\n# TYPE b counter\na 1\n",           # outside block
    "# TYPE a histogram\na 1\n",                           # bare histogram
])
def test_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jmetrics.parse_exposition(bad)
    with pytest.raises(ValueError):
        metrics.parse_exposition(bad)


def test_render_rejects_bad_families():
    for m in (metrics.Metric("bad name", "counter", "h"),
              metrics.Metric("m", "summary", "h"),
              metrics.Metric("m", "histogram", "h").add({}, 1),
              metrics.Metric("m", "counter", "h").add({"0bad": "x"}, 1)):
        with pytest.raises(ValueError):
            metrics.render([m])
    hv = metrics.HistogramValue((0.1, 1.0), (1, 2, 3), 4.5)
    text = metrics.render([metrics.Metric("h", "histogram", "x").add(
        {"span": "a"}, hv)])
    assert text == jmetrics.render([jmetrics.Metric("h", "histogram", "x").add(
        {"span": "a"}, jmetrics.HistogramValue((0.1, 1.0), (1, 2, 3), 4.5))])
    assert np.isclose(metrics.parse_exposition(text)["h"]["samples"][
        ("sum", ("span", "a"))], 4.5)
