"""Port parity: per-class telemetry and metrics vs the JAX package.

Mirrors the seeded run of ``tests/test_metrics_export.py`` (a tiny
popularity table that overflows, long sequential scans that trip
``seq_cutoff(8)``, the cleaner) through both packages: the port's
``render(collect_cache(cache))`` is byte for byte the reference's text
(the ``etica_class_requests_total{vm, io_class, result}`` family
included), its counts reconcile with the scalar stats, and the
journal's per-interval ``cls_hits`` / ``cls_miss`` delta columns equal
the reference's; likewise ECI-Cache under a four-class classifier.
"""
import numpy as np

from repro.classify import seq_cutoff as jseq_cutoff
from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry, Trace as JTrace
from repro.core import baselines as jbase
from repro.core.policies import Policy as JPolicy
from repro.core.trace import interleave as jinterleave
from repro.runtime import metrics as jmetrics
from repro.traces import make as jmake

import repro.classify as JC
import repro_torch.classify as TC
from repro_torch.core import baselines as tbase
from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.policies import Policy
from repro_torch.core.trace import Trace, interleave
from repro_torch.runtime import metrics
from repro_torch.traces.generators import make


def _traces():
    """tests/test_metrics_export.py's seeded mix, in both packages."""
    runs = [np.arange(50_000 + i * 500, 50_000 + i * 500 + 24,
                      dtype=np.int32) for i in range(10)]
    seq = np.concatenate(runs)
    out = []
    for inter, mk, tr in ((jinterleave, jmake, JTrace),
                          (interleave, make, Trace)):
        mix = inter([mk(n, 1200, seed=i, addr_offset=i * 10_000_000,
                        scale=0.25)
                     for i, n in enumerate(["hm_1", "web_3"])], seed=42)
        out.append(tr(addr=np.concatenate([np.asarray(mix.addr), seq]),
                      is_write=np.concatenate([np.asarray(mix.is_write),
                                               np.zeros(len(seq), bool)]),
                      vm=np.concatenate([np.asarray(mix.vm),
                                         np.full(len(seq), 0, np.int32)])))
    return out


def _same_journal(jc, tc):
    jj, tj = jc.telemetry.journal, tc.telemetry.journal
    assert len(jj) == len(tj) > 0
    for col in ("cls_hits", "cls_miss", "bypassed", "requests", "hits"):
        a, b = jj.column(col), tj.column(col)
        assert a.shape == b.shape and np.array_equal(a, b), col


def test_seeded_run_exports_exact_class_counts_as_the_reference():
    jtrace, ttrace = _traces()
    common = dict(dram_capacity=40, ssd_capacity=80, resize_interval=600,
                  promo_interval=200, pop_capacity=8, clean_quota=2)
    jc = JCache(JConfig(geometry_dram=JGeometry(8, 16),
                        geometry_ssd=JGeometry(8, 16),
                        classifier=jseq_cutoff(8), **common), 2)
    tc = EticaCache(EticaConfig(geometry_dram=Geometry(8, 16),
                                geometry_ssd=Geometry(8, 16),
                                classifier=TC.seq_cutoff(8), **common), 2,
                    device="cpu")
    jres, res = jc.run(jtrace), tc.run(ttrace)
    text = metrics.render(metrics.collect_cache(tc))
    assert text == jmetrics.render(jmetrics.collect_cache(jc))
    assert text == metrics.render_cache(tc)
    fams = metrics.parse_exposition(text)
    total_byp = 0
    for v in range(2):
        s = res[v].stats
        assert s == jres[v].stats
        assert fams["etica_bypassed_total"]["samples"][
            (("vm", str(v)),)] == s["bypassed"]
        cs = fams["etica_class_requests_total"]["samples"]
        hits = sum(cs[k] for k in cs
                   if (("vm", str(v)) in k and ("result", "hit") in k))
        miss = sum(cs[k] for k in cs
                   if (("vm", str(v)) in k and ("result", "miss") in k))
        assert hits == s["read_hits_l1"] + s["read_hits_l2"] + \
            s["write_hits_l2"]
        assert hits + miss == s["reads"] + s["writes"] - s["bypassed"]
        total_byp += s["bypassed"]
    assert total_byp > 0
    assert sum(r.stats["pop_drops"] for r in res) > 0
    _same_journal(jc, tc)
    # as in the reference, each row's "delta" is the cumulative count:
    # TelemetryRecorder._deltas replaces the dict that keeps the previous
    # per-class counts (ROADMAP Queue 3 lists it as a reference fault)
    assert np.array_equal(tc.telemetry.journal.column("cls_hits")[-1],
                          tc.cls_hits)


def test_chassis_four_class_exports_as_the_reference():
    jtrace, ttrace = _traces()

    def four(M, P):
        return M.Classifier([
            M.IOClass("default"),
            M.IOClass("small_writes", rules=(M.ClassRule(
                size=(None, 2), direction="write"),), ways_frac=0.25,
                policy=P.WT),
            M.IOClass("vm0", rules=(M.ClassRule(lba=(0, 10_000_000)),),
                      weight=0.5),
            M.IOClass("seq_bypass", rules=(M.ClassRule(run_len=(8, None)),),
                      bypass=True)])
    jc = jbase.make_eci_cache(120, 2, geometry=JGeometry(8, 16),
                              resize_interval=600, sim_chunk=200,
                              classifier=four(JC, JPolicy))
    tc = tbase.make_eci_cache(120, 2, geometry=Geometry(8, 16),
                              resize_interval=600, sim_chunk=200,
                              classifier=four(TC, Policy), device="cpu")
    jc.run(jtrace)
    tc.run(ttrace)
    text = metrics.render(metrics.collect_cache(tc))
    assert text == jmetrics.render(jmetrics.collect_cache(jc))
    assert "etica_class_requests_total" in text
    _same_journal(jc, tc)


def test_no_classifier_has_no_class_family():
    _, ttrace = _traces()
    tc = tbase.make_centaur(120, 2, geometry=Geometry(8, 16),
                            resize_interval=600, sim_chunk=200, device="cpu")
    tc.run(ttrace)
    assert "class_requests" not in metrics.render_cache(tc)
    assert "cls_hits" not in tc.telemetry.journal.columns
