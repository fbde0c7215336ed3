"""Shared helpers of the classified-controller parity tests: the
scan-heavy mix in both packages, the classifiers, the controllers'
configurations and the comparison of two runs (results, logs, per-class
counts, the journal's per-class columns, final states)."""
from __future__ import annotations

import numpy as np

import repro.classify as JC
from repro.core import EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core import baselines as jbase
from repro.core.policies import Policy as JPolicy
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

import repro_torch.classify as TC
from repro_torch.core import baselines as tbase
from repro_torch.core.controller import EticaConfig, Geometry
from repro_torch.core.policies import Policy
from repro_torch.core.trace import interleave
from repro_torch.traces.generators import make

MIX = ("scan_mix", "hm_1", "backup_scan", "src2_0")   # SCAN_HEAVY_MIX
REQS = 1000


def four_class(M, P):
    """The four-class classifier of ``chip_smoke.py`` phase 14 (b)."""
    return M.Classifier([
        M.IOClass("default"),
        M.IOClass("small_writes", rules=(M.ClassRule(size=(None, 2),
                                                     direction="write"),),
                  ways_frac=0.25, policy=P.WT),
        M.IOClass("vm0_range", rules=(M.ClassRule(lba=(0, 10_000_000)),),
                  weight=0.5),
        M.IOClass("seq_bypass", rules=(M.ClassRule(run_len=(48, None)),),
                  bypass=True)])


CLASSIFIERS = {"seq_cutoff": lambda M, P: M.seq_cutoff(48),
               "four_class": four_class,
               "match_all": lambda M, P: M.match_all()}


def _mixes(reqs=REQS, names=MIX):
    j = jinterleave([jmake(n, reqs, seed=i, addr_offset=i * 10_000_000,
                           scale=0.25) for i, n in enumerate(names)],
                    seed=42)
    t = interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                         scale=0.25) for i, n in enumerate(names)], seed=42)
    return j, t


def _etica_cfgs(clf, **kw):
    common = dict(dram_capacity=400, ssd_capacity=800, resize_interval=2000,
                  promo_interval=500, **kw)
    return (JConfig(geometry_dram=JGeometry(16, 32),
                    geometry_ssd=JGeometry(16, 32),
                    classifier=CLASSIFIERS[clf](JC, JPolicy), **common),
            EticaConfig(geometry_dram=Geometry(16, 32),
                        geometry_ssd=Geometry(16, 32),
                        classifier=CLASSIFIERS[clf](TC, Policy), **common))


def _chassis(pkg, factory, clf, reqs_window=2000, **kw):
    if pkg == "jax":
        return getattr(jbase, factory)(
            800, len(MIX), geometry=JGeometry(16, 32),
            resize_interval=reqs_window, sim_chunk=500,
            classifier=None if clf is None else CLASSIFIERS[clf](JC,
                                                                  JPolicy),
            **kw)
    return getattr(tbase, factory)(
        800, len(MIX), geometry=Geometry(16, 32), resize_interval=reqs_window,
        sim_chunk=500, device="cpu",
        classifier=None if clf is None else CLASSIFIERS[clf](TC, Policy),
        **kw)


def _logs(cache):
    names = ("logs",) if hasattr(cache, "logs") else ("logs_dram",
                                                      "logs_ssd")
    return [[(np.asarray(x.demands).tolist(), np.asarray(x.alloc).tolist(),
              x.policies) for x in getattr(cache, n)] for n in names]


def _states(cache):
    views = (("vm_cache",) if hasattr(cache, "vm_cache")
             else ("vm_dram", "vm_ssd"))
    return [[np.asarray(x) for x in getattr(cache, view)(v)]
            for view in views for v in range(len(cache.stats))]


def _assert_same(jc, jres, tc, tres):
    """Results, logs, per-class counts, journal columns, final states."""
    assert len(jres) == len(tres)
    for v, (a, b) in enumerate(zip(jres, tres)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v
    assert _logs(jc) == _logs(tc)
    assert np.array_equal(jc.cls_hits, tc.cls_hits)
    assert np.array_equal(jc.cls_miss, tc.cls_miss)
    for col in ("cls_hits", "cls_miss", "requests", "bypassed"):
        assert np.array_equal(jc.telemetry.journal.column(col),
                              tc.telemetry.journal.column(col)), col
    for a, b in zip(_states(jc), _states(tc)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
