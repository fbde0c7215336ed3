"""Port parity: the one-level chassis with an IO classifier vs the JAX
package, and the classified controllers' properties.

Centaur and ECI-Cache with ``seq_cutoff(48)`` and with the four-class
classifier of ``test_torch_classified_controller.py``, batched and
sequential: per-VM stats, allocation histories, the logs (policies
included), per-class counts, the journal's per-class columns and the
final states equal to the reference's. A match-all classifier equals
``classifier=None`` in every mode of both controllers. The properties of
``tests/test_classify.py`` on the port (bypass never allocates, an
exclusive slice holds only its class, a policy override reaches the
datapath); ``hit_counts_at_sizes_weighted`` against the reference's with
non-dyadic weights; classifiers that are not the port's raise
``TypeError``.
"""
import dataclasses

import numpy as np
import pytest

import repro.classify as JC
import repro_torch.classify as TC
from repro_torch.core import baselines as tbase
from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.policies import Policy
from repro_torch.core.trace import Trace

from classified_parity import (MIX, _assert_same, _chassis, _etica_cfgs,
                               _logs, _mixes, _states)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("factory", ["make_centaur", "make_eci_cache"])
@pytest.mark.parametrize("clf", ["seq_cutoff", "four_class"])
def test_chassis_classified_equals_jax(clf, factory, batched):
    jtrace, ttrace = _mixes()
    jc = _chassis("jax", factory, clf, batched=batched)
    tc = _chassis("torch", factory, clf, batched=batched)
    _assert_same(jc, jc.run(jtrace), tc, tc.run(ttrace))
    assert sum(d["bypassed"] for d in tc.stats) > 0


def test_match_all_equals_no_classifier():
    """A match-all classifier == ``classifier=None``, every mode of both
    controllers (stats, histories, logs, final states)."""
    _, ttrace = _mixes(500)
    for mode in (dict(), dict(fused_maintenance=False), dict(batched=False),
                 dict(clean_quota=2)):
        cfg = _etica_cfgs("match_all", **mode)[1]
        ma = EticaCache(cfg, len(MIX), device="cpu")
        base = EticaCache(dataclasses.replace(cfg, classifier=None),
                          len(MIX), device="cpu")
        rb, rm = base.run(ttrace), ma.run(ttrace)
        for a, b in zip(rb, rm):
            assert a.stats == b.stats
            assert np.array_equal(a.alloc_history, b.alloc_history)
        assert _logs(base) == _logs(ma)
        for a, b in zip(_states(base), _states(ma)):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    for factory in ("make_centaur", "make_eci_cache"):
        for batched in (True, False):
            base = _chassis("torch", factory, None, batched=batched)
            ma = _chassis("torch", factory, "match_all", batched=batched)
            for a, b in zip(base.run(ttrace), ma.run(ttrace)):
                assert a.stats == b.stats
            assert _logs(base) == _logs(ma)


def _small_mix(seed=0, v=3, n=1500):
    rng = np.random.default_rng(seed)
    return Trace(addr=rng.integers(0, 300, n).astype(np.int32),
                 is_write=rng.random(n) < 0.4,
                 vm=rng.integers(0, v, n).astype(np.int32)), v


GEO8 = Geometry(num_sets=8, max_ways=16)


def _small(kind, classifier, v, batched):
    if kind == "etica":
        cfg = EticaConfig(dram_capacity=48, ssd_capacity=96,
                          geometry_dram=GEO8, geometry_ssd=GEO8,
                          resize_interval=1000, promo_interval=250,
                          batched=batched, classifier=classifier)
        return EticaCache(cfg, v, device="cpu")
    return tbase.make_centaur(96, v, geometry=GEO8, resize_interval=1000,
                              sim_chunk=250, batched=batched,
                              classifier=classifier, device="cpu")


@pytest.mark.parametrize("batched", [True, False])
def test_bypass_class_never_allocates(batched):
    trace, v = _small_mix(5)
    bypass_all = TC.Classifier([
        TC.IOClass("default"),
        TC.IOClass("void", rules=(TC.ClassRule(),), bypass=True)])
    for kind in ("etica", "chassis"):
        cache = _small(kind, bypass_all, v, batched)
        for r in cache.run(trace):
            s = r.stats
            assert s["bypassed"] == s["reads"] + s["writes"]
            assert s["read_hits_l1"] == s["read_hits_l2"] == 0
            assert s["write_hits_l2"] == 0
            assert s["cache_writes_l2"] == 0
            assert s["disk_reads"] == s["reads"]
            assert s["disk_writes"] >= s["writes"]
        assert not cache.cls_hits.any() and not cache.cls_miss.any()


def test_exclusive_slice_holds_only_its_class():
    """A class with an exclusive ``ways_frac`` slice inserts only there,
    and the other classes only below it (the chassis, all writes in the
    top class are distinct, so the slice's tags are its own)."""
    rng = np.random.default_rng(6)
    n = 2000
    addr = rng.integers(0, 400, n).astype(np.int32)
    hot = rng.random(n) < 0.3
    addr[hot] = 10_000 + rng.integers(0, 200, int(hot.sum()))
    trace = Trace(addr, rng.random(n) < 0.5, vm=np.zeros(n, np.int32))
    clf = TC.Classifier([
        TC.IOClass("default"),
        TC.IOClass("hot", rules=(TC.ClassRule(lba=(10_000, None)),),
                   ways_frac=0.5)])
    cache = _small("chassis", clf, 1, True)
    cache.run(trace)
    tags = cache.vm_cache(0).tags.numpy()
    ways = int(cache.ways[0])
    lo, hi = clf.way_bounds(np.asarray([ways]))
    top = tags[:, lo[0, 1]:hi[0, 1]]
    pool = tags[:, :lo[0, 1]]
    assert ((top >= 10_000) | (top < 0)).all()
    assert ((pool < 10_000)).all()
    assert (top >= 10_000).any() and (pool >= 0).any()


def test_policy_override_reaches_the_datapath():
    """A WT override on the default class turns a WB chassis's writes
    into write-through ones: every write also goes to disk, so disk
    writes rise above the unclassified WB run's and reach the writes."""
    trace, v = _small_mix(8)
    wt_all = TC.Classifier([TC.IOClass("default", policy=Policy.WT)])
    kw = dict(geometry=GEO8, resize_interval=1000, sim_chunk=250,
              device="cpu")
    res_g = tbase.make_centaur(96, v, classifier=wt_all, **kw).run(trace)
    res_w = tbase.make_centaur(96, v, **kw).run(trace)
    for g, w in zip(res_g, res_w):
        assert g.stats["disk_writes"] >= g.stats["writes"]
        assert g.stats["disk_writes"] > w.stats["disk_writes"]
    pol = wt_all.vm_policies([Policy.WB, Policy.RO])
    assert pol == [[Policy.WT], [Policy.WT]]


def test_hit_counts_weighted_equal_the_reference():
    from repro.core import reuse as jreuse
    from repro_torch.core import reuse as treuse
    rng = np.random.default_rng(9)
    n = 5000
    dist = rng.integers(-1, 3000, n).astype(np.int32)
    served = rng.random(n) < 0.7
    sizes = np.arange(0, 4096, 256).astype(np.int64)
    w = rng.choice([0.3, 1.0, 0.7, 1 / 3], n)
    got = treuse.hit_counts_at_sizes_weighted(dist, served, sizes, w)
    want = jreuse.hit_counts_at_sizes_weighted(dist, served, sizes, w)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.int64), np.asarray(want).view(np.int64))
    ones = treuse.hit_counts_at_sizes_weighted(dist, served, sizes,
                                               np.ones(n))
    assert np.array_equal(ones, treuse.hit_counts_at_sizes(dist, served,
                                                           sizes))


@pytest.mark.parametrize("bad", [object(), "jax"])
def test_foreign_classifiers_raise_type_error(bad):
    clf = JC.seq_cutoff(8) if bad == "jax" else bad
    _, tcfg = _etica_cfgs("seq_cutoff")
    with pytest.raises(TypeError, match="repro_torch.classify"):
        EticaCache(dataclasses.replace(tcfg, classifier=clf), 2,
                   device="cpu")
    with pytest.raises(TypeError, match="repro_torch.classify"):
        tbase.make_centaur(100, 2, classifier=clf, device="cpu")


