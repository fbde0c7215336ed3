"""Port parity: the one-level chassis' sequential oracle and the global
two-level baselines vs the JAX package.

The chassis batched and sequential for the four factories of
tests/test_baseline_sizing.py (stats, histories, the logs' demands,
allocations and policies, final states), zero ``ref`` calls when
batched, a plain closure metric; FAST and L2ARC on the traces of
tests/test_system.py. Everything exact, float32 bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import Geometry as JGeometry
from repro.core import baselines as jbase
from repro.core.controller import (PartitionedSingleLevelCache as JChassis,
                                   SingleLevelConfig as JSingleLevelConfig)
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

from repro_torch.core import baselines as tbase
from repro_torch.core.controller import (Geometry,
                                         PartitionedSingleLevelCache,
                                         SingleLevelConfig)
from repro_torch.core.trace import interleave
from repro_torch.traces.generators import make


def _mix(reqs):
    names = ["hm_1", "usr_0", "web_3"]
    kw = lambda i: dict(seed=i, addr_offset=i * 10_000_000, scale=0.25)
    return (jinterleave([jmake(n, reqs, **kw(i)) for i, n in
                         enumerate(names)], seed=0),
            interleave([make(n, reqs, **kw(i)) for i, n in
                        enumerate(names)], seed=0))


FACTORIES = ["make_eci_cache", "make_centaur", "make_scave",
             "make_vcacheshare"]


@pytest.mark.parametrize("factory", FACTORIES)
def test_chassis_batched_equals_sequential(factory):
    """tests/test_baseline_sizing.py's chassis check, through both
    packages: stats, histories and the logs' demands, allocations and
    policies."""
    jtrace, ttrace = _mix(1200)
    kw = dict(resize_interval=600, sim_chunk=300)
    jc = getattr(jbase, factory)(120, 3, geometry=JGeometry(8, 16),
                                 batched=False, **kw)
    jres = jc.run(jtrace)
    for batched in (True, False):
        tc = getattr(tbase, factory)(120, 3, geometry=Geometry(8, 16),
                                     batched=batched, device="cpu", **kw)
        tres = tc.run(ttrace)
        for v in range(3):
            assert jres[v].stats == tres[v].stats, (batched, v)
            assert np.array_equal(jres[v].alloc_history,
                                  tres[v].alloc_history)
        assert len(jc.logs) == len(tc.logs)
        for a, b in zip(jc.logs, tc.logs):
            assert np.array_equal(a.demands, b.demands)
            assert np.array_equal(a.alloc, b.alloc)
            assert a.policies == b.policies
        if not batched:
            for v in range(3):
                for x, y in zip(jc.vm_cache(v), tc.vm_cache(v)):
                    assert np.array_equal(np.asarray(x), y.numpy())


def test_zero_ref_calls_when_batched():
    """The batched chassis never calls the per-VM closure; the
    sequential one does."""
    _, ttrace = _mix(1200)
    calls = {"n": 0}

    def run(batched):
        cache = tbase.make_eci_cache(120, 3, geometry=Geometry(8, 16),
                                     resize_interval=600, sim_chunk=300,
                                     batched=batched, device="cpu")
        ref = cache.metric.ref

        def counting_ref(sub):
            calls["n"] += 1
            return ref(sub)

        cache.metric = dataclasses.replace(cache.metric, ref=counting_ref)
        cache.run(ttrace)

    run(batched=True)
    assert calls["n"] == 0
    run(batched=False)
    assert calls["n"] > 0


def test_plain_closure_metric_matches_jax():
    """A plain per-VM closure (no ``batch``) under a batched config runs
    the sequential sizing loop: == the SizingMetric run == JAX."""
    jtrace, ttrace = _mix(1200)
    cfg = dict(capacity=120, resize_interval=600, sim_chunk=300)
    metric = tbase.urd_metric(Geometry(8, 16), device="cpu")
    res = {}
    for m in (metric, metric.ref):
        cache = PartitionedSingleLevelCache(
            SingleLevelConfig(geometry=Geometry(8, 16), **cfg), 3, m,
            tbase.eci_policy(), device="cpu")
        res[m is metric] = cache.run(ttrace)
    jm = jbase.urd_metric(JGeometry(8, 16))
    jres = JChassis(JSingleLevelConfig(geometry=JGeometry(8, 16), **cfg), 3,
                    jm.ref, jbase.eci_policy()).run(jtrace)
    for v in range(3):
        assert res[True][v].stats == res[False][v].stats == jres[v].stats


@pytest.mark.parametrize("factory,args,seed", [
    ("make_fast", (200, 400), 3), ("make_l2arc", (100, 400), 5)])
def test_global_two_level_baselines_match_jax(factory, args, seed):
    """FAST and L2ARC on tests/test_system.py's traces: stats exact."""
    jres = getattr(jbase, factory)(*args).run(
        jmake("hm_1", 3000, seed=seed, scale=0.25))
    tres = getattr(tbase, factory)(*args, device="cpu").run(
        make("hm_1", 3000, seed=seed, scale=0.25))
    assert jres.stats == tres.stats
    assert tres.stats["cache_writes_l2"] > 0
    assert 0 < tres.hit_ratio <= 1
