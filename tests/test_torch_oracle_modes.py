"""Port parity: ETICA's staged and sequential oracle modes vs the JAX
package.

The port's three maintenance modes (fused, staged, sequential) against
the JAX package's three on the mix of tests/test_maintenance_ops.py
(stats, allocation histories, final DRAM and SSD states, journal rows)
and on the cleaner mix of tests/test_cleaner.py. Everything exact,
float32 bit for bit.
"""
import numpy as np

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.trace import interleave
from repro_torch.traces.generators import make

MODES = {"fused": {}, "staged": dict(fused_maintenance=False),
         "sequential": dict(batched=False)}


def _mix(names, reqs, mix_seed=0):
    kw = lambda i: dict(seed=i, addr_offset=i * 10_000_000, scale=0.25)
    return (jinterleave([jmake(n, reqs, **kw(i)) for i, n in
                         enumerate(names)], seed=mix_seed),
            interleave([make(n, reqs, **kw(i)) for i, n in
                        enumerate(names)], seed=mix_seed))


def _run_modes(jtrace, ttrace, num_vms, **base):
    """Each mode through both packages; returns ``{mode: (jax cache, jax
    results, port cache, port results)}``."""
    out = {}
    for mode, kw in MODES.items():
        jc = JCache(JConfig(geometry_dram=JGeometry(8, 16),
                            geometry_ssd=JGeometry(8, 16), **base, **kw),
                    num_vms)
        tc = EticaCache(EticaConfig(geometry_dram=Geometry(8, 16),
                                    geometry_ssd=Geometry(8, 16), **base,
                                    **kw), num_vms, device="cpu")
        out[mode] = jc, jc.run(jtrace), tc, tc.run(ttrace)
    return out


def _assert_same(want, got, num_vms, states=True):
    jc, jres, tc, tres = want[0], want[1], got[2], got[3]
    for v in range(num_vms):
        assert jres[v].stats == tres[v].stats, v
        assert np.array_equal(jres[v].alloc_history, tres[v].alloc_history)
        if states:
            for level in ("vm_ssd", "vm_dram"):
                for x, y in zip(getattr(jc, level)(v),
                                getattr(tc, level)(v)):
                    assert np.array_equal(np.asarray(x), y.numpy()), \
                        (level, v)


def test_three_modes_match_jax():
    """tests/test_maintenance_ops.py's mix: port fused == staged ==
    sequential == JAX's three modes; the journal rows too."""
    jtrace, ttrace = _mix(["hm_1", "usr_0", "web_3"], 2000)
    runs = _run_modes(jtrace, ttrace, 3, dram_capacity=60, ssd_capacity=120,
                      resize_interval=1000, promo_interval=250, mode="full")
    assert sum(r.stats["cache_writes_l2"] for r in runs["fused"][3]) > 0
    for mode in MODES:
        _assert_same(runs[mode], runs[mode], 3)       # port == JAX, same mode
        _assert_same(runs["sequential"], runs[mode], 3)
        jj, tj = runs[mode][0].telemetry.journal, \
            runs[mode][2].telemetry.journal
        assert len(jj) == len(tj) > 0
        for col in ("requests", "hits", "ssd_writes", "promoted",
                    "evict_queue", "alloc_l2"):
            assert np.array_equal(jj.column(col), tj.column(col)), \
                (mode, col)
    assert runs["staged"][2].pop_table is None
    assert runs["sequential"][2].pop_table is None


def test_three_modes_match_jax_with_cleaner():
    """tests/test_cleaner.py's mix with clean_quota=3: flushes,
    dirty_resident and evict_flushes equal across the six runs; the
    cleaner's log rows where the batched modes recorded them (the
    sequential oracle records none, as in the reference)."""
    jtrace, ttrace = _mix(["hm_1", "usr_0"], 1200, mix_seed=42)
    runs = _run_modes(jtrace, ttrace, 2, dram_capacity=40, ssd_capacity=80,
                      resize_interval=600, promo_interval=200, clean_quota=3)
    assert sum(r.stats["flushes"] for r in runs["fused"][3]) > 0
    for mode in MODES:
        _assert_same(runs[mode], runs[mode], 2)
        _assert_same(runs["sequential"], runs[mode], 2)
        jc, tc = runs[mode][0], runs[mode][2]
        assert len(jc.clean_log) == len(tc.clean_log)
        for a, b in zip(jc.clean_log, tc.clean_log):
            assert np.array_equal(a, b)
    assert len(runs["staged"][2].clean_log) > 0
    assert len(runs["sequential"][2].clean_log) == 0
