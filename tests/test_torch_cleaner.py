"""Port parity: the background cleaner vs the JAX package.

``clean_scatter_plain`` and ``_clean_cutoffs`` (what ``repro_torch``
runs on CPU tensors) against the JAX Pallas kernel in interpret mode,
``ops.clean`` and the sequential ``ref.clean_ref``; the fused
maintenance interval's 9-tuple at ``clean_quota`` 0, 1 and 3; and
``EticaCache.run`` with ``clean_quota=4`` (stats, allocation histories,
``clean_log``/``dirty_log`` and the journal) — all exact.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core import popularity as jpop
from repro.core import reuse as jreuse
from repro.core.policies import Policy as JPolicy
from repro.core.simulator import CacheState as JState
from repro.core.trace import interleave as jinterleave
from repro.kernels.maintenance import ops as jops
from repro.kernels.maintenance import ref as jref
from repro.kernels.maintenance.kernel import clean_scatter as jclean_scatter
from repro.traces import make as jmake

from repro_torch.core import popularity as tpop
from repro_torch.core import reuse as treuse
from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.policies import Policy
from repro_torch.core.simulator import CacheState
from repro_torch.core.trace import interleave
from repro_torch.kernels.maintenance import ops as tops
from repro_torch.traces.generators import make


def _state(rng, v, s, w, dirty_frac=0.5, lru_hi=100, set_consistent=False):
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            cand = (rng.permutation(np.arange(j, 8 * s, s)) if set_consistent
                    else rng.permutation(8 * s))
            k = int(rng.integers(0, w + 1))
            tags[i, j, :k] = cand[:k]
    lru = np.where(tags >= 0, rng.integers(0, lru_hi, tags.shape),
                   -1).astype(np.int32)
    dirty = (rng.random(tags.shape) < dirty_frac) & (tags >= 0)
    return tags, lru, dirty


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (dirty_frac, lru_hi, quota range): ragged and tied cases
CASES = {
    "ragged": (0.5, 100, (0, 6)),
    "all_clean": (0.0, 100, (1, 6)),
    "quota_over_candidates": (0.7, 100, (40, 80)),
    "tied_lru": (0.8, 3, (1, 9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", range(3))
def test_clean_matches_jax(case, seed):
    dirty_frac, lru_hi, (qlo, qhi) = CASES[case]
    rng = np.random.default_rng(seed)
    v, s, w = 5, 8, 6
    tags, lru, dirty = _state(rng, v, s, w, dirty_frac, lru_hi)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[0], ways[1] = 0, w
    quota = rng.integers(qlo, qhi, v).astype(np.int32)

    jcut = jops._clean_cutoffs(jnp.asarray(dirty), jnp.asarray(lru),
                               jnp.asarray(ways), jnp.asarray(quota))
    tcut = tops._clean_cutoffs(_t(dirty), _t(lru), _t(ways), _t(quota))
    for i, (a, b) in enumerate(zip(jcut, tcut)):
        assert b.dtype == torch.int32, i
        assert np.array_equal(np.asarray(a), b.numpy()), (case, i)

    jst, jfl, jleft = jops.clean(JState(*map(jnp.asarray, (tags, lru, dirty))),
                                 ways, quota, interpret=True)
    tst, tfl, tleft = tops.clean(CacheState(_t(tags), _t(lru), _t(dirty)),
                                 _t(ways), _t(quota))
    for a, b in zip(jst, tst):
        assert np.array_equal(np.asarray(a), b.numpy()), case
    assert np.array_equal(np.asarray(jfl), tfl.numpy())
    assert np.array_equal(np.asarray(jleft), tleft.numpy())
    rtags, rlru, rdirty, rfl = jref.clean_ref(tags, lru, dirty, ways, quota)
    assert np.array_equal(rdirty, tst.dirty.numpy())
    assert np.array_equal(rfl, tfl.numpy())
    if case == "all_clean":
        assert tfl.sum() == 0
    if case == "tied_lru":
        assert tfl.sum() > 0


@pytest.mark.parametrize("seed", range(4))
def test_clean_scatter_plain_matches_pallas(seed):
    """Arbitrary cutoffs, the sentinel among them, straight into both
    scatters."""
    rng = np.random.default_rng(10 + seed)
    v, s, w = 6, 8, 4
    tags, lru, dirty = _state(rng, v, s, w, 0.6, 20)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    lcut = rng.integers(-1, 21, v).astype(np.int32)
    icut = rng.integers(-1, s * w, v).astype(np.int32)
    lcut[0], icut[0] = -2**31, -1
    jd, jfl = jclean_scatter(jnp.asarray(dirty.astype(np.int32)),
                             jnp.asarray(lru), jnp.asarray(ways),
                             jnp.asarray(lcut), jnp.asarray(icut), ts=s,
                             interpret=True)
    td, tfl = tops.clean_scatter(_t(dirty), _t(lru), _t(ways), _t(lcut),
                                 _t(icut))
    assert np.array_equal(np.asarray(jd).astype(bool), td.numpy())
    assert np.array_equal(np.asarray(jfl), tfl.numpy())
    assert tfl[0] == 0


@pytest.mark.parametrize("clean_quota", [0, 1, 3])
@pytest.mark.parametrize("seed", range(2))
def test_maintenance_third_stage_matches_jax(clean_quota, seed):
    """Three chained fused intervals: state, table and all seven count
    vectors equal JAX's; with the cleaner on, the state and the two
    cleaner counts also equal the 2-stage interval followed by
    ``clean_ref`` with the quota gated on live VMs."""
    rng = np.random.default_rng(300 + seed)
    v, s, w, k = 3, 4, 4, 128
    tags, lru, dirty = _state(rng, v, s, w, set_consistent=True)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[1] = w
    t = rng.integers(0, 50, v).astype(np.int32)
    jst = JState(*map(jnp.asarray, (tags, lru, dirty)))
    tst = CacheState(_t(tags), _t(lru), _t(dirty))
    jtable = jpop.table_init(v, k)
    ttable = tpop.table_init(v, k, device="cpu")
    kw = dict(evict_frac=0.25, decay=0.5)
    for step in range(3):
        lens = [int(rng.integers(0, 40)) for _ in range(v)]
        lens[0] = 0 if step == 1 else lens[0]
        lens[1] = max(lens[1], 1)
        addrs = [rng.integers(0, 32, n).astype(np.int32) for n in lens]
        writes = [rng.random(n) < 0.5 for n in lens]
        amat, wmat = jreuse._pad_rows(addrs, writes, list(range(v)), lens)
        r = jreuse._decompose_vmapped(amat, wmat, policy=JPolicy.WB,
                                      sizing_reads_only=False, chunk=256)
        jargs = (jtable, r.dist, r.served, amat, np.asarray(lens, np.int32),
                 ways, t)
        jout = jops.maintenance_interval(jst, *jargs, clean_quota=clean_quota,
                                         interpret=True, **kw)
        dist, served, _ = treuse.decompose(_t(amat), _t(wmat), Policy.WB,
                                           sizing_reads_only=False)
        tout = tops.maintenance_interval(
            tst, ttable, dist, served, _t(amat),
            torch.tensor(lens, dtype=torch.int32), _t(ways), _t(t),
            clean_quota=clean_quota, **kw)
        for a, b in zip(jout[0], tout[0]):
            assert np.array_equal(np.asarray(a), b.numpy()), step
        assert np.array_equal(np.asarray(jout[1].addr), tout[1].addr.numpy())
        assert np.array_equal(np.asarray(jout[1].val).view(np.int32),
                              tout[1].val.numpy().view(np.int32))
        for i, (a, b) in enumerate(zip(jout[2:], tout[2:])):
            assert np.array_equal(np.asarray(a), b.numpy()), (step, i)
        if clean_quota:
            base = jops.maintenance_interval(jst, *jargs, interpret=True,
                                             **kw)
            live = np.asarray(lens) > 0
            _, _, want_dirty, want_fl = jref.clean_ref(
                base[0].tags, base[0].lru, np.asarray(base[0].dirty), ways,
                np.where(live, clean_quota, 0))
            assert np.array_equal(tout[0].dirty.numpy(), want_dirty)
            assert np.array_equal(tout[7].numpy(), want_fl)
            active = np.arange(w)[None, None, :] < ways[:, None, None]
            assert np.array_equal(
                tout[8].numpy(), (tout[0].dirty.numpy() & active).sum((1, 2)))
        jst, jtable, tst, ttable = jout[0], jout[1], tout[0], tout[1]


NAMES = ["web_3", "stg_1", "src2_0", "hm_1"]


def test_cleaner_run_matches_jax():
    """fig14's cleaner configuration (16x32, DRAM 400 / SSD 800, resize
    2000, promo 500, quota 4) on a 4-VM mix, in both packages."""
    jtrace = jinterleave([jmake(n, 1500, seed=i, addr_offset=i * 10_000_000,
                                scale=0.25) for i, n in enumerate(NAMES)],
                         seed=42)
    ttrace = interleave([make(n, 1500, seed=i, addr_offset=i * 10_000_000,
                              scale=0.25) for i, n in enumerate(NAMES)],
                        seed=42)
    common = dict(dram_capacity=400, ssd_capacity=800, resize_interval=2000,
                  promo_interval=500, clean_quota=4)
    jc = JCache(JConfig(geometry_dram=JGeometry(16, 32),
                        geometry_ssd=JGeometry(16, 32), **common), len(NAMES))
    tc = EticaCache(EticaConfig(geometry_dram=Geometry(16, 32),
                                geometry_ssd=Geometry(16, 32), **common),
                    len(NAMES), device="cpu")
    jres, tres = jc.run(jtrace), tc.run(ttrace)
    for v, (a, b) in enumerate(zip(jres, tres)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v
    assert sum(r.stats["flushes"] for r in tres) > 0
    assert len(jc.clean_log) == len(tc.clean_log) > 0
    for a, b in zip(jc.clean_log + jc.dirty_log, tc.clean_log + tc.dirty_log):
        assert np.array_equal(a, b)
    jj, tj = jc.telemetry.journal, tc.telemetry.journal
    for col in ("cleaned", "dirty_resident", "clean_ran", "flushes",
                "disk_writes", "overloaded"):
        assert np.array_equal(jj.column(col), tj.column(col)), col
