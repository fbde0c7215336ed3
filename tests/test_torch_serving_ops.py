"""Port parity: the parts of the two-tier KV serving slice vs the JAX
package, on the CPU.

The session churn generator (same events for a seed), ``size_grid`` and
``quota_with_floor``, ``pod_distances`` on random windows (exact), the
fused ``serving_maintenance`` interval (table bit for bit, drops,
eviction order, takes and cleaner picks exact, with and without the
cleaner), a materialized run with decode (pools bit-equal in float32
and bfloat16, Stats equal), the serving exporter (``render_serving``
byte for byte; ``collect_telemetry(prefix="etica_serving",
label="tenant")`` equal but for the span histogram's help text), the
live scrape endpoint, and ``serve.main`` on the CPU.
"""
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.core import popularity as jpop
from repro.core import reuse as jreuse
from repro.core.partition import size_grid as jsize_grid
from repro.core.policies import Policy as JPolicy
from repro.kernels.maintenance.ops import serving_maintenance as jserving
from repro.kvcache import TwoTierConfig as JConfig
from repro.kvcache import TwoTierKVManager as JManager
from repro.kvcache import quota_with_floor as jquota
from repro.launch.serve import run_events as jrun_events
from repro.runtime import metrics as jmetrics
from repro.traces import SessionSpec as JSpec
from repro.traces import generate_sessions as jgenerate

from repro_torch import configs as port_configs
from repro_torch.core import popularity as pop
from repro_torch.core import reuse
from repro_torch.core.partition import size_grid
from repro_torch.core.policies import Policy
from repro_torch.kernels.maintenance.ops import serving_maintenance
from repro_torch.kvcache import (TwoTierConfig, TwoTierKVManager,
                                 quota_with_floor)
from repro_torch.launch import serve
from repro_torch.runtime import metrics
from repro_torch.runtime.http import MetricsServer
from repro_torch.runtime.telemetry import load_journal
from repro_torch.traces.generators import SessionSpec, generate_sessions
from serving_parity import CFG, churn_trace, replay


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_sessions_matches(seed):
    for spec in (dict(num_tenants=3, target_live=64, max_pages=5,
                      lifetime=25),
                 dict(num_tenants=4, target_live=1024, max_pages=6,
                      tenant_weights=(1, 2, 3, 4))):
        j = jgenerate(JSpec(**spec), 6000, seed=seed)
        t = generate_sessions(SessionSpec(**spec), 6000, seed=seed)
        for f in ("kind", "sid", "tenant"):
            a, b = getattr(j, f), getattr(t, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (t.num_sessions, t.max_live) == (j.num_sessions, j.max_live)


def test_size_grid_and_quota_floor_match():
    for cap in (0, 1, 7, 24, 50, 512, 1000):
        for points in (1, 16, 33):
            assert np.array_equal(size_grid(cap, points),
                                  jsize_grid(cap, points))
    rng = np.random.default_rng(0)
    for _ in range(50):
        t = int(rng.integers(1, 7))
        alloc = rng.integers(0, 40, t)
        cap = int(rng.integers(0, 60))
        assert np.array_equal(quota_with_floor(alloc, cap),
                              jquota(alloc, cap))


@pytest.mark.parametrize("policy", ["RO", "WB", "WBWO"])
def test_pod_distances_exact(policy):
    rng = np.random.default_rng(len(policy))
    for n in (1, 37, 256, 700):
        addr = rng.integers(0, max(n // 3, 2), n).astype(np.int32)
        wr = rng.random(n) < 0.35
        j = jreuse.pod_distances(addr, wr, JPolicy[policy])
        t = reuse.pod_distances(addr, wr, Policy[policy], "cpu")
        for f in ("dist", "served", "touch"):
            assert np.array_equal(getattr(t, f), np.asarray(getattr(j, f)))
        td = reuse.pod_distances(addr, wr, Policy[policy], "cpu", host=False)
        assert torch.equal(td.dist, torch.from_numpy(t.dist))


def test_tracker_and_block_scores_match():
    """The oracle's numpy tracker: the same float32 bits after windows of
    Eq. 1 contributions with decay, and the same block sums."""
    rng = np.random.default_rng(3)
    jt, tt = jpop.PopularityTracker(0.5), pop.PopularityTracker(0.5)
    for n in (50, 200, 7, 300):
        addr = rng.integers(0, 80, n)
        contrib = rng.random(n).astype(np.float32)
        ja, jv = jpop.block_scores(addr, contrib)
        ta, tv = pop.block_scores(addr, contrib)
        assert np.array_equal(ja, ta) and np.array_equal(jv.view(np.int32),
                                                         tv.view(np.int32))
        jt.update(addr, contrib)
        tt.update(addr, contrib)
        assert np.array_equal(jt._addr, tt._addr) and len(tt) == len(jt)
        assert np.array_equal(jt._val.view(np.int32), tt._val.view(np.int32))
        q = rng.integers(0, 100, 40)
        assert np.array_equal(jt.scores_for(q), tt.scores_for(q))


def test_arch_kv_geometry_matches_the_configs():
    """serve's KV geometry for every --arch (from the port's copy of the
    configurations) equals what the reference derives from each reduced
    configuration."""
    assert port_configs.ARCH_IDS == configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        c = configs.get_reduced(arch)
        assert serve.kv_geometry(port_configs.get_reduced(arch)) == \
            (max(c.num_kv_heads, 1), max(c.head_dim, 8)), arch


def _maint_inputs(rng, t_axis, n, dmax):
    waddr = rng.integers(0, 60, n).astype(np.int32)
    wtenant = (waddr % t_axis).astype(np.int32)
    wr = rng.random(n) < 0.3
    per = [rng.permutation(np.arange(t, 60, t_axis))[:rng.integers(0, 9)]
           for t in range(t_axis)]
    smax = max(max(len(p) for p in per), 1)
    cand_sid = np.full((t_axis, smax), -1, np.int32)
    cand_pages = np.zeros((t_axis, smax), np.int32)
    for t, p in enumerate(per):
        cand_sid[t, :len(p)] = p
        cand_pages[t, :len(p)] = rng.integers(1, 5, len(p))
    over = rng.integers(-3, 12, t_axis).astype(np.int32)
    ages = rng.permutation(4 * t_axis * dmax)[:t_axis * dmax]
    dirty_age = np.where(rng.random(t_axis * dmax) < 0.7, ages, -1).astype(
        np.int32).reshape(t_axis, dmax)
    return waddr, wtenant, wr, cand_sid, cand_pages, over, dirty_age


@pytest.mark.parametrize("quota", [0, 2])
def test_serving_maintenance_exact(quota):
    rng = np.random.default_rng(quota)
    t_axis, k = 3, 64
    jt = jpop.table_init(t_axis, k)
    tt = pop.table_init(t_axis, k, "cpu")
    for n in (90, 300, 40):               # three intervals carry the table
        waddr, wten, wr, cs, cp, over, dage = _maint_inputs(rng, t_axis, n,
                                                            11)
        jr = jreuse.pod_distances(waddr, wr, JPolicy.RO)
        jt, *jout = jserving(jt, jr.dist, jr.served, waddr, wten, cs, cp,
                             over, 37, decay=0.5, dirty_age=dage,
                             clean_quota=quota)
        r = reuse.pod_distances(waddr, wr, Policy.RO, "cpu", host=False)
        tt, *tout = serving_maintenance(
            tt, r.dist, r.served, *map(torch.from_numpy, (
                waddr, wten, cs, cp, over)),
            torch.tensor([37.0]), decay=0.5,
            dirty_age=torch.from_numpy(dage), clean_quota=quota)
        assert np.array_equal(tt.addr.numpy(), np.asarray(jt.addr))
        assert np.array_equal(tt.val.numpy().view(np.int32),
                              np.asarray(jt.val).view(np.int32))
        for a, b in zip(tout, jout):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert int(tout[2].sum()) > 0             # some eviction taken
        assert (int(tout[3].sum()) > 0) == (quota > 0)
    assert (tt.val > 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialized_run_with_decode(dtype):
    """Pools, Stats and placements equal after a run that copies pages
    up and decodes (the JAX kernel in interpret mode; the port's plain
    version on the CPU)."""
    kw = dict(CFG, page_size=4, hbm_pages=12, materialize=True, dtype=dtype)
    trace = churn_trace(4, n=500, target_live=16)
    bank = np.random.default_rng(7).normal(
        size=(8, 1, 4, CFG["num_kv_heads"], CFG["head_dim"])).astype(
            np.float32)
    jm = JManager(JConfig(**kw), 3)
    tm = TwoTierKVManager(TwoTierConfig(**kw), 3, device="cpu")
    jrun_events(jm, trace, bank, bank, decode_every=9, seed=0)
    tb = torch.from_numpy(bank)
    serve.run_events(tm, trace, tb, tb, decode_every=9, seed=0)
    assert tm.stats.as_dict() == jm.stats.as_dict()
    assert dict(tm.slot_owner) == dict(jm.slot_owner)
    for tp, jp in ((tm.k_pool, jm.k_pool), (tm.v_pool, jm.v_pool)):
        assert str(tp.dtype) == f"torch.{dtype}"
        assert np.array_equal(tp.float().numpy(),
                              np.asarray(jnp.asarray(jp, jnp.float32)))


@pytest.fixture(scope="module")
def served_pair():
    trace = churn_trace(6, n=800)
    jm = replay(JManager(JConfig(**CFG, clean_quota=2), 3), trace)
    tm = replay(TwoTierKVManager(TwoTierConfig(**CFG, clean_quota=2), 3,
                                 device="cpu"), trace)
    return jm, tm


def test_serving_exposition_matches(served_pair):
    jm, tm = served_pair
    text = metrics.render_serving(tm)
    assert text == jmetrics.render_serving(jm)
    assert metrics.parse_exposition(text) == jmetrics.parse_exposition(text)
    assert tm.stats.flushes > 0
    kw = dict(prefix="etica_serving", label="tenant")
    tl = metrics.render(metrics.collect_telemetry(tm.telemetry,
                                                  **kw)).splitlines()
    jl = jmetrics.render(jmetrics.collect_telemetry(jm.telemetry,
                                                    **kw)).splitlines()
    assert len(tl) == len(jl)
    # the port's span timers wait on CUDA events, and its help text says so
    assert [a for a, b in zip(tl, jl) if a != b] == [
        next(x for x in tl
             if x.startswith("# HELP etica_serving_dispatch_seconds"))]
    fams = metrics.parse_exposition("\n".join(tl) + "\n")
    assert fams["etica_serving_telemetry_intervals_total"]["samples"][
        ()] == len(tm.telemetry.journal)
    assert set(fams["etica_serving_overloaded"]["samples"]) == {
        (("tenant", str(t)),) for t in range(3)}


def test_metrics_server_scrape(served_pair):
    _, tm = served_pair
    with MetricsServer(lambda: metrics.collect_serving(tm)) as srv:
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        health = urllib.request.urlopen(srv.url.replace("/metrics",
                                                        "/healthz"),
                                        timeout=10).read()
    assert body == metrics.render_serving(tm) and health == b"ok\n"


def test_serve_main_on_cpu(tmp_path):
    """The CLI end to end on the CPU: decode included, scrape endpoint
    and journal on; its Stats equal a JAX manager's on the same
    trace."""
    journal = tmp_path / "journal.jsonl"
    argv = ["--events", "700", "--live", "24", "--hbm-pages", "16",
            "--decode-every", "7", "--device", "cpu", "--metrics-port", "0",
            "--journal", str(journal), "--spans"]
    stats = serve.main(argv)
    rows = load_journal(journal)
    assert len(rows["requests"]) > 0
    assert rows["requests"].sum() <= stats["activations"]
    jcfg = JConfig(page_size=16, hbm_pages=16, num_kv_heads=2, head_dim=16,
                   num_layers=1, dtype="float32", materialize=False)
    jm = JManager(jcfg, 4)
    bank = np.zeros((1, 1, 16, 2, 16), np.float32)
    jrun_events(jm, jgenerate(JSpec(num_tenants=4, target_live=24,
                                    max_pages=6), 700, seed=0),
                bank, bank)
    assert stats == jm.stats.as_dict()
    assert serve.main(argv[:-5] + ["--manager", "lru"])["activations"] == \
        stats["activations"]
