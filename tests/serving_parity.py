"""Shared helpers of the serving parity tests (``test_torch_serving*.py``):
the same churn trace from both packages' generators, a replay loop,
and the comparisons of a JAX manager with a port manager."""
import numpy as np

from repro.kvcache import TwoTierConfig as JConfig
from repro.kvcache import TwoTierKVManager as JManager
from repro.traces import SessionSpec as JSpec
from repro.traces import generate_sessions as jgenerate

from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
from repro_torch.traces.generators import (SESSION_ACTIVATE, SESSION_APPEND,
                                           SESSION_END, SESSION_NEW,
                                           SessionSpec, generate_sessions)

CFG = dict(page_size=8, hbm_pages=24, num_kv_heads=2, head_dim=4,
           num_layers=1, dtype="float32", maintenance_interval=16,
           resize_interval=64, pop_capacity=128, materialize=False)
SPEC = dict(num_tenants=3, target_live=48, max_pages=4, lifetime=20)


def churn_trace(seed, n=1500, **spec):
    spec = SPEC | spec
    j = jgenerate(JSpec(**spec), n, seed=seed)
    t = generate_sessions(SessionSpec(**spec), n, seed=seed)
    assert all(np.array_equal(getattr(j, f), getattr(t, f))
               for f in ("kind", "sid", "tenant"))
    return t


def replay(mgr, trace, lo=0, hi=None, bank_seed=7):
    rng = np.random.default_rng(bank_seed)
    pg = rng.normal(size=(1, mgr.cfg.page_size, mgr.cfg.num_kv_heads,
                          mgr.cfg.head_dim)).astype(np.float32)
    for i in range(lo, len(trace) if hi is None else hi):
        kind, sid = int(trace.kind[i]), int(trace.sid[i])
        if kind == SESSION_NEW:
            mgr.new_session(sid, int(trace.tenant[i]))
        elif kind == SESSION_APPEND:
            mgr.append_page(sid, pg, pg)
        elif kind == SESSION_ACTIVATE:
            mgr.activate(sid)
        elif kind == SESSION_END:
            mgr.end_session(sid)
    return mgr


def snapshot(mgr):
    return (mgr.stats.as_dict(), dict(mgr.slot_owner), tuple(mgr.free),
            tuple(int(q) for q in mgr.tenant_quota),
            tuple(int(u) for u in mgr.tenant_used), sorted(mgr.host),
            dict(mgr._dirty), mgr._append_seq)


def assert_same(jm, tm):
    assert snapshot(tm) == snapshot(jm)
    jj, tj = jm.telemetry.journal, tm.telemetry.journal
    assert len(tj) == len(jj) > 0
    for col in jj._cols:
        assert np.array_equal(tj.column(col), jj.column(col)), col
    if jm.batched:
        assert np.array_equal(tm._pop_addr, np.asarray(jm._table.addr))
        assert np.array_equal(tm._pop_val.view(np.int32),
                              np.asarray(jm._table.val).view(np.int32))


def compare_managers(trace, quota):
    jcfg = JConfig(**CFG, clean_quota=quota)
    tcfg = TwoTierConfig(**CFG, clean_quota=quota)
    for batched in (True, False):
        jm = replay(JManager(jcfg, 3, batched=batched), trace)
        tm = replay(TwoTierKVManager(tcfg, 3, batched=batched,
                                     device="cpu"), trace)
        assert_same(jm, tm)
        assert tm.stats.pop_drops == 0
        if quota:
            assert tm.stats.flushes > 0
