"""Port parity: the one-level chassis and baselines vs the JAX package.

The port's plain one-level datapath (what it runs on CPU tensors)
against ``simulate_single_level_batch`` with all five policies mixed
across VMs; ``sizing_metrics_batch`` for the four sizing kinds; the four
factories (ECI-Cache, Centaur, S-CAVE, vCacheShare) end to end; and a
chassis state carried over from a JAX run — all exact, float32 bit for
bit. The chassis' sequential oracle is held in
tests/test_torch_oracle_baselines.py.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import reuse as jreuse
from repro.core import simulator as jsim
from repro.core.controller import Geometry as JGeometry
from repro.core.policies import Policy as JPolicy
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

from repro_torch.core import baselines as tbase
from repro_torch.core import reuse as treuse
from repro_torch.core import simulator as tsim
from repro_torch.core.controller import (Geometry, PartitionedSingleLevelCache,
                                         SingleLevelConfig)
from repro_torch.core.policies import Policy
from repro_torch.core.trace import interleave
from repro_torch.traces.generators import make

POLICIES = ["WB", "WT", "RO", "WO", "WBWO", "RO"]
V, N = len(POLICIES), 160
WAYS = np.array([4, 0, 3, 1, 4, 2], np.int32)
T0 = np.array([0, 3, 9, 100, 7, 1], np.int32)


def _requests(seed, pad_frac=0.15, addr_space=28):
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, addr_space, (V, N)).astype(np.int32)
    addr[rng.random((V, N)) < pad_frac] = -1
    addr[:, -7:] = -1                      # a padded tail
    is_write = rng.random((V, N)) < 0.45
    return addr, is_write


def _assert_block(jout, tout, msg):
    for a, b in zip(jout[0], tout[0]):
        assert np.array_equal(np.asarray(a), b.numpy()), msg
    assert len(jout[1]) == len(tout[1]) == 13
    for name, a, b in zip(jsim.Stats._fields, jout[1], tout[1]):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (msg, name)
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), (msg, name)
    assert np.array_equal(np.asarray(jout[2]), tout[2].numpy()), msg


@pytest.mark.parametrize("t_cache", [None, 2.5e-5])
@pytest.mark.parametrize("seed", range(3))
def test_single_level_matches_jax(seed, t_cache):
    """Three chained blocks, state and clock carried from one to the
    next, every VM under its own policy."""
    kw = {} if t_cache is None else dict(t_cache=t_cache)
    jflags = jsim.policy_flags([JPolicy(p) for p in POLICIES])
    tflags = tsim.policy_flags([Policy(p) for p in POLICIES], "cpu")
    jst = jsim.make_cache_batch(V, 4, 4)
    tst = tsim.make_cache_batch(V, 4, 4, device="cpu")
    jt, tt = T0, torch.from_numpy(T0)
    for blk in range(3):
        addr, is_write = _requests(10 * seed + blk)
        jout = jsim.simulate_single_level_batch(addr, is_write, jst, WAYS,
                                                jflags, t0=jt, **kw)
        tout = tsim.simulate_single_level_batch(addr, is_write, tst, WAYS,
                                                tflags, t0=tt, **kw)
        _assert_block(jout, tout, (seed, blk))
        jst, jt = jout[0], jout[2]
        tst, tt = tout[0], tout[2]
    st = tout[1]
    assert int(st.disk_writes[1]) == 2 * int(st.writes[1]) > 0  # WT, 0 ways
    assert int(st.write_hits_l2[5]) == 0 < int(st.writes[5])  # RO
    assert int(st.disk_writes[5]) >= int(st.writes[5])


def test_single_level_all_padding_is_a_no_op():
    addr = np.full((V, 16), -1, np.int32)
    is_write = np.ones((V, 16), bool)
    st = tsim.make_cache_batch(V, 4, 4, device="cpu")
    out = tsim.simulate_single_level_batch(
        addr, is_write, st, WAYS, tsim.policy_flags(
            [Policy(p) for p in POLICIES], "cpu"), t0=T0)
    for a, b in zip(st, out[0]):
        assert torch.equal(a, b)
    assert all(int(x.abs().sum()) == 0 for x in out[1])
    assert np.array_equal(out[2].numpy(), T0)


def _ragged_rows(seed):
    rng = np.random.default_rng(seed)
    lens = [0, 40, 300, 1, 90, 0]
    addrs = [rng.integers(0, max(n // 3, 1), n).astype(np.int32)
             for n in lens]
    writes = [rng.random(n) < 0.4 for n in lens]
    writes[4] = np.ones(lens[4], bool)              # an all-write row
    return addrs, writes


@pytest.mark.parametrize("kind", ["urd", "trd", "wss", "reuse_intensity"])
@pytest.mark.parametrize("seed", range(2))
def test_sizing_metrics_batch_matches_jax(kind, seed):
    addrs, writes = _ragged_rows(seed)
    grid = np.array([0, 8, 16, 48, 96, 256], np.int64)
    jd, jh, jr = jreuse.sizing_metrics_batch(addrs, writes, kind, grid)
    td, th, tr = treuse.sizing_metrics_batch(addrs, writes, kind, grid,
                                             device="cpu")
    for a, b in ((jd, td), (jh, th), (jr, tr)):
        assert b.dtype == np.int64
        assert np.array_equal(np.asarray(a), b), kind
    assert td[0] == td[5] == 0 and not th[0].any()
    assert tr[4] == 0 and tr[2] > 0


def test_sizing_metrics_batch_all_empty():
    d, h, r = treuse.sizing_metrics_batch([np.empty(0, np.int32)] * 3,
                                          [np.empty(0, bool)] * 3, "urd",
                                          [0, 16], device="cpu")
    assert d.shape == (3,) and h.shape == (3, 2) and not (d.any() or h.any()
                                                          or r.any())
    with pytest.raises(ValueError):
        treuse.sizing_metrics_batch([], [], "pod", [0], device="cpu")


NAMES = ["web_3", "stg_1", "hm_1", "usr_0"]
FACTORIES = ["make_eci_cache", "make_centaur", "make_scave",
             "make_vcacheshare"]


def _mix(reqs=1200):
    j = jinterleave([jmake(n, reqs, seed=i, addr_offset=i * 10_000_000,
                           scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    t = interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                         scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    return j, t


def _assert_chassis(jc, jres, tc, tres):
    for v, (a, b) in enumerate(zip(jres, tres)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v
    assert len(jc.logs) == len(tc.logs)
    for a, b in zip(jc.logs, tc.logs):
        assert a.policies == b.policies
        assert np.array_equal(a.demands, b.demands)
        assert np.array_equal(a.alloc, b.alloc)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_run_matches_jax(factory):
    jtrace, ttrace = _mix()
    kw = dict(resize_interval=1600, sim_chunk=250)
    jc = getattr(jbase, factory)(1200, len(NAMES), geometry=JGeometry(16, 32),
                                 **kw)
    tc = getattr(tbase, factory)(1200, len(NAMES), geometry=Geometry(16, 32),
                                 device="cpu", **kw)
    _assert_chassis(jc, jc.run(jtrace), tc, tc.run(ttrace))
    jj, tj = jc.telemetry.journal, tc.telemetry.journal
    assert len(jj) == len(tj) > 0
    for col in ("requests", "hits", "ssd_writes", "disk_writes", "alloc_l2",
                "overloaded"):
        assert np.array_equal(jj.column(col), tj.column(col)), col
    if factory == "make_eci_cache":
        pols = {p for log in tc.logs for p in log.policies}
        assert pols == {"RO", "WB"}


def test_load_state_carries_a_jax_chassis():
    """Run the first resize window in JAX, carry the state over, and run
    the rest in both chassis side by side."""
    jtrace, ttrace = _mix()
    jc = jbase.make_eci_cache(1200, len(NAMES), geometry=JGeometry(16, 32),
                              resize_interval=1600, sim_chunk=400)
    tc = tbase.make_eci_cache(1200, len(NAMES), geometry=Geometry(16, 32),
                              resize_interval=1600, sim_chunk=400,
                              device="cpu")
    jc.run(jtrace[:1600])
    tc.load_state(caches=[np.asarray(x) for x in jc.caches], ways=jc.ways,
                  t=jc.t, stats=jc.stats)
    jc.logs.clear()
    _assert_chassis(jc, jc.run(jtrace[1600:]), tc, tc.run(ttrace[1600:]))
    for a, b in zip(jc.caches, tc.caches):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jc.t), tc.t.numpy())


@pytest.mark.parametrize("option", [dict(batched=False, mesh=object()),
                                    dict(mesh=object()),
                                    dict(classifier=object())])
def test_chassis_options_outside_the_port_raise(option):
    """The mesh is outside the port; a classifier that is not a
    ``repro_torch.classify.Classifier`` is the wrong type."""
    cfg = SingleLevelConfig(capacity=100, **option)
    err = TypeError if "classifier" in option else NotImplementedError
    with pytest.raises(err):
        PartitionedSingleLevelCache(cfg, 2, tbase.urd_metric(Geometry()),
                                    tbase.eci_policy(), device="cpu")


def test_chassis_metric_closure_raises():
    """A per-VM metric closure is a metric (the sequential sizing loop);
    anything that is neither a SizingMetric nor callable raises."""
    PartitionedSingleLevelCache(SingleLevelConfig(capacity=100), 2,
                                lambda sub: (0, None, None),
                                tbase.fixed_policy(Policy.WB), device="cpu")
    with pytest.raises(TypeError, match="SizingMetric"):
        PartitionedSingleLevelCache(SingleLevelConfig(capacity=100), 2,
                                    "urd", tbase.fixed_policy(Policy.WB),
                                    device="cpu")
