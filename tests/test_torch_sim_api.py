"""Port parity for the simulator, trace and sizing API the paper's
figures call: ``Stats.zero``/``merge``/``hit_ratio``/``mean_latency``,
``stack_states``/``unstack_states``, per-state ``resize`` and
``clean_blocks``, ``Trace.for_vm``/``concat``/``n_writes``,
``pod``/``urd``/``trd``/``mrc`` and ``VMResult.contended_latency``, each
against the JAX package on the same seeded inputs (plain PyTorch
versions on the CPU)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import controller as jctl
from repro.core import reuse as jreuse
from repro.core import simulator as jsim
from repro.core import trace as jtrace
from repro.core.policies import Policy as JPolicy
from repro.traces import make as jmake

from repro_torch.core import (CacheState, Policy, Stats, Trace, VMResult,
                              make_cache, mrc, pod, resize,
                              simulate_single_level, simulate_two_level,
                              split_by_vm, stack_states, trd, unstack_states,
                              urd)
from repro_torch.core.simulator import (clean_blocks, clean_blocks_ref,
                                        resize_ref)
from repro_torch.traces import make

CPU = "cpu"


def _tstate(tags, lru, dirty) -> CacheState:
    return CacheState(torch.from_numpy(np.array(tags, np.int32)),
                      torch.from_numpy(np.array(lru, np.int32)),
                      torch.from_numpy(np.array(dirty, bool)))


def _jstate(tags, lru, dirty):
    return jsim.CacheState(jnp.asarray(tags), jnp.asarray(lru),
                           jnp.asarray(dirty))


def _assert_same(tstate, jstate, msg=""):
    for a, b in zip(tstate, jstate):
        assert np.array_equal(a.numpy(), np.asarray(b)), msg


def maintenance_state(rng, s, w):
    """``tests/test_maintenance_ops.py``'s random_state: no duplicate tag
    in a set, lru in [-1, 100), half the resident blocks dirty."""
    tags = rng.integers(-1, 40, (s, w)).astype(np.int32)
    for i in range(s):
        seen = set()
        for j in range(w):
            if int(tags[i, j]) in seen:
                tags[i, j] = -1
            elif tags[i, j] >= 0:
                seen.add(int(tags[i, j]))
    lru = rng.integers(-1, 100, (s, w)).astype(np.int32)
    dirty = (rng.random((s, w)) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def cleaner_state(rng, s, w, dirty_frac=0.5):
    """``tests/test_cleaner.py``'s _random_state for one VM: lru ties in
    [0, 30)."""
    tags = np.where(rng.random((s, w)) < 0.35, -1,
                    rng.integers(0, 48, (s, w))).astype(np.int32)
    lru = np.where(tags < 0, -1, rng.integers(0, 30, (s, w))).astype(np.int32)
    dirty = (tags >= 0) & (rng.random((s, w)) < dirty_frac)
    return tags, lru, dirty


def two_level_ssd(seed):
    """``tests/test_two_level_invariants.py``'s SSD after an npe window
    (4 x 4 DRAM, 8 x 4 SSD, 150 requests over 20 addresses)."""
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 20, 150).astype(np.int32)
    wr = rng.random(150) < 0.5
    _, ssd, _, _ = jsim.simulate_two_level(
        addr, wr, jsim.make_cache(4, 4), jsim.make_cache(8, 4), 4, 4,
        mode="npe")
    return tuple(np.asarray(x) for x in ssd)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def test_stats_zero_dtypes():
    z = Stats.zero()
    for k, v in zip(Stats._fields, z):
        assert v.dim() == 0 and int(v) == 0
        assert v.dtype == (torch.float32 if k == "latency_sum"
                           else torch.int32), k
    assert z.hit_ratio() == 0.0 and z.mean_latency() == 0.0


@pytest.mark.parametrize("workload,policy,chunk", [
    ("varmail", "WB", 400), ("fio_randrw", "WBWO", 333),
    ("web_server", "RO", 1_000), ("hm_1", "WT", 250)])
def test_chunked_single_level_stats_merge(workload, policy, chunk):
    """fig3's loop over chunks: ``t0`` carried, Stats merged; every field
    (``latency_sum`` the same float32 value), ``total``, ``hits``,
    ``hit_ratio`` and ``mean_latency`` equal JAX's."""
    tr = make(workload, 1_500, seed=3, scale=0.25)
    jtr = jmake(workload, 1_500, seed=3, scale=0.25)
    state, stats, t0 = make_cache(16, 32, CPU), Stats.zero(), 0
    jstate, jstats, jt0 = jsim.make_cache(16, 32), jsim.Stats.zero(), 0
    for c, jc in zip(tr.intervals(chunk), jtr.intervals(chunk)):
        state, st, t0 = simulate_single_level(
            c.addr, c.is_write, state, 24, Policy[policy], t0=t0)
        stats = stats.merge(st)
        jstate, jst, jt0 = jsim.simulate_single_level(
            np.asarray(jc.addr), np.asarray(jc.is_write), jstate, 24,
            JPolicy[policy], t0=jt0)
        jstats = jstats.merge(jst)
    assert stats.latency_sum.dtype == torch.float32
    assert stats.reads.dtype == torch.int32 and t0.dtype == torch.int32
    for k, a, b in zip(Stats._fields, stats, jstats):
        assert float(a) == float(b), k
    assert int(stats.total) == int(jstats.total)
    assert int(stats.hits) == int(jstats.hits)
    assert stats.hit_ratio() == jstats.hit_ratio()
    assert stats.mean_latency() == jstats.mean_latency()
    _assert_same(state, jstate)


# ---------------------------------------------------------------------------
# stacked and per-state layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,s,w", [(1, 4, 4), (3, 8, 5), (5, 16, 32)])
def test_stack_unstack_states(v, s, w):
    rng = np.random.default_rng(v * 100 + s)
    parts = [maintenance_state(rng, s, w) for _ in range(v)]
    stacked = stack_states([_tstate(*p) for p in parts])
    jstacked = jsim.stack_states([_jstate(*p) for p in parts])
    _assert_same(stacked, jstacked)
    for got, jgot in zip(unstack_states(stacked),
                         jsim.unstack_states(jstacked)):
        _assert_same(got, jgot)


# ---------------------------------------------------------------------------
# per-state resize and clean_blocks
# ---------------------------------------------------------------------------

def test_resize_per_state_matches_jax_and_ref():
    rng = np.random.default_rng(7)
    for trial in range(20):
        s, w = int(rng.integers(2, 9)), int(rng.integers(1, 9))
        arrays = maintenance_state(rng, s, w)
        old_w, new_w = (int(rng.integers(0, w + 1)),
                        int(rng.integers(0, w + 1)))
        got, flushed = resize(_tstate(*arrays), old_w, new_w)
        want, jflushed = jsim.resize(_jstate(*arrays), old_w, new_w)
        ref, ref_flushed = resize_ref(_tstate(*arrays), old_w, new_w)
        assert flushed.dim() == 0 and flushed.dtype == torch.int32
        assert int(flushed) == int(jflushed) == ref_flushed, trial
        _assert_same(got, want, f"trial {trial}")
        _assert_same(ref, want, f"trial {trial}")


def _clean_cases():
    rng = np.random.default_rng(11)
    cases = []
    for trial in range(12):
        s, w = int(rng.integers(2, 10)), int(rng.integers(1, 8))
        arrays = (maintenance_state if trial % 2 else cleaner_state)(rng, s, w)
        cases.append((f"random-{trial}", arrays, int(rng.integers(0, w + 1)),
                      int(rng.integers(0, s * w + 2))))
    for seed in range(4):
        cases.append((f"two-level-{seed}", two_level_ssd(seed), 4,
                      int(rng.integers(1, 9))))
    tags, lru, dirty = cleaner_state(rng, 16, 32, dirty_frac=0.7)
    n_dirty = int(dirty.sum())
    cases += [("quota-0", (tags, lru, dirty), 32, 0),
              ("quota-above-dirty", (tags, lru, dirty), 32, n_dirty + 5),
              ("part-ways", (tags, lru, dirty), 9, n_dirty // 3)]
    return cases


@pytest.mark.parametrize("label,arrays,ways,quota", _clean_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_clean_blocks_per_state_matches_jax_and_ref(label, arrays, ways,
                                                    quota):
    got, flushed, left = clean_blocks(_tstate(*arrays), ways, quota)
    want, jflushed, jleft = jsim.clean_blocks(_jstate(*arrays), ways, quota)
    ref, ref_flushed, ref_left = clean_blocks_ref(_tstate(*arrays), ways,
                                                  quota)
    assert flushed.dim() == 0 and left.dim() == 0
    assert (int(flushed), int(left)) == (int(jflushed), int(jleft)) == \
        (ref_flushed, ref_left), label
    _assert_same(got, want, label)
    _assert_same(ref, want, label)
    # the cleaner flushes only: tags and lru are untouched
    assert np.array_equal(got.tags.numpy(), arrays[0])
    assert np.array_equal(got.lru.numpy(), arrays[1])


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

def _multi_vm(seed, with_size):
    rng = np.random.default_rng(seed)
    n = 600
    kw = dict(addr=rng.integers(0, 300, n).astype(np.int32),
              is_write=rng.random(n) < 0.4,
              vm=rng.integers(0, 5, n).astype(np.int32),
              size=(rng.integers(1, 9, n).astype(np.int32) if with_size
                    else None))
    return Trace(**kw), jtrace.Trace(**kw)


def _same_trace(a, b):
    for f in ("addr", "is_write", "vm", "size"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f
            assert np.asarray(x).dtype == np.asarray(y).dtype, f


@pytest.mark.parametrize("with_size", [False, True])
def test_trace_for_vm_split_concat_n_writes(with_size):
    tr, jtr = _multi_vm(5, with_size)
    assert tr.n_writes == jtr.n_writes and tr.n_reads == jtr.n_reads
    subs = split_by_vm(tr, 6)              # VM 5 has no request
    for v in range(6):
        _same_trace(tr.for_vm(v), jtr.for_vm(v))
        _same_trace(tr.for_vm(v), subs[v])
    parts = [tr[:100], tr[100:350], tr[350:]]
    jparts = [jtr[:100], jtr[100:350], jtr[350:]]
    _same_trace(Trace.concat(parts), jtrace.Trace.concat(jparts))
    _same_trace(Trace.concat(parts), tr)
    # vm dropped unless every part has it; size kept if any part has it
    mixed = [Trace(tr.addr[:50], tr.is_write[:50]), tr[50:]]
    jmixed = [jtrace.Trace(jtr.addr[:50], jtr.is_write[:50]), jtr[50:]]
    _same_trace(Trace.concat(mixed), jtrace.Trace.concat(jmixed))


# ---------------------------------------------------------------------------
# per-trace sizing: pod / urd / trd / mrc
# ---------------------------------------------------------------------------

def _traces():
    out = [Trace(np.zeros(0, np.int32), np.zeros(0, bool))]
    for i, name in enumerate(("hm_1", "web_3", "usr_0", "varmail")):
        out.append(make(name, 700 + 150 * i, seed=i, scale=0.25))
    rng = np.random.default_rng(2)
    out.append(Trace(rng.integers(0, 12, 300).astype(np.int32),
                     rng.random(300) < 0.5))
    return out


def _jt(tr):
    return jtrace.Trace(np.asarray(tr.addr), np.asarray(tr.is_write))


def test_pod_urd_trd_of_an_empty_trace():
    """Nothing is served: -1 each (the reference refuses an empty trace,
    since its max has no identity)."""
    tr = _traces()[0]
    assert [pod(tr, p, CPU) for p in Policy] == [-1] * len(Policy)
    assert urd(tr, CPU) == trd(tr, CPU) == -1


@pytest.mark.parametrize("i", range(1, 6))
def test_pod_urd_trd_match_jax(i):
    tr = _traces()[i]
    for p in ("WB", "WT", "RO", "WO", "WBWO"):
        assert pod(tr, Policy[p], CPU) == jreuse.pod(_jt(tr), JPolicy[p]), p
    assert urd(tr, CPU) == jreuse.urd(_jt(tr))
    assert trd(tr, CPU) == jreuse.trd(_jt(tr))


@pytest.mark.parametrize("policy", ["WB", "RO", "WBWO"])
@pytest.mark.parametrize("sizes", [(0, 1, 2, 4, 8), (16, 64, 256, 1024),
                                   tuple(range(0, 520, 32))])
def test_mrc_matches_jax(policy, sizes):
    for tr in _traces()[1:]:
        got = mrc(tr, Policy[policy], np.asarray(sizes), CPU)
        want = jreuse.mrc(_jt(tr), JPolicy[policy], np.asarray(sizes))
        assert got.dtype == np.float64
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# VMResult.contended_latency
# ---------------------------------------------------------------------------

def _stats_cases():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(6):
        reads, writes = (float(x) for x in rng.integers(0, 5_000, 2))
        d = {"reads": reads, "writes": writes,
             "read_hits_l1": float(rng.integers(0, reads + 1)),
             "read_hits_l2": float(rng.integers(0, reads + 1)),
             "write_hits_l2": float(rng.integers(0, writes + 1)),
             "cache_writes_l2": float(rng.integers(0, writes + 1)),
             "latency_sum": float(np.float32(rng.random() * 3))}
        out.append(d)
    # no SSD access at all: the mean latency
    out.append({"reads": 40.0, "writes": 10.0, "read_hits_l1": 12.0,
                "read_hits_l2": 0.0, "write_hits_l2": 0.0,
                "cache_writes_l2": 0.0, "latency_sum": 0.0123})
    out.append({"reads": 0.0, "writes": 0.0, "read_hits_l1": 0.0,
                "read_hits_l2": 0.0, "write_hits_l2": 0.0,
                "cache_writes_l2": 0.0, "latency_sum": 0.0})
    return out


@pytest.mark.parametrize("beta", [8.0, 0.0, 2.5])
def test_contended_latency_matches_jax(beta):
    for d in _stats_cases():
        got = VMResult(dict(d), np.zeros(0, np.int64))
        want = jctl.VMResult(dict(d), np.zeros(0, np.int64))
        assert got.contended_latency(beta) == want.contended_latency(beta)
        assert got.mean_latency == want.mean_latency
        assert got.hit_ratio == want.hit_ratio


def test_contended_latency_on_a_two_level_run():
    """The derived floats of a real per-state run's Stats dict."""
    tr = make("hm_1", 1_200, seed=4, scale=0.25)
    _, _, st, _ = simulate_two_level(tr.addr, tr.is_write,
                                     make_cache(16, 32, CPU),
                                     make_cache(16, 32, CPU), 20, 28,
                                     mode="npe")
    _, _, jst, _ = jsim.simulate_two_level(
        np.asarray(tr.addr), np.asarray(tr.is_write), jsim.make_cache(16, 32),
        jsim.make_cache(16, 32), 20, 28, mode="npe")
    d = {k: float(v) for k, v in zip(Stats._fields, st)}
    jd = {k: float(v) for k, v in zip(jsim.Stats._fields, jst)}
    assert d == jd
    got = VMResult(d, np.zeros(1, np.int64))
    want = jctl.VMResult(jd, np.zeros(1, np.int64))
    assert got.contended_latency() == want.contended_latency()
    assert got.mean_latency == want.mean_latency
