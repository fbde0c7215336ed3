"""Port parity: the classified datapaths' plain versions vs the JAX
package's ``simulate_*_classified(_batch)``.

``two_level_classified_plain`` and ``single_level_classified_plain``
(what a CPU tensor takes through ``simulate_*_classified``) against the
reference on seeded inputs: states, ``Stats`` (``bypassed`` and the
``latency_sum`` bits included), ``t_end``, ``cls_hits`` and
``cls_miss``, at V 3 and N 200 over 8 x 8 and 4 x 16 geometries, 1 to 4
classes and 256 (the widest table the kernels take, with a seeded
bypass mask), empty and exclusive insertion ranges, bypass classes,
class ids outside ``[0, C)``, padding, states that hold dirty and stale rows,
and every write policy. Match-all tables give the unclassified plain
versions' results. Every other case also runs the per-state entry
points on one VM.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as J

from repro_torch.core import simulator as T
from repro_torch.core.policies import Policy
from repro_torch.kernels.datapath import ops

V, N = 3, 200
FLAGS = ("allocates_reads", "write_invalidates", "holds_dirty",
         "write_through")


def _block(rng, space):
    addr = rng.integers(0, space, (V, N)).astype(np.int32)
    addr[rng.random((V, N)) < 0.1] = -1
    addr[:, -15:] = -1
    addr[2, 120:] = -1
    return addr, rng.random((V, N)) < 0.4


def _state(rng, s, w):
    return (rng.integers(-1, 4 * s, (V, s, w)).astype(np.int32),
            rng.integers(-1, 60, (V, s, w)).astype(np.int32),
            rng.random((V, s, w)) < 0.5)


def _tables(rng, c, ways, w_max, empty):
    """Way bounds ``[V, C]``: random ranges, one empty, one exclusive."""
    lo = rng.integers(0, w_max + 1, (V, c)).astype(np.int32)
    hi = (lo + rng.integers(0, w_max // 2 + 1, (V, c))).astype(np.int32)
    if c > 1:
        hi[:, 1] = lo[:, 1]                        # empty
    if c > 2:
        lo[:, 2], hi[:, 2] = ways // 2, ways       # an exclusive top slice
    if empty:
        hi = lo.copy()
    return lo, hi


def _same_stats(jst, tst):
    for k, a, b in zip(J.Stats._fields, jst, tst):
        a, b = np.asarray(a), b.numpy()
        if k == "latency_sum":
            assert a.dtype == b.dtype == np.float32
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), k


def _same(jout, tout):
    for a, b in zip(jout, tout):
        if isinstance(a, J.CacheState):
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y.numpy())
        elif isinstance(a, J.Stats):
            _same_stats(a, b)
        else:
            assert np.array_equal(np.asarray(a), b.numpy())


CASES = [  # classes, (sets, ways) DRAM, SSD, bypass mask (None: seeded),
    #         all ranges empty
    (1, (8, 8), (8, 8), (False,), False),
    (2, (4, 16), (8, 8), (False, True), False),
    (3, (8, 8), (4, 16), (True, False, False), False),
    (4, (8, 8), (8, 8), (False, True, False, True), False),
    (4, (4, 16), (4, 16), (False, False, True, False), True),
    (256, (8, 8), (4, 16), None, False),
]


def _bypass(rng, c, byp):
    """The case's bypass mask, or a seeded one (a quarter of the
    classes)."""
    return rng.random(c) < 0.25 if byp is None else np.asarray(byp)


@pytest.mark.parametrize("mode", ["full", "npe"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_two_level_classified_equals_jax(case, mode):
    c, (sd, wd), (ss, ws), byp, empty = CASES[case]
    rng = np.random.default_rng(10 + case)
    addr, wr = _block(rng, 6 * max(sd, ss))
    cls = rng.integers(-1, c + 1, (V, N)).astype(np.int32)
    dram, ssd = _state(rng, sd, wd), _state(rng, ss, ws)
    ways_d = np.array([wd, 3, 0], np.int32)
    ways_s = np.array([ws // 2, ws, 2], np.int32)
    lo_d, hi_d = _tables(rng, c, ways_d, wd, empty)
    lo_s, hi_s = _tables(rng, c, ways_s, ws, empty)
    byp = _bypass(rng, c, byp)
    t0 = np.array([5, 70, 300], np.int32)
    args = (byp, lo_d, hi_d, lo_s, hi_s)
    jout = J.simulate_two_level_classified_batch(
        addr, wr, cls, J.CacheState(*map(jnp.asarray, dram)),
        J.CacheState(*map(jnp.asarray, ssd)), ways_d, ways_s, *args,
        mode=mode, t0=t0)
    tout = T.simulate_two_level_classified_batch(
        addr, wr, cls, T.CacheState(*map(torch.from_numpy, dram)),
        T.CacheState(*map(torch.from_numpy, ssd)), ways_d, ways_s, *args,
        mode=mode, t0=t0)
    _same(jout, tout)
    assert int(tout[2].bypassed.sum()) == int(
        ((addr >= 0) & byp[np.clip(cls, 0, c - 1)]).sum())
    if case % 2:
        return
    # the per-state entry point, VM 1
    j1 = J.simulate_two_level_classified(
        addr[1], wr[1], cls[1], J.CacheState(*(jnp.asarray(x[1])
                                               for x in dram)),
        J.CacheState(*(jnp.asarray(x[1]) for x in ssd)), int(ways_d[1]),
        int(ways_s[1]), byp, lo_d[1], hi_d[1], lo_s[1], hi_s[1], mode=mode,
        t0=int(t0[1]))
    t1 = T.simulate_two_level_classified(
        addr[1], wr[1], cls[1], T.CacheState(*(torch.from_numpy(x[1])
                                               for x in dram)),
        T.CacheState(*(torch.from_numpy(x[1]) for x in ssd)),
        int(ways_d[1]), int(ways_s[1]), byp, lo_d[1], hi_d[1], lo_s[1],
        hi_s[1], mode=mode, t0=int(t0[1]))
    _same(j1, t1)


def _policy_tables(rng, c):
    pols = [[list(Policy)[int(p)] for p in row]
            for row in rng.integers(0, len(Policy), (V, c))]
    f = lambda attr: np.asarray([[getattr(p, attr) for p in row]
                                 for row in pols], bool)
    return [f(a) for a in FLAGS]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_single_level_classified_equals_jax(case):
    c, (s, w), _, byp, empty = CASES[case]
    rng = np.random.default_rng(20 + case)
    addr, wr = _block(rng, 6 * s)
    cls = rng.integers(-1, c + 1, (V, N)).astype(np.int32)
    state = _state(rng, s, w)
    ways = np.array([w, w // 3, 0], np.int32)
    lo, hi = _tables(rng, c, ways, w, empty)
    flags = _policy_tables(rng, c)
    byp = _bypass(rng, c, byp)
    t0 = np.array([9, 0, 41], np.int32)
    jout = J.simulate_single_level_classified_batch(
        addr, wr, cls, J.CacheState(*map(jnp.asarray, state)), ways,
        J.PolicyFlags(*flags), lo, hi, byp, t_cache=2e-5, t0=t0)
    tout = T.simulate_single_level_classified_batch(
        addr, wr, cls, T.CacheState(*map(torch.from_numpy, state)), ways,
        T.PolicyFlags(*flags), lo, hi, byp, t_cache=2e-5, t0=t0)
    _same(jout, tout)
    if case % 2:
        return
    j0 = J.simulate_single_level_classified(
        addr[0], wr[0], cls[0], J.CacheState(*(jnp.asarray(x[0])
                                               for x in state)),
        int(ways[0]), J.PolicyFlags(*(f[0] for f in flags)), lo[0], hi[0],
        byp, t0=int(t0[0]))
    t0_ = T.simulate_single_level_classified(
        addr[0], wr[0], cls[0], T.CacheState(*(torch.from_numpy(x[0])
                                               for x in state)),
        int(ways[0]), T.PolicyFlags(*(f[0] for f in flags)), lo[0], hi[0],
        byp, t0=int(t0[0]))
    _same(j0, t0_)


def test_every_policy_pair_in_one_block():
    """All 25 (VM policy, class override) pairs, one VM each."""
    rng = np.random.default_rng(30)
    pols = list(Policy)
    v, n, s, w = 25, 150, 4, 8
    addr = rng.integers(0, 30, (v, n)).astype(np.int32)
    wr = rng.random((v, n)) < 0.5
    cls = rng.integers(0, 2, (v, n)).astype(np.int32)
    flags = [np.asarray([[getattr(pols[i // 5], f), getattr(pols[i % 5], f)]
                         for i in range(v)]) for f in FLAGS]
    state = (np.full((v, s, w), -1, np.int32), np.full((v, s, w), -1,
                                                       np.int32),
             np.zeros((v, s, w), bool))
    ways = np.full(v, w, np.int32)
    lo = np.array([[0, 5]] * v, np.int32)
    hi = np.array([[5, 8]] * v, np.int32)
    byp = np.array([False, False])
    jout = J.simulate_single_level_classified_batch(
        addr, wr, cls, J.CacheState(*map(jnp.asarray, state)), ways,
        J.PolicyFlags(*flags), lo, hi, byp)
    tout = T.simulate_single_level_classified_batch(
        addr, wr, cls, T.CacheState(*map(torch.from_numpy, state)), ways,
        T.PolicyFlags(*flags), lo, hi, byp, t0=0)
    _same(jout, tout)


def test_match_all_tables_equal_the_unclassified_plain_versions():
    rng = np.random.default_rng(31)
    addr, wr = (torch.from_numpy(x) for x in _block(rng, 48))
    cls = torch.zeros((V, N), dtype=torch.int32)
    byp = torch.zeros(1, dtype=torch.bool)
    dram = [torch.from_numpy(x) for x in _state(rng, 8, 8)]
    ssd = [torch.from_numpy(x) for x in _state(rng, 4, 16)]
    wd = torch.tensor([8, 3, 0], dtype=torch.int32)
    ws = torch.tensor([16, 1, 9], dtype=torch.int32)
    t0 = torch.tensor([1, 2, 3], dtype=torch.int32)
    zero = torch.zeros((V, 1), dtype=torch.int32)
    for npe in (False, True):
        got = ops.two_level_classified(addr, wr, cls, *dram, *ssd, wd, ws,
                                       t0, byp, zero, wd[:, None], zero,
                                       ws[:, None], npe=npe)
        want = ops.two_level_plain(addr, wr, *dram, *ssd, wd, ws, t0,
                                   npe=npe)
        for a, b in zip(got[:6] + got[7:9], want[:6] + want[7:]):
            assert torch.equal(a, b)
        assert torch.equal(got[6][:, :8], want[6])
        assert not got[6][:, 8].any()
        assert torch.equal(got[9] + got[10], want[6][:, :2].sum(1,
                                                                keepdim=True))
    flags = [torch.from_numpy(f) for f in _policy_tables(rng, 1)]
    got = ops.single_level_classified(addr, wr, cls, *dram, wd, *flags, t0,
                                      byp, zero, wd[:, None], t_cache=2e-5)
    want = ops.single_level_plain(addr, wr, *dram, wd,
                                  *(f[:, 0].contiguous() for f in flags), t0,
                                  t_cache=2e-5)
    for a, b in zip(got[:3] + got[4:6], want[:3] + want[4:]):
        assert torch.equal(a, b)
    assert torch.equal(got[3][:, :8], want[3]) and not got[3][:, 8].any()
