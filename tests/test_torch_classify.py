"""Port parity: ``repro_torch.classify`` vs ``repro.classify``.

The rule engine (``classify_block`` on the CPU) against the JAX
package's ``classify_block`` and the scalar oracle ``classify_ref``, bit
for bit, on a seeded sweep and on the random rule sets and request
blocks of ``tests/test_classify.py`` (its strategies, copied); carries
across window splits; ``Classifier.classify_subs`` against
``classify_trace_ref`` with carries across windows; ``compile_rules``,
``way_bounds``, ``vm_policies`` and the constructors' ``ValueError``s
against the reference's.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.classify as J
from repro.core.policies import Policy as JPolicy

import repro_torch.classify as T
from repro_torch.core.policies import Policy
from repro_torch.core.trace import Trace

SETTINGS = dict(max_examples=20, deadline=None)


# ---------------------------------------------------------------------------
# strategies (tests/test_classify.py's, over the port's classes)
# ---------------------------------------------------------------------------

def _interval(lo_max, width_max):
    return st.one_of(
        st.none(),
        st.tuples(st.integers(0, lo_max), st.integers(1, width_max)).map(
            lambda t: (t[0], t[0] + t[1])),
        st.tuples(st.integers(0, lo_max)).map(lambda t: (t[0], None)),
        st.tuples(st.integers(1, lo_max)).map(lambda t: (None, t[0])),
    )


rules = st.builds(T.ClassRule,
                  size=_interval(8, 8),
                  lba=_interval(600, 400),
                  run_len=_interval(96, 64),
                  direction=st.sampled_from([None, "read", "write"]))

io_classes = st.builds(T.IOClass,
                       name=st.just("c"),
                       rules=st.lists(rules, min_size=0, max_size=3),
                       bypass=st.booleans())


@st.composite
def rule_sets(draw):
    """A valid class list: default first (never bypass), 1-4 others."""
    default = T.IOClass("default",
                        rules=tuple(draw(st.lists(rules, max_size=2))))
    rest = draw(st.lists(io_classes, min_size=0, max_size=4))
    return [default, *rest]


@st.composite
def blocks(draw):
    """Random ``[V, N]`` request blocks with some sequential structure."""
    v = draw(st.integers(1, 3))
    n = draw(st.integers(0, 70))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 800, (v, n))
    size = rng.integers(1, 9, (v, n))
    # splice contiguous continuations so run_len rules actually fire
    for row in range(v):
        i = 1
        while i < n:
            if rng.random() < 0.5:
                addr[row, i] = addr[row, i - 1] + size[row, i - 1]
            i += 1
    return (addr.astype(np.int64), rng.random((v, n)) < 0.4,
            size.astype(np.int64))


def _jax_classes(classes):
    """The same class list built from the JAX package's classes."""
    pol = lambda p: None if p is None else JPolicy(p.value)
    return [J.IOClass(c.name, rules=tuple(
        J.ClassRule(r.size, r.lba, r.run_len, r.direction) for r in c.rules),
        policy=pol(c.policy), ways_frac=c.ways_frac, weight=c.weight,
        bypass=c.bypass) for c in classes]


def _assert_block(classes, addr, is_write, size, lens, ce, cl):
    """Port == JAX == the scalar oracle on one block; returns the port's
    outputs as numpy."""
    plan, jplan = T.compile_rules(classes), J.compile_rules(
        _jax_classes(classes))
    for a, b in zip(plan, jplan):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    got = [x.numpy() for x in T.classify_block(addr, is_write, size, lens,
                                               ce, cl, plan)]
    want = [np.asarray(x) for x in J.classify_block(addr, is_write, size,
                                                     lens, ce, cl, jplan)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    for row in range(addr.shape[0]):
        k = int(lens[row])
        ref, re_, rl = T.classify_ref(addr[row, :k], is_write[row, :k],
                                      size[row, :k], plan, int(ce[row]),
                                      int(cl[row]))
        assert np.array_equal(got[0][row, :k], ref)
        assert not got[0][row, k:].any()
        if k:
            assert (got[1][row], got[2][row]) == (re_, rl)
        else:
            assert (got[1][row], got[2][row]) == (ce[row], cl[row])
    return got


@given(rule_sets(), blocks(), st.integers(0, 60))
@settings(**SETTINGS)
def test_classify_block_matches_jax_and_ref(classes, block, split):
    addr, is_write, size = block
    v, n = addr.shape
    ce, cl = np.full(v, -1, np.int32), np.zeros(v, np.int32)
    cls, ce2, cl2 = _assert_block(classes, addr, is_write, size,
                                  np.full(v, n, np.int32), ce, cl)
    # window-split equivalence: the carry threads runs across the cut
    plan = T.compile_rules(classes)
    k = min(split, n)
    c1, e1, l1 = T.classify_block(addr[:, :k], is_write[:, :k], size[:, :k],
                                  np.full(v, k, np.int32), ce, cl, plan)
    c2, e2, l2 = T.classify_block(addr[:, k:], is_write[:, k:], size[:, k:],
                                  np.full(v, n - k, np.int32), e1, l1, plan)
    assert np.array_equal(np.concatenate([c1.numpy(), c2.numpy()], axis=1),
                          cls)
    assert np.array_equal(e2.numpy(), ce2) and np.array_equal(l2.numpy(),
                                                              cl2)


def _four_class(M, P):
    return M.Classifier([
        M.IOClass("default"),
        M.IOClass("small_writes", rules=(M.ClassRule(size=(None, 2),
                                                     direction="write"),),
                  ways_frac=0.25, policy=P.WT),
        M.IOClass("vm0", rules=(M.ClassRule(lba=(0, 10_000_000)),),
                  weight=0.5),
        M.IOClass("seq_bypass", rules=(M.ClassRule(run_len=(48, None)),),
                  bypass=True)])


@pytest.mark.parametrize("seed", range(6))
def test_classify_block_seeded_sweep(seed):
    """Padding (``n_valid`` below the width, an empty row), random
    carries, long sequential runs, ``INT32``-edge addresses, the
    four-class and seq-cutoff classifiers and random rule sets."""
    rng = np.random.default_rng(seed)
    v, n = 5, 400
    addr = rng.integers(0, 20_000_000, (v, n))
    addr[:, 50:250] = 4_000 + 3 * np.arange(200)
    addr[0, :10] = 2**31 - 4 - rng.integers(0, 100, 10)
    size = rng.integers(1, 5, (v, n))
    size[:, 50:250] = 3
    size[0, :10] = 1
    wr = rng.random((v, n)) < 0.4
    lens = rng.integers(0, n + 1, v).astype(np.int32)
    lens[1] = 0
    ce = rng.integers(-1, 5_000, v).astype(np.int32)
    ce[2] = 4_000
    cl = rng.integers(0, 100, v).astype(np.int32)
    for classes in (_four_class(T, Policy).classes,
                    T.seq_cutoff(int(rng.integers(4, 64))).classes,
                    [T.IOClass("default")],
                    [T.IOClass("d"), T.IOClass("none", rules=())]):
        _assert_block(list(classes), addr, wr, size, lens, ce, cl)


@given(blocks(), st.integers(1, 128))
@settings(**SETTINGS)
def test_classify_subs_matches_trace_ref(block, threshold):
    """``classify_subs`` over ragged sub-traces == the scalar per-trace
    oracle, carries included, and across two windows."""
    addr, is_write, size = block
    c = T.seq_cutoff(threshold)
    subs = [Trace(addr=addr[i].astype(np.int32), is_write=is_write[i],
                  size=size[i].astype(np.int32))
            for i in range(addr.shape[0])]
    ce, cl = c.init_carry(len(subs))
    got, ce2, cl2 = c.classify_subs(subs, ce, cl, device="cpu")
    cut = addr.shape[1] // 3
    one, e1, l1 = c.classify_subs([s[:cut] for s in subs], ce, cl, "cpu")
    two, e2, l2 = c.classify_subs([s[cut:] for s in subs], e1, l1, "cpu")
    for i, sub in enumerate(subs):
        want, we, wr = c.classify_trace_ref(sub)
        assert np.array_equal(got[i], want)
        assert np.array_equal(np.concatenate([one[i], two[i]]), want)
        assert ce2[i] == we == e2[i] and cl2[i] == wr == l2[i]


def test_classify_subs_ragged_windows_equal_jax():
    """A four-class classifier over ragged per-VM sub-traces (one empty)
    in three windows: class ids and carries equal the JAX package's."""
    rng = np.random.default_rng(3)
    tc, jc = _four_class(T, Policy), _four_class(J, JPolicy)
    ce, cl = tc.init_carry(4)
    je, jl = jc.init_carry(4)
    from repro.core.trace import Trace as JTrace
    for w in range(3):
        lens = [int(x) for x in rng.integers(0, 300, 4)]
        lens[w] = 0
        arrs = []
        for k in lens:
            a = rng.integers(0, 20_000_000, k)
            a[: k // 2] = 9_000 + 2 * np.arange(k // 2)
            arrs.append((a.astype(np.int32), rng.random(k) < 0.5,
                         rng.integers(1, 4, k).astype(np.int32)))
        got, ce, cl = tc.classify_subs([Trace(a, w_, size=s)
                                        for a, w_, s in arrs], ce, cl, "cpu")
        want, je, jl = jc.classify_subs([JTrace(a, w_, size=s)
                                         for a, w_, s in arrs], je, jl)
        for g, x in zip(got, want):
            assert g.dtype == np.int32 and np.array_equal(g, x)
        assert np.array_equal(ce, je) and np.array_equal(cl, jl)


def test_way_bounds_and_policies_equal_jax():
    rng = np.random.default_rng(4)
    tc = T.Classifier([T.IOClass("default"), T.IOClass("a", ways_frac=0.25),
                       T.IOClass("b", ways_frac=0.5, policy=Policy.WT),
                       T.IOClass("skip", rules=(T.ClassRule(run_len=(8, None)),),
                                 bypass=True),
                       T.IOClass("pool", policy=Policy.RO, weight=0.3)])
    jc = J.Classifier(_jax_classes(tc.classes))
    for ways in (np.asarray([16, 0], np.int32), rng.integers(0, 65, 9),
                 np.int32(7)):
        for a, b in zip(tc.way_bounds(ways), jc.way_bounds(ways)):
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    lo, hi = tc.way_bounds(np.asarray([16, 0], np.int32))
    assert lo[0].tolist() == [0, 12, 4, 0, 0]
    assert hi[0].tolist() == [4, 16, 12, 0, 4]
    pols = [Policy.WB, Policy.RO, Policy.WBWO]
    assert [[p.value for p in row] for row in tc.vm_policies(pols)] == [
        [p.value for p in row]
        for row in jc.vm_policies([JPolicy(p.value) for p in pols])]
    assert np.array_equal(tc.bypass, jc.bypass)
    assert np.array_equal(tc.weights, jc.weights) and \
        tc.weights.dtype == np.float64
    assert tc.num_classes == jc.num_classes == 5
    for a, b in zip(tc.init_carry(3), jc.init_carry(3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(T.match_all().plan, J.match_all().plan):
        assert np.array_equal(a, b)
    for a, b in zip(T.seq_cutoff(48).plan, J.seq_cutoff(48).plan):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("make", [
    lambda M: M.ClassRule(direction="both"),
    lambda M: M.ClassRule(size=(4, 4)),
    lambda M: M.ClassRule(lba=(9, 3)),
    lambda M: M.ClassRule(run_len=(2, 1)),
    lambda M: M.IOClass("x", ways_frac=1.5),
    lambda M: M.IOClass("x", ways_frac=-0.1),
    lambda M: M.IOClass("x", weight=-1.0),
    lambda M: M.IOClass("x", bypass=True, ways_frac=0.5),
    lambda M: M.Classifier([]),
    lambda M: M.Classifier([M.IOClass("d", bypass=True)]),
    lambda M: M.Classifier([M.IOClass("d"), M.IOClass("a", ways_frac=0.6),
                            M.IOClass("b", ways_frac=0.5)]),
])
def test_constructors_raise_as_the_reference(make):
    with pytest.raises(ValueError) as want:
        make(J)
    with pytest.raises(ValueError) as got:
        make(T)
    assert str(got.value) == str(want.value)
