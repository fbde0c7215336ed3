"""Port parity: the ``popularity`` op, the dedupe branch of the promote
scatter, the trackers' queue methods and the staged/sequential
maintenance ops vs the JAX package.

The port's ``popularity`` plain version (what it runs on CPU tensors)
against the JAX Pallas kernel in interpret mode (within the JAX test's
allclose: the Pallas kernel sums each block in another order) and bit
for bit against the reference's ``block_scores(addr,
contributions(...))``, which is what the port's kernel computes; the
promote scatter with repeated addresses against the JAX ``ops.promote``
and ``promote_ref``; ``PopularityTracker``'s queue methods, ties
included; the per-state and staged maintenance ops and their numpy
oracles.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import popularity as jpop
from repro.core import simulator as jsim
from repro.core.simulator import CacheState as JState
from repro.kernels.maintenance import ops as jmops
from repro.kernels.maintenance import ref as jmref
from repro.kernels.popularity import ops as jpops
from repro.kernels.popularity.kernel import popularity as jpopularity
from repro.kernels.popularity.ref import popularity_ref as jpopularity_ref

from repro_torch.core import popularity as tpop
from repro_torch.core import simulator as tsim
from repro_torch.core.simulator import CacheState
from repro_torch.kernels.maintenance import ops as tmops
from repro_torch.kernels.maintenance import ref as tmref
from repro_torch.kernels.popularity import ops as tpops


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stream(n, nb, cs):
    rng = np.random.default_rng(n + int(cs))
    dist = rng.integers(-1, 300, n).astype(np.int32)
    served = rng.integers(0, 2, n).astype(bool)
    seg = rng.integers(0, nb, n).astype(np.int32)
    return dist, served, seg


@pytest.mark.parametrize("n,nb", [(64, 5), (1000, 300), (5000, 997)])
@pytest.mark.parametrize("cs", [1.0, 64.0, 4096.0])
def test_popularity_plain_matches_pallas(n, nb, cs):
    """The cases of tests/test_kernels.py, with its tolerance; and bit
    for bit the reference's block sums in access order."""
    dist, served, seg = _stream(n, nb, cs)
    got = tpops.popularity(_t(dist), _t(served), _t(seg), nb, cs).numpy()
    want = jpopularity(jnp.asarray(dist), jnp.asarray(served),
                       jnp.asarray(seg), nb, cs)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    contrib = np.asarray(jpop.contributions(dist, served, np.float32(cs)))
    exact = np.zeros(nb, np.float32)
    np.add.at(exact, seg, contrib)
    assert np.array_equal(_bits(got), _bits(exact))
    ref = tpops.popularity_ref(_t(dist), _t(served), _t(seg), nb, cs)
    jref = jpopularity_ref(jnp.asarray(dist), jnp.asarray(served),
                           jnp.asarray(seg), nb, cs)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_block_popularity_matches_block_scores(seed):
    rng = np.random.default_rng(10 + seed)
    n = int(rng.integers(50, 700))
    addr = rng.integers(0, n // 3 + 1, n).astype(np.int32)
    dist = rng.integers(-1, 2 * n, n).astype(np.int32)
    served = rng.random(n) < 0.6
    cs = float(rng.choice([0, 1, 16, 512, 4096]))
    uniq, scores = tpops.block_popularity(addr, _t(dist), _t(served), cs)
    ja, js = jpop.block_scores(addr, jpop.contributions(dist, served, cs))
    assert np.array_equal(uniq, ja) and np.array_equal(_bits(scores),
                                                       _bits(js))
    pa, ps = jpops.block_popularity(addr, jnp.asarray(dist),
                                    jnp.asarray(served), cs)
    assert np.array_equal(uniq, pa)
    np.testing.assert_allclose(scores, ps, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_block_popularity_batch_matches_per_vm(seed):
    """One [V, N] call == the reference's per-VM block_scores of each
    VM's valid prefix, with -1 padding, a VM with no valid entry and
    per-VM cache sizes (one of them 0)."""
    rng = np.random.default_rng(20 + seed)
    v, n = 5, 256
    lens = rng.integers(1, n + 1, v)
    lens[2] = 0
    addr = np.full((v, n), -1, np.int32)
    dist = rng.integers(-1, 500, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    for i in range(v):
        addr[i, :lens[i]] = rng.integers(0, 90, lens[i]) + 1000 * i
    cs = np.array([0, 64, 7, 4096, 100], np.float32)
    out = tpops.block_popularity_batch(_t(addr), _t(dist), _t(served),
                                       _t(cs))
    for i in range(v):
        if lens[i] == 0:
            assert out[i] is None
            continue
        k = lens[i]
        ja, js = jpop.block_scores(
            addr[i, :k], jpop.contributions(dist[i, :k], served[i, :k],
                                            cs[i]))
        assert np.array_equal(out[i][0], ja)
        assert np.array_equal(_bits(out[i][1]), _bits(js))


def _state(rng, v, s, w, addr_space=60):
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            cand = rng.permutation(np.arange(j, addr_space, s))
            nfill = int(rng.integers(0, w + 1))
            tags[i, j, :nfill] = cand[:nfill]
    lru = rng.integers(-1, 100, tags.shape).astype(np.int32)
    dirty = (rng.random(tags.shape) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def _assert_state(want, got, msg=""):
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), msg


@pytest.mark.parametrize("seed", range(6))
def test_promote_dedupe_matches_jax(seed):
    """Queues with repeated addresses (resident and absent ones, inside
    one 32-entry batch and across batches): port == JAX ops.promote
    (interpret, dedupe on) == promote_ref."""
    rng = np.random.default_rng(300 + seed)
    v, s, w = 4, int(rng.integers(2, 9)), int(rng.integers(1, 8))
    tags, lru, dirty = _state(rng, v, s, w)
    queues = [rng.integers(-1, 70, int(rng.integers(0, 90)))
              for _ in range(v)]
    queues[0] = np.repeat(rng.permutation(70)[:20], 3)
    queues[1] = np.concatenate([queues[1], queues[1][::-1]])
    width = 1 << (max(len(q) for q in queues) - 1).bit_length()
    q = np.full((v, width), -1, np.int32)
    for i, row in enumerate(queues):
        q[i, :len(row)] = row
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[3] = w
    t = rng.integers(0, 100, v).astype(np.int32)
    jst, jn = jmops.promote(JState(*map(jnp.asarray, (tags, lru, dirty))),
                            q, ways, t, interpret=True)
    tst, tn = tmops.promote(CacheState(_t(tags), _t(lru), _t(dirty)), _t(q),
                            _t(ways), _t(t))
    _assert_state(jst, tst, "promote dedupe")
    assert np.array_equal(np.asarray(jn), tn.numpy())
    ref = tmref.promote_ref(tags, lru, dirty, queues, ways, t)
    jref = jmref.promote_ref(tags, lru, dirty, queues, ways, t)
    for a, b, c in zip(ref, jref, (*tst, tn)):
        assert np.array_equal(a, b) and np.array_equal(a, c.numpy())


@pytest.mark.parametrize("seed", range(2))
def test_maintenance_refs_match_jax(seed):
    """The port's numpy copy of maintenance/ref.py == the reference."""
    rng = np.random.default_rng(400 + seed)
    v, s, w = 3, 4, 6
    tags, lru, dirty = _state(rng, v, s, w)
    queues = [rng.integers(-1, 60, int(rng.integers(0, 12)))
              for _ in range(v)]
    ways = rng.integers(0, w + 1, v)
    quota = rng.integers(0, 9, v)
    for a, b in zip(tmref.evict_ref(tags, lru, dirty, queues),
                    jmref.evict_ref(tags, lru, dirty, queues)):
        assert np.array_equal(a, b)
    for a, b in zip(tmref.clean_ref(tags, lru, dirty, ways, quota),
                    jmref.clean_ref(tags, lru, dirty, ways, quota)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_staged_batch_ops_match_jax(seed):
    """evict_blocks_batch / promote_blocks_batch / clean_batch over
    ragged per-VM queues (empty ones, duplicates) == the JAX vmapped
    dispatches."""
    rng = np.random.default_rng(500 + seed)
    v, s, w = 4, 4, 8
    tags, lru, dirty = _state(rng, v, s, w, addr_space=80)
    jst = JState(*map(jnp.asarray, (tags, lru, dirty)))
    tst = CacheState(_t(tags), _t(lru), _t(dirty))
    equeues = [rng.integers(0, 80, int(rng.integers(0, 10)))
               for _ in range(v)]
    equeues[1] = np.empty(0, np.int64)
    j1, jfl = jsim.evict_blocks_batch(jst, equeues)
    t1, tfl = tsim.evict_blocks_batch(tst, equeues)
    _assert_state(j1, t1, "evict")
    assert np.array_equal(np.asarray(jfl), tfl.numpy())
    pqueues = [np.repeat(rng.integers(0, 80, int(rng.integers(0, 12))), 2)
               for _ in range(v)]
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    t = rng.integers(0, 50, v).astype(np.int32)
    j2, jn = jsim.promote_blocks_batch(j1, pqueues, ways, t)
    t2, tn = tsim.promote_blocks_batch(t1, pqueues, ways, t)
    _assert_state(j2, t2, "promote")
    assert np.array_equal(np.asarray(jn), tn.numpy())
    quota = rng.integers(0, 6, v).astype(np.int32)
    j3, jc, jl = jsim.clean_batch(j2, ways, quota)
    t3, tc, tl = tsim.clean_batch(t2, ways, quota)
    _assert_state(j3, t3, "clean")
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_per_state_ops_and_refs_match_jax(seed):
    """One VM's evict_blocks / promote_blocks and the numpy resize,
    evict, promote and clean oracles == the reference's."""
    rng = np.random.default_rng(600 + seed)
    s, w = 4, 8
    tags, lru, dirty = (x[0] for x in _state(rng, 1, s, w, addr_space=80))
    jst = jsim.CacheState(*map(jnp.asarray, (tags, lru, dirty)))
    tst = CacheState(_t(tags), _t(lru), _t(dirty))
    assert np.array_equal(np.sort(jsim.resident_blocks(jst, 5)),
                          np.sort(tsim.resident_blocks(tst, 5)))
    evict = rng.integers(-1, 80, 9)
    promote = np.repeat(rng.integers(-1, 80, 7), 2)
    ways, t = int(rng.integers(0, w + 1)), int(rng.integers(0, 99))
    for jfn, tfn, args in (
            (jsim.evict_blocks, tsim.evict_blocks, (evict,)),
            (jsim.evict_blocks_ref, tsim.evict_blocks_ref, (evict,)),
            (jsim.promote_blocks, tsim.promote_blocks, (promote, ways, t)),
            (jsim.promote_blocks_ref, tsim.promote_blocks_ref,
             (promote, ways, t)),
            (jsim.resize_ref, tsim.resize_ref, (w, ways)),
            (jsim.clean_blocks_ref, tsim.clean_blocks_ref, (ways, 3))):
        jout, tout = jfn(jst, *args), tfn(tst, *args)
        _assert_state(jout[0], tout[0], jfn.__name__)
        for a, b in zip(jout[1:], tout[1:]):
            assert int(a) == int(b), jfn.__name__


def _trackers(seed):
    """A JAX and a port tracker fed the same windows, with tied scores
    (repeated contribution values) and decayed entries."""
    rng = np.random.default_rng(700 + seed)
    jt, tt = jpop.PopularityTracker(0.5), tpop.PopularityTracker(0.5)
    for n in (40, 90, 25):
        addr = rng.integers(0, 60, n)
        contrib = rng.choice(np.float32([0, 0.25, 0.5, 1.0]), n)
        jt.update(addr, contrib)
        tt.update(addr, contrib)
    return rng, jt, tt


@pytest.mark.parametrize("seed", range(4))
def test_tracker_queues_match_jax(seed):
    rng, jt, tt = _trackers(seed)
    for _ in range(4):
        cand = rng.permutation(70)[:int(rng.integers(0, 40))]
        frac = float(rng.choice([0.05, 0.3, 1.0]))
        limit = int(rng.integers(0, 30))
        assert np.array_equal(jt.least_popular(cand, frac),
                              tt.least_popular(cand, frac))
        assert np.array_equal(jt.most_popular(cand, frac, limit),
                              tt.most_popular(cand, frac, limit))
        assert np.array_equal(jt.most_popular(cand, frac),
                              tt.most_popular(cand, frac))
        assert np.array_equal(jt.top_known(cand, limit),
                              tt.top_known(cand, limit))


def test_tracker_decay_and_merge_equal_update():
    """decay + merge(block scores) — the staged path's split — leaves the
    tracker where update leaves it."""
    rng = np.random.default_rng(8)
    a, b = tpop.PopularityTracker(0.5), tpop.PopularityTracker(0.5)
    for n in (30, 80, 5):
        addr = rng.integers(0, 50, n)
        contrib = rng.random(n).astype(np.float32)
        a.update(addr, contrib)
        b.decay()
        b.merge(*tpop.block_scores(addr, contrib))
        assert np.array_equal(a._addr, b._addr)
        assert np.array_equal(_bits(a._val), _bits(b._val))
