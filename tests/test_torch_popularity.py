"""Port parity: float32 popularity arithmetic vs XLA:CPU.

``exp_xla_f32`` is held live against ``jnp.exp`` (so an XLA upgrade that
changes ``exp`` fails here), the Eq. 1 contributions and the ``[V, K]``
popularity table against ``repro.core.popularity`` bit for bit —
including merges that overflow K, scores decayed into the subnormal
range (XLA flushes them; the port must too) and tied scores in the
promotion order.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import popularity as jpop

from repro_torch._xla_math import exp_xla_f32, ftz
from repro_torch.core import popularity as tpop


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_exp_matches_xla_on_the_sweep():
    """[-120, 60] densely, and every -d/cs the controller can form for
    d < 65536 at the paper's and the benchmarks' cache sizes."""
    d = np.arange(65536, dtype=np.float32)
    xs = [np.linspace(-120, 60, 1_000_003, dtype=np.float32)]
    for cs in (1, 16, 64, 512, 1000, 2048, 4095, 4096, 128, 1024):
        xs.append(-d / np.float32(cs))
    x = np.concatenate(xs)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp_xla_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(want), _bits(got))


def test_ftz_flushes_subnormals_like_xla():
    tiny = np.float32(2.0 ** -125)
    want = np.asarray(jax.jit(lambda a: a * 0.5 * 0.5)(tiny))
    got = ftz(ftz(torch.tensor(tiny) * 0.5) * 0.5)
    assert float(want) == 0.0 == float(got)
    x = torch.tensor([1e-39, -1e-39, 1.2e-38, 3.0])
    assert ftz(x).tolist() == [0.0, 0.0, pytest.approx(1.2e-38), 3.0]


@pytest.mark.parametrize("seed", range(3))
def test_contributions_match(seed):
    rng = np.random.default_rng(seed)
    dist = rng.integers(-1, 5000, (8, 512)).astype(np.int32)
    served = rng.random((8, 512)) < 0.7
    cs = np.array([1, 16, 64, 512, 1000, 2048, 4095, 0], np.int32)[:, None]
    want = jpop.contributions(dist, served, cs)
    got = tpop.contributions(torch.from_numpy(dist), torch.from_numpy(served),
                             torch.from_numpy(cs))
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def _update_both(jt, tt, waddr, contrib, nval, live, decay=0.5):
    jt, jd = jpop.table_update(jt, waddr, contrib, nval, live, decay)
    tt, td = tpop.table_update(tt, torch.from_numpy(waddr),
                               torch.from_numpy(contrib),
                               torch.from_numpy(nval), torch.from_numpy(live),
                               decay)
    assert np.array_equal(np.asarray(jt.addr), tt.addr.numpy())
    assert np.array_equal(_bits(jt.val), _bits(tt.val.numpy()))
    assert np.array_equal(np.asarray(jd), td.numpy())
    return jt, tt, td


@pytest.mark.parametrize("k", [4, 16, 64])
def test_table_update_matches_with_overflow(k):
    rng = np.random.default_rng(k)
    v, n = 4, 48
    jt, tt = jpop.table_init(v, k), tpop.table_init(v, k, device="cpu")
    total_drops = 0
    for step in range(6):
        waddr = rng.integers(0, 40, (v, n)).astype(np.int32)
        contrib = np.where(rng.random((v, n)) < 0.7,
                           rng.random((v, n)), 0.0).astype(np.float32)
        nval = rng.integers(0, n + 1, v).astype(np.int32)
        live = (nval > 0) & (rng.random(v) < 0.8)
        jt, tt, drops = _update_both(jt, tt, waddr, contrib, nval, live)
        total_drops += int(drops.sum())
    if k == 4:
        assert total_drops > 0      # the small table overflows


def test_decay_into_subnormals_matches():
    """A score halved ~130 times crosses the subnormal range: XLA flushes
    it to zero, so the block stops being a promotion candidate."""
    v, k = 1, 8
    jt, tt = jpop.table_init(v, k), tpop.table_init(v, k, device="cpu")
    waddr = np.array([[5, 9]], np.int32)
    contrib = np.array([[1e-30, 1.0]], np.float32)
    nval = np.array([2], np.int32)
    live = np.array([True])
    jt, tt, _ = _update_both(jt, tt, waddr, contrib, nval, live)
    idle = np.zeros((1, 2), np.float32)
    for _ in range(40):
        jt, tt, _ = _update_both(jt, tt, waddr, idle, nval, live)
    assert float(tt.val[0, 0]) == 0.0 < float(tt.val[0, 1])
    tags = torch.full((1, 2, 2), -1, dtype=torch.int32)
    q, n = tpop.table_top_known(tt, tags, torch.tensor([2], dtype=torch.int32),
                                torch.tensor([4], dtype=torch.int32),
                                torch.tensor([True]), width=4)
    jq, jn = jpop.table_top_known(jt, jnp.asarray(tags.numpy()),
                                  np.array([2], np.int32),
                                  np.array([4], np.int32), np.array([True]),
                                  width=4)
    assert np.array_equal(np.asarray(jq), q.numpy()) and q[0, 0] == 9
    assert int(n[0]) == int(jn[0]) == 1


def _table_with_ties(v, k, rng):
    """A populated table with many equal scores."""
    jt, tt = jpop.table_init(v, k), tpop.table_init(v, k, device="cpu")
    waddr = rng.integers(0, 40, (v, 32)).astype(np.int32)
    contrib = rng.choice(np.float32([0.25, 0.5, 1.0]), (v, 32))
    nval = np.full(v, 32, np.int32)
    live = np.ones(v, bool)
    return _update_both(jt, tt, waddr, contrib, nval, live)[:2]


@pytest.mark.parametrize("seed", range(3))
def test_queues_match_with_ties(seed):
    rng = np.random.default_rng(seed)
    v, s, w, k = 3, 5, 4, 64
    jt, tt = _table_with_ties(v, k, rng)
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            cand = rng.permutation(np.arange(j, 40, s))
            nf = int(rng.integers(0, w + 1))
            tags[i, j, :nf] = cand[:nf]
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    alloc = ways * s
    live = np.array([True, True, seed != 1])
    limit = rng.integers(0, 15, v).astype(np.int32)
    t = lambda x: torch.from_numpy(np.asarray(x))
    je = jpop.table_least_popular(jt, jnp.asarray(tags), ways, alloc, live,
                                  0.3)
    te = tpop.table_least_popular(tt, t(tags), t(ways), t(alloc), t(live),
                                  0.3)
    for a, b in zip(je, te):
        assert np.array_equal(np.asarray(a), b.numpy())
    for width in (16, 128):
        jp = jpop.table_top_known(jt, jnp.asarray(tags), ways, limit, live,
                                  width=width)
        tp = tpop.table_top_known(tt, t(tags), t(ways), t(limit), t(live),
                                  width=width)
        for a, b in zip(jp, tp):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_truncate_queue_matches():
    q = np.arange(12, dtype=np.int32).reshape(2, 6)
    for width in (3, 6, 9):
        assert np.array_equal(
            np.asarray(jpop.truncate_queue(q, width)),
            tpop.truncate_queue(torch.from_numpy(q), width).numpy())
