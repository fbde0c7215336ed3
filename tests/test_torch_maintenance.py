"""Port parity: maintenance scatters and the fused interval vs JAX.

The plain evict/promote versions (what ``repro_torch`` runs on CPU
tensors) against the JAX package's Pallas kernels in interpret mode, and
``maintenance_interval`` (``clean_quota=0``) against the JAX fused
dispatch: states, popularity table, queues and every count exact.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import popularity as jpop
from repro.core import reuse as jreuse
from repro.core.policies import Policy as JPolicy
from repro.core.simulator import CacheState as JState
from repro.kernels.maintenance import ops as jops

from repro_torch.core import popularity as tpop
from repro_torch.core import reuse as treuse
from repro_torch.core.policies import Policy
from repro_torch.core.simulator import CacheState
from repro_torch.kernels.maintenance import ops as tops


def _random_state(rng, v, s, w, addr_space=48, set_consistent=False):
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            cand = (rng.permutation(np.arange(j, addr_space, s))
                    if set_consistent else rng.permutation(addr_space))
            nfill = int(rng.integers(0, w + 1))
            tags[i, j, :nfill] = cand[:min(nfill, cand.size)]
    lru = rng.integers(-1, 100, tags.shape).astype(np.int32)
    dirty = (rng.random(tags.shape) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def _queue_matrix(queues, width=None):
    width = width or max(1, max(len(q) for q in queues))
    out = np.full((len(queues), width), -1, np.int32)
    for i, q in enumerate(queues):
        out[i, :len(q)] = q
    return out


def _assert_state(jstate, tstate, msg=""):
    for a, b in zip(jstate, tstate):
        assert np.array_equal(np.asarray(a), b.numpy()), msg


def _jstate(tags, lru, dirty):
    return JState(jnp.asarray(tags), jnp.asarray(lru), jnp.asarray(dirty))


def _tstate(tags, lru, dirty):
    return CacheState(torch.from_numpy(tags.copy()),
                      torch.from_numpy(lru.copy()),
                      torch.from_numpy(dirty.copy()))


@pytest.mark.parametrize("seed", range(6))
def test_evict_plain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v, s, w = 4, int(rng.integers(2, 9)), int(rng.integers(1, 8))
    tags, lru, dirty = _random_state(rng, v, s, w)
    # ragged: an empty queue, -1 padding, duplicates, absent addresses,
    # and a queue naming every block of the VM
    queues = [rng.integers(-1, 60, int(rng.integers(1, 20))),
              np.empty(0, np.int32), np.repeat(tags[2].reshape(-1), 2),
              rng.integers(-1, 60, 7)]
    q = _queue_matrix(queues, width=128)
    jst, jfl = jops.evict(_jstate(tags, lru, dirty), q, interpret=True)
    tst, tfl = tops.evict(_tstate(tags, lru, dirty), torch.from_numpy(q))
    _assert_state(jst, tst, "evict")
    assert np.array_equal(np.asarray(jfl), tfl.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_promote_plain_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    v, s, w = 4, int(rng.integers(2, 9)), int(rng.integers(1, 8))
    tags, lru, dirty = _random_state(rng, v, s, w)
    queues = [rng.permutation(80)[:int(rng.integers(0, 30))]
              for _ in range(v)]
    queues[1] = np.empty(0, np.int64)
    q = _queue_matrix(queues, width=32)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[2] = 0
    t = rng.integers(0, 100, v).astype(np.int32)
    jst, jn = jops.promote(_jstate(tags, lru, dirty), q, ways, t,
                           assume_unique=True, interpret=True)
    tst, tn = tops.promote(_tstate(tags, lru, dirty), torch.from_numpy(q),
                           torch.from_numpy(ways), torch.from_numpy(t))
    _assert_state(jst, tst, "promote")
    assert np.array_equal(np.asarray(jn), tn.numpy())


def test_promote_full_sets_starve():
    v, s, w = 2, 3, 4
    tags = np.stack([np.arange(s)[:, None] + s * np.arange(w)[None, :]
                     for _ in range(v)]).astype(np.int32)
    lru = np.zeros_like(tags)
    dirty = np.zeros(tags.shape, bool)
    q = np.tile(np.arange(100, 130, dtype=np.int32), (v, 1))
    ways = np.full(v, w, np.int32)
    t = np.zeros(v, np.int32)
    jst, jn = jops.promote(_jstate(tags, lru, dirty), q, ways, t,
                           assume_unique=True, interpret=True)
    tst, tn = tops.promote(_tstate(tags, lru, dirty), torch.from_numpy(q),
                           torch.from_numpy(ways), torch.from_numpy(t))
    _assert_state(jst, tst, "starve")
    assert tn.tolist() == [0, 0] == np.asarray(jn).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_maintenance_interval_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    v, s, w, k = 4, 4, 4, 16 if seed % 2 else 128
    tags, lru, dirty = _random_state(rng, v, s, w, addr_space=32,
                                     set_consistent=True)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    t = rng.integers(0, 50, v).astype(np.int32)
    jtable = jpop.table_init(v, k)
    ttable = tpop.table_init(v, k, device="cpu")
    jst, tst = _jstate(tags, lru, dirty), _tstate(tags, lru, dirty)
    for step in range(3):
        lens = [int(rng.integers(0, 40)) for _ in range(v)]
        lens[0] = 0 if step == 1 else lens[0]
        lens[1] = max(lens[1], 1)
        addrs = [rng.integers(0, 32, n).astype(np.int32) for n in lens]
        writes = [rng.random(n) < 0.4 for n in lens]
        amat, wmat = jreuse._pad_rows(addrs, writes, list(range(v)), lens)
        r = jreuse._decompose_vmapped(amat, wmat, policy=JPolicy.WB,
                                      sizing_reads_only=False, chunk=256)
        jout = jops.maintenance_interval(
            jst, jtable, r.dist, r.served, amat, np.asarray(lens, np.int32),
            ways, t, evict_frac=0.25, decay=0.5, interpret=True)
        dist, served, _ = treuse.decompose(
            torch.from_numpy(amat), torch.from_numpy(wmat), Policy.WB,
            sizing_reads_only=False)
        tout = tops.maintenance_interval(
            tst, ttable, dist, served, torch.from_numpy(amat),
            torch.tensor(lens, dtype=torch.int32), torch.from_numpy(ways),
            torch.from_numpy(t), evict_frac=0.25, decay=0.5)
        jst, jtable = jout[0], jout[1]
        tst, ttable = tout[0], tout[1]
        _assert_state(jst, tst, f"state step {step}")
        assert np.array_equal(np.asarray(jtable.addr), ttable.addr.numpy())
        assert np.array_equal(np.asarray(jtable.val).view(np.int32),
                              ttable.val.numpy().view(np.int32))
        for i, (a, b) in enumerate(zip(jout[2:], tout[2:])):
            assert np.array_equal(np.asarray(a), b.numpy()), (step, i)


def test_cleaner_gated_on_live_vms():
    """``clean_quota`` gates the cleaner on live VMs: a VM whose window
    is empty (``wlen == 0``) keeps its dirty blocks, a live one flushes
    up to the quota (the full parity sweep is in test_torch_cleaner)."""
    tags, lru, dirty = _random_state(np.random.default_rng(0), 2, 2, 2)
    dirty[:] = tags >= 0
    st = _tstate(tags, lru, dirty)
    z = torch.zeros((2, 4), dtype=torch.int32)
    out = tops.maintenance_interval(
        st, tpop.table_init(2, 8, device="cpu"), z, z.bool(), z,
        torch.tensor([0, 4], dtype=torch.int32),
        torch.full((2,), 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32),
        evict_frac=0.05, decay=0.5, clean_quota=1)
    assert dirty.sum(axis=(1, 2)).min() > 1
    assert out[7].tolist() == [0, 1]
    assert np.array_equal(out[0].dirty[0].numpy(), dirty[0])
    assert out[8].tolist() == out[0].dirty.sum(dim=(1, 2)).tolist()
