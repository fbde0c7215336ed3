"""Port parity: policies, traces, generators and resize vs the JAX package.

The same numpy inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``); outputs must be identical.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import policies as jpolicies
from repro.core import simulator as jsim
from repro.core import trace as jtrace
from repro.traces import generators as jgen

from repro_torch.core import policies as tpolicies
from repro_torch.core import simulator as tsim
from repro_torch.core import trace as ttrace
from repro_torch.traces import generators as tgen


def test_policies_and_latencies_match():
    for jp, tp in zip(jpolicies.Policy, tpolicies.Policy):
        assert jp.value == tp.value
        for attr in ("allocates_reads", "allocates_writes",
                     "write_invalidates", "write_through", "holds_dirty"):
            assert getattr(jp, attr) == getattr(tp, attr), (jp, attr)
    for name in ("T_DRAM", "T_SSD", "T_HDD", "T_HDD_WRITE"):
        assert getattr(jpolicies, name) == getattr(tpolicies, name)


@pytest.mark.parametrize("name", sorted(jgen.SPECS))
def test_generators_match(name):
    for seed, offset, scale in ((0, 0, 1.0), (3, 10_000_000, 0.25)):
        a = jgen.make(name, 700, seed=seed, addr_offset=offset, scale=scale)
        b = tgen.make(name, 700, seed=seed, addr_offset=offset, scale=scale)
        assert np.array_equal(a.addr, b.addr) and a.addr.dtype == b.addr.dtype
        assert np.array_equal(a.is_write, b.is_write)
        assert (a.size is None) == (b.size is None)
        if a.size is not None:
            assert np.array_equal(a.size, b.size)


def _mix(mod, gen, names, reqs, seed=7):
    return mod.interleave(
        [gen.make(n, reqs, seed=i, addr_offset=i * 10_000_000, scale=0.25)
         for i, n in enumerate(names)], seed=seed)


def test_interleave_split_and_pad_match():
    names = ["hm_1", "usr_0", "web_3", "mixed_block"]
    a = _mix(jtrace, jgen, names, 300)
    b = _mix(ttrace, tgen, names, 300)
    for f in ("addr", "is_write", "vm", "size"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    window_a, window_b = a[100:900], b[100:900]
    subs_a = jtrace.split_by_vm(window_a, 5)        # VM 4 stays empty
    subs_b = ttrace.split_by_vm(window_b, 5)
    for sa, sb in zip(subs_a, subs_b):
        assert np.array_equal(sa.addr, sb.addr)
        assert np.array_equal(sa.is_write, sb.is_write)
        assert np.array_equal(sa.sizes(), sb.sizes())
    chunks_a = [s[:150] if i % 2 else None for i, s in enumerate(subs_a)]
    chunks_b = [s[:150] if i % 2 else None for i, s in enumerate(subs_b)]
    for x, y in zip(jtrace.pad_batch(chunks_a, 160),
                    ttrace.pad_batch(chunks_b, 160)):
        assert np.array_equal(x, y) and x.dtype == y.dtype


def test_capacity_to_ways_matches():
    caps = np.array([0, 1, 15, 16, 17, 500, 10_000], np.int64)
    assert np.array_equal(np.asarray(jsim.capacity_to_ways(caps, 16, 32)),
                          tsim.capacity_to_ways(caps, 16, 32))


def _random_state(rng, v, s, w):
    tags = np.where(rng.random((v, s, w)) < 0.7,
                    rng.integers(0, 500, (v, s, w)), -1).astype(np.int32)
    lru = np.where(tags >= 0, rng.integers(0, 99, (v, s, w)), -1)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    return tags, lru.astype(np.int32), dirty


@pytest.mark.parametrize("seed", range(4))
def test_resize_levels_match(seed):
    rng = np.random.default_rng(seed)
    v = 6
    d = _random_state(rng, v, 4, 8)
    s = _random_state(rng, v, 8, 6)
    old_d, new_d = rng.integers(0, 9, v), rng.integers(0, 9, v)
    old_s, new_s = rng.integers(0, 7, v), rng.integers(0, 7, v)
    old_d[0], new_d[0] = 8, 8       # no-op
    old_s[1], new_s[1] = 2, 6       # grow: no flush
    old_s[2], new_s[2] = 6, 0       # shrink to nothing
    jout = jsim.resize_levels(jsim.CacheState(*map(jnp.asarray, d)),
                              jsim.CacheState(*map(jnp.asarray, s)),
                              old_d, new_d, old_s, new_s)
    tout = tsim.resize_levels(tsim.CacheState(*map(torch.from_numpy, d)),
                              tsim.CacheState(*map(torch.from_numpy, s)),
                              old_d, new_d, old_s, new_s)
    for js, ts in zip(jout[:2], tout[:2]):
        for a, b in zip(js, ts):
            assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jout[2:], tout[2:]):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert b.dtype == torch.int32


def test_make_cache_batch_matches():
    j = jsim.make_cache_batch(3, 4, 5)
    t = tsim.make_cache_batch(3, 4, 5, device="cpu")
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
