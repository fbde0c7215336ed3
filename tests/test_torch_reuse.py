"""Port parity: the reuse-distance engine vs ``repro.core.reuse``.

``count_between_plain`` against the Pallas kernel (interpret mode) and
the jnp twin; ``decompose`` for all five policies with
``sizing_reads_only`` both ways; ``pod_distances_batch`` on ragged and
empty rows; and the paper's worked examples (Figs. 5, 8, 9) through the
port.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import reuse as jreuse
from repro.core.policies import Policy as JPolicy
from repro.kernels.reuse_distance.kernel import count_between as jkernel

from repro_torch.core import reuse as treuse
from repro_torch.core import simulator as tsim
from repro_torch.core.policies import Policy
from repro_torch.core.trace import Trace
from repro_torch.kernels.reuse_distance.ops import (count_between,
                                                    count_between_plain)


def _rows(seed, v=3, n=200, space=40):
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, space, (v, n)).astype(np.int32)
    is_write = rng.random((v, n)) < 0.4
    return addr, is_write


@pytest.mark.parametrize("seed", range(3))
def test_count_between_plain_matches_pallas_and_jnp(seed):
    addr, is_write = _rows(seed)
    t = torch.from_numpy
    touch = t(is_write | (np.random.default_rng(seed).random(addr.shape)
                          < 0.5))
    prev = treuse._prev_same(t(addr), touch)
    nt = treuse._next_same(t(addr), touch)
    got = count_between_plain(prev, touch, nt)
    assert torch.equal(got, count_between(prev, touch, nt))   # CPU route
    for v in range(addr.shape[0]):
        p, tc, n = prev[v].numpy(), touch[v].numpy(), nt[v].numpy()
        want_k = jkernel(jnp.asarray(p), jnp.asarray(tc.astype(np.int32)),
                         jnp.asarray(n), ti=64, tj=128, interpret=True)
        want_j = jreuse._count_between(jnp.asarray(p), jnp.asarray(tc),
                                       jnp.asarray(n), chunk=64)
        assert np.array_equal(np.asarray(want_k), got[v].numpy())
        assert np.array_equal(np.asarray(want_j), got[v].numpy())


@pytest.mark.parametrize("seed", range(2))
def test_prev_next_same_match(seed):
    addr, is_write = _rows(seed, n=300)
    for v in range(addr.shape[0]):
        a, m = jnp.asarray(addr[v]), jnp.asarray(is_write[v])
        tp = treuse._prev_same(torch.from_numpy(addr), torch.from_numpy(
            is_write))
        tn = treuse._next_same(torch.from_numpy(addr), torch.from_numpy(
            is_write))
        assert np.array_equal(np.asarray(jreuse._prev_same(a, m)),
                              tp[v].numpy())
        assert np.array_equal(np.asarray(jreuse._next_same(a, m)),
                              tn[v].numpy())


@pytest.mark.parametrize("reads_only", [True, False])
@pytest.mark.parametrize("policy", list(Policy))
def test_decompose_matches(policy, reads_only):
    addr, is_write = _rows(7, v=4, n=256)
    jp = JPolicy(policy.value)
    want = jax.vmap(lambda a, w: jreuse._decompose(
        a, w, jp, sizing_reads_only=reads_only, chunk=64))(
            jnp.asarray(addr), jnp.asarray(is_write))
    dist, served, touch = treuse.decompose(
        torch.from_numpy(addr), torch.from_numpy(is_write), policy,
        sizing_reads_only=reads_only)
    assert np.array_equal(np.asarray(want.dist), dist.numpy())
    assert np.array_equal(np.asarray(want.served), served.numpy())
    assert np.array_equal(np.asarray(want.touch), touch.numpy())
    assert dist.dtype == torch.int32


@pytest.mark.parametrize("policy", [Policy.RO, Policy.WBWO, Policy.WB])
def test_pod_distances_batch_ragged_and_empty(policy):
    rng = np.random.default_rng(3)
    lens = [0, 37, 300, 1, 0, 129]
    addrs = [rng.integers(0, 30, n).astype(np.int32) for n in lens]
    writes = [rng.random(n) < 0.4 for n in lens]
    want = jreuse.pod_distances_batch(addrs, writes, JPolicy(policy.value))
    got = treuse.pod_distances_batch(addrs, writes, policy, device="cpu")
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is None:
            continue
        assert np.array_equal(w.dist, g.dist)
        assert np.array_equal(w.served, g.served)
        assert np.array_equal(w.touch, g.touch)
        assert int(w.max) == g.max
    want = jreuse.trd_distances_batch(addrs, writes)
    got = treuse.trd_distances_batch(addrs, writes, device="cpu")
    for w, g in zip(want, got):
        if w is not None:
            assert np.array_equal(w.dist, g.dist)


@pytest.mark.parametrize("chunk", [200, 300, 1000])
def test_block_rows_match_pad_rows(chunk):
    """The maintenance rows derived on the device from a padded datapath
    block equal the JAX controller's host-padded rows, whether the
    bucket is narrower or wider than the block."""
    from repro_torch.core.trace import pad_batch
    rng = np.random.default_rng(11)
    lens = [0, 37, 200, 1, 0, 129]
    chunks = [None if n == 0 else
              Trace(rng.integers(0, 30, n).astype(np.int32),
                    rng.random(n) < 0.4, np.zeros(n, np.int32))
              for n in lens]
    a, w = pad_batch(chunks, chunk)
    width = treuse._bucket(max(lens))
    got = treuse._block_rows(torch.from_numpy(a), torch.from_numpy(w),
                             torch.tensor(lens, dtype=torch.int32), width)
    empty = np.empty(0, np.int32)
    want = jreuse._pad_rows(
        [empty if c is None else c.addr for c in chunks],
        [empty.astype(bool) if c is None else c.is_write for c in chunks],
        list(range(len(lens))), lens)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


def test_hit_counts_and_demand_match():
    rng = np.random.default_rng(5)
    dist = rng.integers(-1, 60, 500).astype(np.int32)
    served = rng.random(500) < 0.6
    sizes = np.array([0, 16, 32, 48, 64], np.int64)
    assert np.array_equal(jreuse.hit_counts_at_sizes(dist, served, sizes),
                          treuse.hit_counts_at_sizes(dist, served, sizes))
    for m in (-1, 0, 7):
        assert jreuse.demand_blocks(m) == treuse.demand_blocks(m)


# -- the paper's worked examples (tests/test_paper_examples.py) ------------

FIG8 = Trace.from_ops([('R', 1), ('R', 2), ('R', 3), ('W', 4), ('W', 5),
                       ('R', 1), ('R', 4)])
FIG9 = Trace.from_ops([('W', 1), ('R', 2), ('R', 3), ('W', 4), ('W', 5),
                       ('R', 3), ('R', 1)])
FIG5 = Trace.from_ops([('R', 1), ('R', 2), ('R', 3), ('W', 1), ('W', 4),
                       ('R', 1), ('R', 4)])


def _max(trace, policy, reads_only=True):
    r = treuse._distances_batch([trace.addr], [trace.is_write], policy,
                                reads_only, "cpu")[0]
    return r.max


def test_fig8_wbwo():
    assert _max(FIG8, Policy.WB) == 4                 # URD: RAR S1
    assert treuse.demand_blocks(_max(FIG8, Policy.WB)) == 5
    assert _max(FIG8, Policy.WBWO) == 1               # RAW S4: {S5}
    assert treuse.demand_blocks(_max(FIG8, Policy.WBWO)) == 2


def test_fig9_ro():
    assert _max(FIG9, Policy.WB) == 4
    assert _max(FIG9, Policy.RO) == 0                 # RAR S3
    assert treuse.demand_blocks(_max(FIG9, Policy.RO)) == 1


def test_fig5_two_level_etica():
    """ETICA two-level (npe): 2 SSD writes, 2 read hits (paper: 60%
    fewer SSD writes than the one-level WB cache's 5)."""
    dram = tsim.make_cache_batch(1, 1, 3, device="cpu")
    ssd = tsim.make_cache_batch(1, 1, 3, device="cpu")
    _, _, st, _ = tsim.simulate_two_level_batch(
        FIG5.addr[None], FIG5.is_write[None], dram, ssd, 3, 3, mode="npe")
    assert int(st.cache_writes_l2) == 2
    assert int(st.read_hits_l1) + int(st.read_hits_l2) == 2


def test_pod_wb_equals_urd():
    for tr in (FIG5, FIG8, FIG9):
        assert _max(tr, Policy.WB) == _max(tr, Policy.WT)
