"""Port parity: the four public helpers of ported modules — ``table_len``
and ``PopularityTracker.score`` (``repro_torch.core.popularity``),
``reuse_distances`` and ``sizing_reduction``
(``repro_torch.kernels.reuse_distance.ops``) — on the reference's own
cases (tests/test_kernels.py's pipeline and sizing-reduction tests,
tests/test_partition_popularity.py's tracker decay,
tests/test_maintenance_kernels.py's overflow test), port == JAX. The
JAX side runs its Pallas kernel in interpret mode; the port's CPU path
takes ``count_between``'s plain version (the card route is held to it in
``chip_smoke.py`` phase 18 (b) and ``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import popularity as jpop
from repro.core import reuse as jreuse
from repro.core.popularity import PopularityTracker as JTracker
from repro.core.policies import Policy as JPolicy
from repro.kernels.reuse_distance import ops as jops

from repro_torch.core import popularity as tpop
from repro_torch.core import reuse as treuse
from repro_torch.core.policies import Policy
from repro_torch.core.popularity import PopularityTracker
from repro_torch.kernels.reuse_distance import ops as tops

KINDS = ["urd", "trd", "wss", "reuse_intensity"]


def _trace(seed, n=400, space=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, space, n).astype(np.int32),
            rng.random(n) < 0.4)


@pytest.mark.parametrize("policy", ["WB", "RO", "WBWO"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reads_only", [True, False])
def test_reuse_distances_match_jax(policy, seed, reads_only):
    addr, w = _trace(seed)
    want = jops.reuse_distances(addr, w, JPolicy[policy],
                                sizing_reads_only=reads_only)
    got = tops.reuse_distances(addr, w, Policy[policy],
                               sizing_reads_only=reads_only, device="cpu")
    for name in ("dist", "served", "touch"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if reads_only:      # the reference test's own oracle
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(
            jreuse.pod_distances(addr, w, JPolicy[policy]).dist))


@pytest.mark.parametrize("kind", KINDS)
def test_sizing_reduction_matches_jax(kind):
    """One trace, then its bucket-padded row with ``n_valid`` and the
    read count: port == JAX, and == the batched sizing path."""
    addr, w = _trace(3)
    grid = np.arange(0, 321, 20, dtype=np.int64)
    jd, jh = jops.sizing_reduction(addr, w, kind, grid)
    d, h = tops.sizing_reduction(addr, w, kind, grid, device="cpu")
    assert d.dtype == torch.int32 and d.dim() == 0
    assert int(d) == int(jd)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    demands, hits, reads = treuse.sizing_metrics_batch([addr], [w], kind,
                                                       grid, device="cpu")
    assert int(d) == int(demands[0])
    np.testing.assert_array_equal(h.numpy().astype(np.int64), hits[0])
    pad = treuse._PAD_BASE + np.arange(112, dtype=np.int32)
    a_pad = np.concatenate([addr, pad])
    w_pad = np.concatenate([w, np.ones(112, bool)])
    want = jops.sizing_reduction(a_pad, w_pad, kind, grid, n_valid=400,
                                 with_reads=True)
    got = tops.sizing_reduction(a_pad, w_pad, kind, grid, n_valid=400,
                                with_reads=True, device="cpu")
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert int(got[2]) == int(reads[0]) == int(np.sum(~w))


def test_sizing_reduction_rejects_unknown_kind():
    addr, w = _trace(0, n=8)
    with pytest.raises(ValueError):
        tops.sizing_reduction(addr, w, "pod", np.arange(4), device="cpu")


def test_tracker_score_matches_jax():
    """tests/test_partition_popularity.py::test_tracker_decay, and an
    unknown address, on both trackers."""
    for cls in (JTracker, PopularityTracker):
        t = cls(decay=0.5)
        t.update(np.array([1]), np.array([1.0]))
        t.update(np.array([2]), np.array([1.0]))
        assert t.score(1) == pytest.approx(0.5)
        assert t.score(2) == pytest.approx(1.0)
        assert t.score(7) == 0.0
    rng = np.random.default_rng(5)
    j, p = JTracker(decay=0.5), PopularityTracker(decay=0.5)
    for _ in range(4):
        a = rng.integers(0, 30, 40)
        c = rng.random(40).astype(np.float32)
        j.update(a, c)
        p.update(a, c)
    for addr in range(32):
        got, want = p.score(addr), j.score(addr)
        assert isinstance(got, float)
        assert np.float32(got).tobytes() == np.float32(want).tobytes()


@pytest.mark.parametrize("k,d,seed", [(1, 1, 0), (4, 3, 1), (4, 16, 2),
                                      (8, 8, 3), (5, 32, 4)])
def test_table_len_after_overflow_matches_jax(k, d, seed):
    """tests/test_maintenance_kernels.py's overflow case: ``min(d, k)``
    entries after one update, ``max(d - k, 0)`` drops; port == JAX."""
    rng = np.random.default_rng(seed)
    addrs = rng.choice(1000, size=d, replace=False).astype(np.int32)
    contrib = (rng.random(d) + 0.01).astype(np.float32)
    nval = np.asarray([d], np.int32)
    live = np.asarray([True])
    jt, jdrops = jpop.table_update(jpop.table_init(1, k), addrs[None],
                                   contrib[None], nval, live, 0.5)
    tt, tdrops = tpop.table_update(
        tpop.table_init(1, k, device="cpu"), torch.from_numpy(addrs[None]),
        torch.from_numpy(contrib[None]), torch.from_numpy(nval),
        torch.from_numpy(live), 0.5)
    got = tpop.table_len(tt)
    assert got.dtype == torch.int32 and got.shape == (1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpop.table_len(jt)))
    assert int(got[0]) == min(d, k)
    assert int(tdrops[0]) == int(np.asarray(jdrops)[0]) == max(d - k, 0)


def test_table_len_counts_rows():
    t = tpop.table_init(3, 4, device="cpu")
    t.addr[0, :2] = torch.tensor([5, 9], dtype=torch.int32)
    t.addr[2] = torch.arange(4, dtype=torch.int32)
    assert tpop.table_len(t).tolist() == [2, 0, 4]
    from repro_torch.core import table_len
    assert table_len is tpop.table_len
