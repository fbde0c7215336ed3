"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips itself when no CUDA device is present
(the CPU tests cover the plain versions against the JAX package). On a
machine with a card they build the kernels from ``src/repro_torch/csrc``
and require exact equality, float32 bit for bit::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def test_count_between_kernel(dev):
    from repro_torch.core import reuse
    from repro_torch.kernels.reuse_distance import ops
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 300, (5, 1000)).astype(
        np.int32)).to(dev)
    touch = torch.from_numpy(rng.random((5, 1000)) < 0.7).to(dev)
    prev = reuse._prev_same(a, touch)
    nt = reuse._next_same(a, touch)
    _same([ops.count_between(prev, touch, nt)],
          [ops.count_between_plain(prev, touch, nt)])


@pytest.mark.parametrize("npe", [False, True])
def test_two_level_kernel(dev, npe):
    from repro_torch.core.simulator import make_cache_batch
    from repro_torch.kernels.datapath import ops
    rng = np.random.default_rng(1)
    v, n = 6, 700
    a = rng.integers(0, 900, (v, n)).astype(np.int32)
    a[rng.random((v, n)) < 0.1] = -1
    a = torch.from_numpy(a).to(dev)
    w = torch.from_numpy(rng.random((v, n)) < 0.35).to(dev)
    ways = torch.tensor([0, 1, 7, 33, 64, 64], dtype=torch.int32, device=dev)
    state = (*make_cache_batch(v, 8, 64, dev), *make_cache_batch(v, 16, 64,
                                                                 dev))
    t0 = torch.arange(v, dtype=torch.int32, device=dev) * 5
    _same(ops.two_level(a, w, *state, ways, ways.flip(0), t0, npe=npe),
          ops.two_level_plain(a, w, *state, ways, ways.flip(0), t0, npe=npe))


def test_scatter_kernels(dev):
    from repro_torch.kernels.maintenance import ops
    rng = np.random.default_rng(2)
    v, s, w = 4, 16, 8
    tags = np.where(rng.random((v, s, w)) < 0.6,
                    rng.integers(0, 20, (v, s, w)) * s + np.arange(s)[:, None],
                    -1).astype(np.int32)
    lru = rng.integers(0, 99, (v, s, w)).astype(np.int32)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    st = [torch.from_numpy(x).to(dev) for x in (tags, lru, dirty)]
    q = np.full((v, 3000), -1, np.int32)        # more than one smem tile
    q[:, 2500:2560] = rng.integers(0, 320, (v, 60))
    q = torch.from_numpy(q).to(dev)
    _same(ops.evict_scatter(*st, q), ops.evict_scatter_plain(*st, q))
    pq = torch.from_numpy(np.stack([rng.permutation(320)[:100]
                                    for _ in range(v)]).astype(
                                        np.int32)).to(dev)
    ways = torch.tensor([0, 3, 8, 8], dtype=torch.int32, device=dev)
    t = torch.tensor([5, 6, 7, 8], dtype=torch.int32, device=dev)
    _same(ops.promote_scatter(*st, pq, ways, t),
          ops.promote_scatter_plain(*st, pq, ways, t))


def test_controller_card_equals_cpu(dev):
    from repro_torch import kernels
    from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
    from repro_torch.core.trace import interleave
    from repro_torch.traces.generators import make
    trace = interleave([make(n, 1500, seed=i, addr_offset=i * 10_000_000,
                             scale=0.25) for i, n in
                        enumerate(["hm_1", "usr_0", "web_3", "ts_0"])],
                       seed=42)
    geo = Geometry(16, 32)
    cfg = EticaConfig(dram_capacity=400, ssd_capacity=800,
                      geometry_dram=geo, geometry_ssd=geo,
                      resize_interval=2000, promo_interval=500)
    for quota, extra in ((0, ()), (4, ("clean_scatter",))):
        cfg.clean_quota = quota
        kernels.reset_launch_counts()
        card = EticaCache(cfg, 4, device="cuda").run(trace)
        n = kernels.launch_counts()
        assert all(n[k] > 0 for k in ETICA_KERNELS + extra), n
        cpu = EticaCache(cfg, 4, device="cpu").run(trace)
        _same_results(card, cpu)


ETICA_KERNELS = ("count_between", "evict_scatter", "promote_scatter",
                 "two_level", "run_sums")


def _same_results(card, cpu):
    for a, b in zip(card, cpu):
        assert a.stats == b.stats
        assert np.array_equal(a.alloc_history, b.alloc_history)


def _state(rng, v, s, w, lru_hi=99):
    tags = np.where(rng.random((v, s, w)) < 0.7,
                    rng.integers(0, 20, (v, s, w)) * s + np.arange(s)[:, None],
                    -1).astype(np.int32)
    lru = rng.integers(0, lru_hi, (v, s, w)).astype(np.int32)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def test_clean_scatter_kernel(dev):
    from repro_torch.kernels.maintenance import ops
    rng = np.random.default_rng(3)
    v, s, w = 5, 24, 16                     # S*W = 384: two blocks per VM
    st = [torch.from_numpy(x).to(dev) for x in _state(rng, v, s, w, 7)]
    ways = torch.tensor([0, 3, 16, 9, 16], dtype=torch.int32, device=dev)
    quota = torch.tensor([4, 0, 500, 7, 1], dtype=torch.int32, device=dev)
    lcut, icut, _, _ = ops._clean_cutoffs(st[2], st[1], ways, quota)
    got = ops.clean_scatter(st[2], st[1], ways, lcut, icut)
    _same(got, ops.clean_scatter_plain(st[2], st[1], ways, lcut, icut))
    cpu = [x.cpu() for x in (st[2], st[1], ways, quota)]
    lc, ic, _, _ = ops._clean_cutoffs(*cpu)
    _same([lcut.cpu(), icut.cpu()], [lc, ic])
    assert int(got[1].sum()) > 0


def test_single_level_kernel(dev):
    from repro_torch.core.policies import Policy
    from repro_torch.core.simulator import make_cache_batch, policy_flags
    from repro_torch.kernels.datapath import ops
    rng = np.random.default_rng(4)
    pols = [Policy(p) for p in ("WB", "WT", "RO", "WO", "WBWO", "WT")]
    v, n = len(pols), 900
    a = rng.integers(0, 700, (v, n)).astype(np.int32)
    a[rng.random((v, n)) < 0.1] = -1
    a = torch.from_numpy(a).to(dev)
    w = torch.from_numpy(rng.random((v, n)) < 0.4).to(dev)
    ways = torch.tensor([64, 0, 33, 7, 1, 40], dtype=torch.int32, device=dev)
    state = make_cache_batch(v, 8, 64, dev)
    flags = policy_flags(pols, dev)
    t0 = torch.arange(v, dtype=torch.int32, device=dev) * 3
    _same(ops.single_level(a, w, *state, ways, *flags, t0, t_cache=2e-5),
          ops.single_level_plain(a, w, *state, ways, *flags, t0,
                                 t_cache=2e-5))


def test_eci_card_equals_cpu(dev):
    from repro_torch import kernels
    from repro_torch.core.baselines import make_eci_cache
    from repro_torch.core.controller import Geometry
    from repro_torch.core.trace import interleave
    from repro_torch.traces.generators import make
    trace = interleave([make(n, 1500, seed=i, addr_offset=i * 10_000_000,
                             scale=0.25) for i, n in
                        enumerate(["hm_1", "usr_0", "web_3", "ts_0"])],
                       seed=42)
    kw = dict(geometry=Geometry(16, 32), resize_interval=2000)
    kernels.reset_launch_counts()
    card = make_eci_cache(1200, 4, device="cuda", **kw).run(trace)
    n = kernels.launch_counts()
    assert n["count_between"] > 0 and n["single_level"] > 0, n
    _same_results(card, make_eci_cache(1200, 4, device="cpu",
                                       **kw).run(trace))
