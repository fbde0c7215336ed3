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
    kernels.reset_launch_counts()
    card = EticaCache(cfg, 4, device="cuda").run(trace)
    assert all(n > 0 for n in kernels.launch_counts().values())
    cpu = EticaCache(cfg, 4, device="cpu").run(trace)
    for a, b in zip(card, cpu):
        assert a.stats == b.stats
        assert np.array_equal(a.alloc_history, b.alloc_history)
