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


COUNT_SHAPES = {  # v, n, address space, touch share
    "5 x 1000": (5, 1000, 300, 0.7),
    "-seq's one VM, 1 x 1024": (1, 1024, 300, 0.7),
    "12-VM POD, 12 x 1024": (12, 1024, 300, 0.7),
    "1024 VMs x 256": (1024, 256, 60, 0.8),
    "rows past one column tile, 1 x 20000": (1, 20_000, 20_000, 0.9),
    "N 1": (3, 1, 1, 1.0),
}


@pytest.mark.parametrize("shape", list(COUNT_SHAPES))
def test_count_between_kernel(dev, shape):
    from repro_torch.core import reuse
    from repro_torch.kernels.reuse_distance import ops
    v, n, space, p_touch = COUNT_SHAPES[shape]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, space, (v, n)).astype(
        np.int32)).to(dev)
    touch = torch.from_numpy(rng.random((v, n)) < p_touch).to(dev)
    if n == 20_000:   # first touches' windows reach back to column 0,
        a[0, ::997] = 7   # across five 4,096-key tiles; these ~997 long
        touch[0, ::997] = True
    prev = reuse._prev_same(a, touch)
    nt = reuse._next_same(a, touch)
    _same([ops.count_between(prev, touch, nt)],
          [ops.count_between_plain(prev, touch, nt)])


def test_count_between_kernel_edges(dev):
    """Windows of length 0 and 1, touch all false and all true, one
    address for a whole row, arbitrary prev / nt, and no rows."""
    from repro_torch.core import reuse
    from repro_torch.kernels.reuse_distance import ops
    n = 1500
    seq = torch.arange(n, dtype=torch.int32, device=dev)[None]
    ones = torch.ones((2, n), dtype=torch.bool, device=dev)
    cases = [(seq.repeat(2, 1), ones), (seq * 0, ones[:1]),
             (seq * 0, ~ones[:1]), (seq % 2, ones[:1])]
    for a, touch in cases:
        prev = reuse._prev_same(a, touch)
        nt = reuse._next_same(a, touch)
        _same([ops.count_between(prev, touch, nt)],
              [ops.count_between_plain(prev, touch, nt)])
    rng = np.random.default_rng(3)
    prev, nt = (torch.from_numpy(rng.integers(-3, n + 3, (3, n)).astype(
        np.int32)).to(dev) for _ in range(2))
    touch = torch.from_numpy(rng.random((3, n)) < 0.6).to(dev)
    _same([ops.count_between(prev, touch, nt)],
          [ops.count_between_plain(prev, touch, nt)])
    for v, n in ((0, 8), (4, 0)):
        e = torch.zeros((v, n), dtype=torch.int32, device=dev)
        assert ops.count_between(e, e.bool(), e).shape == (v, n)


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


def _inconsistent_state(rng, v, s, w, space):
    """Tags anywhere in [0, space), unique per VM and set, as
    tests/test_torch_maintenance.py builds them: a block need not lie in
    set ``tag % S``, and one block may lie in several sets."""
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            k = int(rng.integers(0, w + 1))
            tags[i, j, :k] = rng.permutation(space)[:k]
    lru = rng.integers(-1, 100, tags.shape).astype(np.int32)
    dirty = (rng.random(tags.shape) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def _evict_queues(rng, tags, q):
    """[V, Q] queues, a kind a VM in turn: repeats and absent blocks;
    negative entries other than -1; every resident block; live entries
    on both sides of the kernel's 4,096-entry tile edge; only -1."""
    v = tags.shape[0]
    out = np.full((v, q), -1, np.int32)
    for i in range(v):
        res = tags[i][tags[i] >= 0]
        kind = i % 5
        if kind == 0:
            row = np.concatenate([np.repeat(res[:9], 3),
                                  rng.integers(0, 4 * res.size + 64, 30)])
        elif kind == 1:
            row = rng.permutation(np.concatenate(
                [res[:11], [-2, -5, -(2 ** 31), -100]]))
        elif kind == 2:
            row = rng.permutation(res)
        elif kind == 3:
            row = np.full(q, -1)
            pos = rng.choice(q, min(res.size, q), replace=False)
            row[pos] = res[:pos.size]
            if q > 4100:
                row[4093:4099] = np.resize(res, 6)
        else:
            row = np.empty(0, np.int32)
        out[i, :min(q, row.size)] = row[:q]
    return out


EVICT_SHAPES = {  # v, s, w, address space, q
    "set-inconsistent, Q 3000": (5, 16, 8, 400, 3000),
    "set-inconsistent, Q wider than a tile": (5, 16, 16, 900, 5000),
    "the five queue kinds, [12, 64, 64] Q 4096": (12, 64, 64, 8192, 4096),
    "V 1": (1, 64, 64, 9000, 4096),
    "V 1024, [1024, 16, 32] Q 512": (1024, 16, 32, 2048, 512),
    "Q 1": (3, 4, 4, 32, 1),
}


@pytest.mark.parametrize("shape", list(EVICT_SHAPES))
def test_evict_scatter_kernel(dev, shape):
    from repro_torch.kernels.maintenance import ops
    v, s, w, space, q = EVICT_SHAPES[shape]
    rng = np.random.default_rng(q + v)
    st = [torch.from_numpy(x).to(dev)
          for x in _inconsistent_state(rng, v, s, w, space)]
    queue = torch.from_numpy(_evict_queues(rng, st[0].cpu().numpy(),
                                           q)).to(dev)
    got = ops.evict_scatter(*st, queue)
    _same(got, ops.evict_scatter_plain(*st, queue))
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(got, st))


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
    # evict: Q 0, an all -1 queue, a queue naming every resident block
    # of a set-inconsistent state; no VMs, no slots
    ist = [torch.from_numpy(x).to(dev)
           for x in _inconsistent_state(rng, v, s, w, 48)]
    for eq in (np.full((v, 0), -1, np.int32), np.full((v, 64), -1, np.int32),
               np.tile(np.arange(48, dtype=np.int32), (v, 1))):
        eq = torch.from_numpy(eq).to(dev)
        for state in (st, ist):
            _same(ops.evict_scatter(*state, eq),
                  ops.evict_scatter_plain(*state, eq))
    for shape in ((0, 4, 4), (3, 0, 4)):
        e = [torch.zeros(shape, dtype=d, device=dev)
             for d in (torch.int32, torch.int32, torch.bool)]
        eq = torch.zeros((shape[0], 8), dtype=torch.int32, device=dev)
        _same(ops.evict_scatter(*e, eq), ops.evict_scatter_plain(*e, eq))
    pq = torch.from_numpy(np.stack([rng.permutation(320)[:100]
                                    for _ in range(v)]).astype(
                                        np.int32)).to(dev)
    ways = torch.tensor([0, 3, 8, 8], dtype=torch.int32, device=dev)
    t = torch.tensor([5, 6, 7, 8], dtype=torch.int32, device=dev)
    _same(ops.promote_scatter(*st, pq, ways, t),
          ops.promote_scatter_plain(*st, pq, ways, t))
    # promote: queues of only padding, of only resident blocks, and wider
    # than the kernel's 4,096-entry tile; ways 0 and W
    res = np.stack([np.resize(tags[i][tags[i] >= 0], 100)
                    for i in range(v)]).astype(np.int32)
    wide = np.full((v, 5000), -1, np.int32)
    wide[:, 4000:4200] = rng.integers(0, 320, (v, 200))
    for queue in (np.full((v, 100), -1, np.int32), res, wide):
        queue = torch.from_numpy(queue).to(dev)
        for dedupe in (True, False):
            _same(ops.promote_scatter(*st, queue, ways, t, dedupe=dedupe),
                  ops.promote_scatter_plain(*st, queue, ways, t,
                                            dedupe=dedupe))


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


def test_sharded_controller_card_equals_unsharded(dev):
    """A 4-shard mesh on cuda:0 (a ragged 5 VMs: 3 dead rows) == the
    unsharded card run: stats, histories, final states; every kernel
    launches exactly 4x the unsharded count."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
    from repro_torch.core.trace import interleave
    from repro_torch.launch.mesh import VMMesh
    from repro_torch.traces.generators import make
    trace = interleave([make(n, 1200, seed=i, addr_offset=i * 10_000_000,
                             scale=0.25) for i, n in
                        enumerate(["hm_1", "usr_0", "web_3", "ts_0",
                                   "proj_0"])], seed=0)
    geo = Geometry(8, 16)
    cfg = EticaConfig(dram_capacity=60, ssd_capacity=120, geometry_dram=geo,
                      geometry_ssd=geo, resize_interval=1500,
                      promo_interval=500, clean_quota=2)
    runs = []
    for mesh in (None, VMMesh((torch.device("cuda", 0),) * 4)):
        kernels.reset_launch_counts()
        cache = EticaCache(dataclasses.replace(cfg, mesh=mesh), 5,
                           device="cuda")
        runs.append((cache, cache.run(trace), kernels.launch_counts()))
    (ref, rres, rn), (got, gres, gn) = runs
    _same_results(gres, rres)
    assert all(gn[k] == 4 * rn[k] for k in rn) and rn["two_level"] > 0, \
        (rn, gn)
    for v in range(5):
        _same(got.vm_ssd(v), ref.vm_ssd(v))
        _same(got.vm_dram(v), ref.vm_dram(v))


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


CLEAN_CASES = {  # v, s, w, dirty share, lru range, quota range
    "fused shape": (12, 64, 64, 0.5, 30_000, (0, 50)),
    "1024 VMs": (1024, 16, 32, 0.5, 2000, (0, 8)),
    "lru ties": (6, 24, 16, 0.8, 3, (1, 200)),
    "every slot dirty": (4, 32, 32, 1.0, 500, (0, 1500)),
    "extreme lru": (5, 16, 8, 0.6, None, (0, 60)),
    "one slot a VM": (7, 1, 1, 0.5, 10, (0, 2)),
}


@pytest.mark.parametrize("case", list(CLEAN_CASES))
def test_clean_select_kernel(dev, case):
    """The cleaner in one launch (its cutoffs found in the kernel) ==
    ``_clean_cutoffs`` + ``clean_scatter_plain`` on the CPU, all seven
    outputs: the sentinel where take is 0, ways 0 and all ways, quotas
    past the candidates; and the flush == the cutoff-form call at the
    cutoffs it found."""
    from repro_torch.core.simulator import CacheState
    from repro_torch.kernels.maintenance import ops
    v, s, w, share, lru_hi, (qlo, qhi) = CLEAN_CASES[case]
    rng = np.random.default_rng(v * s + w)
    dirty = rng.random((v, s, w)) < share
    if lru_hi is None:
        lru = rng.choice(np.array([-2**31, 2**31 - 1, -1, 0, 7], np.int32),
                         (v, s, w))
    else:
        lru = rng.integers(0, lru_hi, (v, s, w)).astype(np.int32)
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[0], ways[-1] = 0, w
    quota = rng.integers(qlo, qhi, v).astype(np.int32)
    quota[1 % v] = 0
    args = [torch.from_numpy(x).to(dev) for x in (dirty, lru, ways, quota)]
    got = ops.clean_select(*args)
    want = ops.clean_select(*[x.cpu() for x in args])
    _same([x.cpu() for x in got], want)
    assert int(got[2][1 % v]) == ops.INT32_MIN and int(got[3][1 % v]) == -1
    _same(ops.clean_scatter(*args[:3], got[2], got[3]), got[:2])
    state = CacheState(torch.zeros_like(args[1]), args[1], args[0])
    st, flushed, left = ops.clean(state, args[2], args[3])
    _same([st.dirty, flushed, left], [got[0], got[1], got[6]])


def test_clean_select_kernel_empty(dev):
    """V 0 and S*W 0: no launch, the sentinel cutoffs and zero counts."""
    from repro_torch.kernels.maintenance import ops
    for v, s, w in ((0, 4, 4), (3, 0, 4), (3, 4, 0)):
        args = [torch.zeros((v, s, w), dtype=torch.bool, device=dev),
                torch.zeros((v, s, w), dtype=torch.int32, device=dev),
                torch.full((v,), w, dtype=torch.int32, device=dev),
                torch.full((v,), 3, dtype=torch.int32, device=dev)]
        got = ops.clean_select(*args)
        want = ops.clean_select(*[x.cpu() for x in args])
        _same([x.cpu() for x in got], want)
        d, fl = ops.clean_scatter(*args[:3], got[2], got[3])
        assert d.shape == (v, s, w) and fl.tolist() == [0] * v


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


# (V, N, sets_d, ways_d, sets_s, ways_s, address space, one-set factor,
# padding): the set walk's cases (csrc/set_walk.cuh)
SET_WALK_CASES = {
    "v1_64x64": (1, 1000, 64, 64, 64, 64, 12000, 1, 0.1),   # -seq modes
    "v1_256x64": (1, 1000, 256, 64, 256, 64, 40000, 1, 0.0),  # FAST, L2ARC
    "two_tiles": (3, 9000, 8, 64, 8, 64, 2000, 1, 0.0),  # 8,192 + 808
    "one_set": (4, 800, 16, 32, 16, 32, 900, 16, 0.1),   # the worst chain
    "wide_rows": (3, 600, 8, 100, 6, 96, 3000, 1, 0.1),  # rows in memory
    "narrow_sets_differ": (5, 700, 32, 16, 12, 32, 1500, 1, 0.1),
}


def _walk_case(dev, rng, case):
    v, n, sd, wd, ss, ws, space, one_set, pad = SET_WALK_CASES[case]
    a = rng.integers(0, space, (v, n)).astype(np.int32) * one_set
    a[rng.random((v, n)) < pad] = -1
    w = rng.random((v, n)) < 0.35
    state = [torch.from_numpy(x).to(dev) for x in (*_state(rng, v, sd, wd),
                                                     *_state(rng, v, ss, ws))]
    ways = [torch.from_numpy(rng.integers(0, x + 3, v).astype(np.int32)).to(
        dev) for x in (wd, ws)]
    t0 = torch.from_numpy(rng.integers(0, 100, v).astype(np.int32)).to(dev)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev), state,
            ways, t0)


@pytest.mark.parametrize("case", list(SET_WALK_CASES))
@pytest.mark.parametrize("npe", [False, True])
def test_two_level_kernel_set_walk(dev, npe, case):
    from repro_torch.kernels.datapath import ops
    a, w, state, (wd, ws), t0 = _walk_case(dev, np.random.default_rng(5),
                                           case)
    _same(ops.two_level(a, w, *state, wd, ws, t0, npe=npe),
          ops.two_level_plain(a, w, *state, wd, ws, t0, npe=npe))


@pytest.mark.parametrize("case", list(SET_WALK_CASES))
def test_single_level_kernel_set_walk(dev, case):
    from repro_torch.core.policies import Policy
    from repro_torch.core.simulator import policy_flags
    from repro_torch.kernels.datapath import ops
    rng = np.random.default_rng(6)
    a, w, state, (ways, _), t0 = _walk_case(dev, rng, case)
    v = a.shape[0]
    flags = policy_flags([list(Policy)[(k + v) % 5] for k in range(v)], dev)
    _same(ops.single_level(a, w, *state[:3], ways, *flags, t0, t_cache=2e-5),
          ops.single_level_plain(a, w, *state[:3], ways, *flags, t0,
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


DECODE_CASES = [  # b, h, hkv, d, pool, ps, n_pages, lengths
    (5, 16, 4, 128, 40, 16, 6, [0, 1, 40, 96, 500]),
    (2, 4, 2, 64, 16, 32, 4, [45, 128]),        # tests/test_kernels.py
    (1, 2, 2, 32, 8, 64, 2, [70]),              # shapes: 2 tiles per page
    # split tables (tests/test_torch_decode_split.py's cases)
    (4, 8, 2, 128, 300, 16, 256, [4096, 1, 1, 1]),   # long row, rows of 1
    (3, 16, 4, 64, 100, 8, 80, [64, 65, 8]),         # page edge, one past
    (2, 4, 1, 128, 80, 16, 64, [20, 17]),            # later splits empty
    (2, 4, 4, 32, 40, 64, 12, [2000, 769]),          # past the table
    (3, 16, 1, 256, 50, 16, 48, [0, 700, -5]),       # length 0, G 16
    (2, 32, 2, 64, 80, 16, 40, [640, 33]),           # G 16, D 64
    (2, 32, 2, 128, 60, 16, 40, [600, 1]),           # G 16, D 128
    (2, 2, 2, 256, 30, 64, 20, [1280, 64]),          # G 1, D 256, PS 64
    (1, 8, 8, 128, 512, 16, 6, [96]),                # the serving shape
    (2, 4, 2, 36, 20, 16, 40, [300, 17]),            # rows off 16 bytes
    (1, 2, 1, 40, 10, 16, 20, [310])]                # 10 or 5 16-byte chunks


def _decode_args(dev, q_dtype, kv_dtype, b, h, hkv, d, pool, ps, n_pages,
                 lengths, seed=5):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(pool, ps, hkv, d)).astype(
        np.float32)) for _ in range(2))
    pt = torch.from_numpy(rng.integers(-pool - 2, pool + 2,
                                       (b, n_pages)).astype(np.int32))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [q.to(dev, q_dtype), kp.to(dev, kv_dtype), vp.to(dev, kv_dtype),
            pt.to(dev), lengths.to(dev)]


@pytest.mark.parametrize("b,h,hkv,d,pool,ps,n_pages,lengths", DECODE_CASES)
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_paged_decode_kernel(dev, q_dtype, kv_dtype, b, h, hkv, d, pool, ps,
                             n_pages, lengths):
    """Against the plain version: GQA, a random page table with ids past
    either end of the pool, a zero-length row, a row past its table's
    end, pages of more than one 32-token tile, and tables split across
    CTAs (a row of 4,096 tokens among rows of 1, lengths on a page edge
    and one past, splits wholly past a length, length 0 under a split;
    G 1, 4 and 16, D 64, 128 and 256, PS 8, 16 and 64). float32 outputs
    within 2e-5; bf16 outputs within one bf16 ulp (or 2e-5)."""
    from repro_torch.kernels.decode_attention import ops
    args = _decode_args(dev, q_dtype, kv_dtype, b, h, hkv, d, pool, ps,
                        n_pages, lengths)
    got = ops.paged_decode_attention(*args).float()
    want = ops.paged_decode_attention_plain(*args).float()
    err = (got - want).abs()
    if q_dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
            min=2**-126))) - 7)
        assert bool((err <= ulp.clamp(min=2e-5)).all())
    else:
        assert float(err.max()) <= 2e-5


@pytest.mark.parametrize("case", [3, 4, 7, 11])
def test_paged_decode_kernel_poisoned_tail_and_repeat(dev, case):
    """Every token past each row's length (in its last page and in the
    pages past it; none for a length <= 0, which reads every slot) set to
    999 leaves the output bit for bit the same; a
    second call gives the same bits (the merge runs in a fixed order)."""
    from repro_torch.kernels.decode_attention import ops
    b, h, hkv, d, pool, ps, n_pages, lengths = DECODE_CASES[case]
    pool = max(pool, b * n_pages)
    args = _decode_args(dev, torch.float32, torch.bfloat16, b, h, hkv, d,
                        pool, ps, n_pages, lengths)
    q, kp, vp, _, ln = args
    pt = torch.from_numpy(np.random.default_rng(1).permutation(pool)[
        :b * n_pages].reshape(b, n_pages).astype(np.int32)).to(dev)
    got = ops.paged_decode_attention(q, kp, vp, pt, ln)
    assert torch.equal(got, ops.paged_decode_attention(q, kp, vp, pt, ln))
    pos = torch.arange(n_pages * ps, device=dev).reshape(n_pages, ps)
    dead = (pos[None] >= ln.long()[:, None, None]) & (ln > 0)[:, None, None]
    kp2, vp2 = kp.clone(), vp.clone()
    for x in (kp2, vp2):
        x[pt.long()] = torch.where(dead[..., None, None], 999.0,
                                   x[pt.long()].float()).to(x.dtype)
    assert torch.equal(ops.paged_decode_attention(q, kp2, vp2, pt, ln), got)


def test_serving_card_equals_cpu(dev):
    """A small churn run through the batched manager with decode, and
    the host-dict oracle: card == CPU (Stats, placements, pools)."""
    from repro_torch import kernels
    from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
    from repro_torch.launch.serve import gaussian_pages, run_events
    from repro_torch.traces.generators import SessionSpec, generate_sessions
    cfg = TwoTierConfig(page_size=8, hbm_pages=24, num_kv_heads=2,
                        head_dim=16, dtype="bfloat16",
                        maintenance_interval=16, resize_interval=64,
                        pop_capacity=128, clean_quota=2)
    trace = generate_sessions(SessionSpec(num_tenants=3, target_live=48,
                                          max_pages=4, lifetime=20),
                              1500, seed=0)
    kb, vb = gaussian_pages(cfg, 8, 7)
    out = {}
    for batched in (True, False):
        for device in ("cuda", "cpu"):
            kernels.reset_launch_counts()
            mgr = TwoTierKVManager(cfg, 3, batched=batched, device=device)
            run_events(mgr, trace, kb, vb, decode_every=4)
            out[batched, device] = mgr
            if device == "cuda" and batched:
                n = kernels.launch_counts()
                assert all(n[k] > 0 for k in ("count_between", "run_sums",
                                              "paged_decode_attention")), n
    for batched in (True, False):
        card, cpu = out[batched, "cuda"], out[batched, "cpu"]
        assert card.stats == cpu.stats == out[True, "cpu"].stats
        assert card.slot_owner == cpu.slot_owner and card.free == cpu.free
        assert torch.equal(card.k_pool.cpu(), cpu.k_pool)


@pytest.mark.parametrize("v,n,nb_space", [
    (1, 1000, 300),         # one stream, as the Pallas signature
    (5, 333, 40),           # N not a multiple of 32
    (12, 1024, 500)])       # the staged path's shape
def test_popularity_kernel(dev, v, n, nb_space):
    """Against the plain version, bit for bit: per-VM cache sizes (one
    of them 0, clamped to 1), -1 padding, and a VM with no valid entry."""
    from repro_torch.kernels.popularity import ops
    rng = np.random.default_rng(6 + v)
    addr = rng.integers(0, nb_space, (v, n)).astype(np.int32)
    addr[rng.random((v, n)) < 0.1] = -1
    addr[:, n - 17:] = -1
    if v > 1:
        addr[1] = -1
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = np.array([0, 1, 64, 512, 4096, 7, 100, 3, 9, 33, 64, 80][:v],
                  np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (addr, dist, served, cs)]
    got = ops.block_popularity_batch(*args)
    want = ops.block_popularity_batch(*[x.cpu() for x in args])
    assert len(got) == len(want) == v
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g[0], w[0])
            assert np.array_equal(g[1].view(np.int32), w[1].view(np.int32))
    if v > 1:
        assert got[1] is None
    seg = torch.from_numpy(rng.integers(0, 97, n).astype(np.int32)).to(dev)
    _same([ops.popularity(args[1][0], args[2][0], seg, 97, 64.0).cpu()],
          [ops.popularity(*(x.cpu() for x in (args[1][0], args[2][0], seg)),
                          97, 64.0)])


@pytest.mark.parametrize("v,n,hi,longest", [
    (12, 1024, 300, 1024),     # the paper's 12-VM window
    (1024, 256, 40, 256),      # fig15 1024-VM's fused window
    (8, 12800, 30, 60),        # fig15 1024-VM's block width, mostly padding
    (3, 16384, 64, 16384)])    # the shared-memory row limit
def test_run_sums_kernel(dev, v, n, hi, longest):
    """The window compaction against its plain version, bit for bit:
    the worst chain (one address for a whole row), an all-padding row,
    random valid lengths, negative and extreme addresses."""
    from repro_torch.core import popularity as pop
    rng = np.random.default_rng(n)
    wa = rng.integers(0, hi, (v, n)).astype(np.int32)
    wa[0] = 5
    wa[2, ::7] = pop.TABLE_EMPTY - 1
    wa[2, 1::7] = -3
    nv = rng.integers(0, longest + 1, v).astype(np.int32)
    nv[0], nv[1] = longest, 0
    wc = rng.random((v, n)).astype(np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (wa, wc, nv)]
    got = pop.window_runs(*args)
    _same([x.cpu() for x in got],
          pop.window_runs_plain(*[x.cpu() for x in args]))


@pytest.mark.parametrize("v,n", [(64, 12800), (2, 16384)])
def test_popularity_kernel_wide_rows(dev, v, n):
    """``popularity`` on fig15 1024-VM's block width (60 accesses a row,
    the rest padding) and at the row limit, one segment for all of row
    0's accesses, against its plain version."""
    from repro_torch.kernels.popularity import ops
    rng = np.random.default_rng(v)
    per = 40
    kept = 60 if n < 16384 else n
    seg = (rng.integers(0, per, (v, n))
           + per * np.arange(v)[:, None]).astype(np.int32)
    seg[:, kept:] = v * per
    seg[0, :kept] = 0
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = rng.integers(1, 4096, v).astype(np.float32)
    args = [torch.from_numpy(x) for x in (dist, served, seg)]
    want = ops.popularity_rows_plain(*args, v * per, torch.from_numpy(cs))
    got = ops.popularity_rows(*[x.to(dev) for x in args], v * per,
                              torch.from_numpy(cs).to(dev))
    _same([got.cpu()], [want])


@pytest.mark.parametrize("v,n", [(5, 16_385), (5, 40_000), (5, 65_536),
                                 (12, 32_768)])
def test_row_kernels_wide_rows_equal_plain(dev, v, n):
    """Rows past ``ROW_MAX`` take the tiled route (a radix sort of each
    row across the card, ``csrc/row_radix.cuh``) and equal the plain
    versions bit for bit: heavy ties, one key for a whole row, an empty
    row, runs across every multiple of ``ROW_MAX``, random valid lengths;
    at [12, 32768] seven more rows of the paper's address ranges (a VM's
    addresses from ``VM * 10,000,000``) and valid lengths of 20,000 or
    random."""
    from repro_torch import kernels
    from repro_torch.core import popularity as pop
    from repro_torch.kernels.popularity import ops
    rng = np.random.default_rng(n + v)
    wa = rng.integers(0, 48, (v, n)).astype(np.int32)      # heavy ties
    wa[1] = 7                                  # one key for a whole row
    edges = np.arange(kernels.ROW_MAX, n, kernels.ROW_MAX)
    for e in edges:                            # runs across ROW_MAX
        wa[3, e - 40:e + 40] = 1000 + e
    wa[4, ::5] = pop.TABLE_EMPTY
    nv = np.array([n, n, 0, n, rng.integers(kernels.ROW_MAX, n)]
                  + [20_000] * (v - 5), np.int32)
    for r in range(5, v):
        wa[r] = r * 10_000_000 + rng.integers(0, 4000 * r, n)
    nv[5::2] = rng.integers(0, n, len(nv[5::2]))
    wc = rng.random((v, n)).astype(np.float32)
    wc[0, ::9] = 1e-39                         # subnormal: adds as zero
    args = [torch.from_numpy(x).to(dev) for x in (wa, wc, nv)]
    kernels.reset_launch_counts()
    got = pop.window_runs(*args)
    assert kernels.route_counts("run_sums") == {"row": 0, "tiled": 1}
    _same([x.cpu() for x in got],
          pop.window_runs_plain(*[x.cpu() for x in args]))
    # a segment a (row, address), row 2 all padding
    key = np.arange(v)[:, None] * 2**31 + wa.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    nb = int(uniq.size)
    seg = inv.reshape(v, n).astype(np.int32)
    seg[2] = nb
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = rng.integers(1, 4096, v).astype(np.float32)
    pargs = [torch.from_numpy(x) for x in (dist, served, seg)]
    want = ops.popularity_rows_plain(*pargs, nb, torch.from_numpy(cs))
    got = ops.popularity_rows(*[x.to(dev) for x in pargs], nb,
                              torch.from_numpy(cs).to(dev))
    assert kernels.route_counts("popularity") == {"row": 0, "tiled": 1}
    _same([got.cpu()], [want])


PROMOTE_CASES = {  # v, s, w, fill, q
    "repeats": (6, 16, 8, 0.3, 256),
    "wider than a tile": (3, 16, 8, 0.3, 4096 + 700),
    "L2ARC's shape": (1, 256, 64, 0.9, 512),
    "W 128": (4, 8, 128, 0.5, 1000),
    "fused shape": (12, 64, 64, 0.75, 4096),
    "more VMs than SMs": (200, 16, 32, 0.75, 512),   # CTAs of 4 warps
}


@pytest.mark.parametrize("case", list(PROMOTE_CASES))
def test_promote_scatter_dedupe_kernel(dev, case):
    """Queues with repeated addresses (across and inside 32-entry
    batches, and across the edge of the kernel's 4,096-entry queue tile)
    against the plain version, with and without the dedupe; V 1 at
    256 x 64 (L2ARC's shape), W 128, ways 0 and W, more VMs than SMs."""
    from repro_torch.kernels.maintenance import ops
    rng = np.random.default_rng(7)
    v, s, w, fill, qn = PROMOTE_CASES[case]
    space = 20 if case == "repeats" else 4 * w
    tags = np.where(rng.random((v, s, w)) < fill,
                    rng.integers(0, space, (v, s, w)) * s
                    + np.arange(s)[:, None], -1).astype(np.int32)
    if case != "repeats":      # a set holds an address once
        for i in range(v):
            for j in range(s):
                row = tags[i, j]
                dup = np.ones(w, bool)
                dup[np.unique(row, return_index=True)[1]] = False
                row[dup] = -1
    lru = rng.integers(0, 99, (v, s, w)).astype(np.int32)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    st = [torch.from_numpy(x).to(dev) for x in (tags, lru, dirty)]
    q = rng.integers(0, space * s, (v, qn)).astype(np.int32)
    q[:, 1::2] = q[:, ::2][:, :qn // 2]        # adjacent lanes repeat
    q[:, 200:] = np.resize(q[:, :56], (v, qn - 200))  # later batches repeat
    if qn > 4096:
        q[:, 4090:4110] = q[:, 4080:4100]      # repeats across the tile edge
    q[rng.random((v, qn)) < 0.1] = -1
    q = torch.from_numpy(q).to(dev)
    if case == "repeats":
        ways = np.array([0, 3, 8, 8, 5, 1], np.int32)
    else:
        ways = rng.integers(0, w + 1, v).astype(np.int32)
        ways[:2] = (w, 0) if v > 1 else (w,)
    ways = torch.from_numpy(ways).to(dev)
    t = torch.arange(v, dtype=torch.int32, device=dev) + 10
    for dedupe in (True, False):
        _same(ops.promote_scatter(*st, q, ways, t, dedupe=dedupe),
              ops.promote_scatter_plain(*st, q, ways, t, dedupe=dedupe))


@pytest.mark.parametrize("clean_quota", [0, 3])
def test_oracle_modes_card_equal_fused(dev, clean_quota):
    """Staged and sequential controllers on the card == the fused card
    run (stats, histories, final states), each through its own kernels."""
    from repro_torch import kernels
    from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
    from repro_torch.core.trace import interleave
    from repro_torch.traces.generators import make
    trace = interleave([make(n, 1200, seed=i, addr_offset=i * 10_000_000,
                             scale=0.25) for i, n in
                        enumerate(["hm_1", "usr_0", "web_3"])], seed=0)
    geo = Geometry(8, 16)
    out = {}
    for name, kw in (("fused", {}), ("staged", dict(fused_maintenance=False)),
                     ("sequential", dict(batched=False))):
        cfg = EticaConfig(dram_capacity=60, ssd_capacity=120,
                          geometry_dram=geo, geometry_ssd=geo,
                          resize_interval=600, promo_interval=200,
                          clean_quota=clean_quota, **kw)
        kernels.reset_launch_counts()
        cache = EticaCache(cfg, 3, device="cuda")
        out[name] = cache, cache.run(trace), kernels.launch_counts()
    fused, fres, _ = out["fused"]
    clean = ("clean_scatter",) if clean_quota else ()
    own = {"fused": ETICA_KERNELS + clean,
           "staged": ("count_between", "two_level", "evict_scatter",
                      "promote_scatter", "popularity") + clean,
           "sequential": ("count_between", "two_level")}
    for name, (cache, res, n) in out.items():
        assert {k for k, c in n.items() if c} == set(own[name]), (name, n)
        _same_results(res, fres)
        for v in range(3):
            _same(cache.vm_ssd(v), fused.vm_ssd(v))
            _same(cache.vm_dram(v), fused.vm_dram(v))


def _bf16_err_ok(got, want):
    """float32 within 2e-5; bf16 within one bf16 ulp (or 2e-5)."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(
            min=2**-126))) - 7)
        return bool((err <= ulp.clamp(min=2e-5)).all())
    return float(err.max()) <= 2e-5


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,q_offset", [
    (1, 2, 1, 128, 128, 32, True, 0, 0),       # tests/test_kernels.py
    (2, 4, 2, 256, 256, 64, True, 0, 0),
    (1, 8, 8, 128, 128, 128, True, 0, 0),
    (1, 2, 2, 256, 256, 64, True, 64, 0),      # sliding window
    (1, 2, 1, 128, 128, 64, False, 0, 0),      # non-causal GQA
    (1, 4, 2, 64, 192, 64, False, 0, 0),       # Sq != Skv
    (2, 4, 2, 100, 100, 16, True, 0, 0),       # ragged 64-row tiles
    (1, 4, 2, 128, 128, 16, True, 0, 0),       # serve's reduced bank prefill
    (1, 4, 1, 64, 192, 128, True, 0, 128),     # cached continuation
    (1, 2, 1, 64, 64, 32, False, 8, 200)])     # rows that keep no key
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, b, h, hkv, sq, skv, d, causal, window,
                                q_offset, dtype):
    """Against the plain version, on [B, H, S, D] tensors and on the
    model's [B, S, H, D] layout passed as transposed views."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(sq + d)
    q = torch.from_numpy(rng.normal(size=(b, h, sq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, skv, d)).astype(
        np.float32)) for _ in range(2))
    args = [x.to(dev, dtype) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              tk=64 if skv % 64 == 0 else skv)
    kernels.reset_launch_counts()
    got = ops.flash_attention(*args, tq=sq, **kw)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert ops.route_counts()[ops.route(dtype, d)] == 1
    assert _bf16_err_ok(got, ops.flash_attention_plain(*args, **kw))
    bshd = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in args]
    got2 = ops.flash_attention(*bshd, tq=sq, **kw)
    assert got2.stride() == bshd[0].stride()
    assert torch.equal(got2, got)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,q_offset", [
    (1, 2, 2, 77, 77, 16, True, 0, 0),         # G 1, one ragged q tile
    (2, 8, 2, 200, 200, 32, True, 0, 0),       # G 4
    (1, 8, 1, 333, 333, 64, True, 0, 0),       # G 8, ragged KV tile
    (1, 8, 1, 300, 300, 128, True, 0, 0),
    (1, 4, 1, 72, 200, 128, True, 0, 128),     # q_offset: cached prefix
    (1, 8, 2, 330, 330, 64, True, 100, 0),     # window across tiles
    (2, 4, 4, 150, 150, 96, False, 40, 0),     # non-causal window
    (1, 8, 2, 70, 90, 32, False, 8, 200),      # rows that keep no key
    (1, 4, 1, 140, 140, 16, True, 24, 60)])    # window, offset, G 4
def test_flash_attention_wgmma_route(dev, b, h, hkv, sq, skv, d, causal,
                                     window, q_offset):
    """bf16 with D a multiple of 16 takes the tensor-core route at
    ragged lengths, every GQA grouping, offsets, windows and rows that
    keep no key, within one bf16 ulp of the plain version, on [B, H, S,
    D] tensors and on the model's layout."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(sq * d + skv)
    q = torch.from_numpy(rng.normal(size=(b, h, sq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, skv, d)).astype(
        np.float32)) for _ in range(2))
    args = [x.to(dev, torch.bfloat16) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset, tk=skv)
    kernels.reset_launch_counts()
    got = ops.flash_attention(*args, tq=sq, **kw)
    bshd = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in args]
    got2 = ops.flash_attention(*bshd, tq=sq, **kw)
    assert kernels.launch_counts()["flash_attention"] == 2
    assert ops.route_counts() == {"wgmma": 2, "cuda_cores": 0}
    assert _bf16_err_ok(got, ops.flash_attention_plain(*args, **kw))
    assert torch.equal(got2, got)


def test_flash_attention_routes_and_refusals(dev):
    """float32 and a bf16 head dim that is no multiple of 16 take the
    first version; a bf16 operand TMA cannot read raises (no fallback)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(7)

    def operands(d, dtype, pad=0):
        return [torch.from_numpy(rng.normal(size=(1, 2, 128, d + pad)).astype(
            np.float32)).to(dev, dtype)[..., :d] for _ in range(3)]
    kernels.reset_launch_counts()
    for d, dtype in ((64, torch.float32), (40, torch.bfloat16)):
        args = operands(d, dtype)
        got = ops.flash_attention(*args, causal=True, tq=128, tk=128)
        assert _bf16_err_ok(got, ops.flash_attention_plain(*args, tk=128))
    assert ops.route_counts() == {"wgmma": 0, "cuda_cores": 2}
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(*operands(64, torch.bfloat16, pad=1),
                            causal=True, tq=128, tk=128)
    assert kernels.launch_counts()["flash_attention"] == 2


def test_model_card_equals_cpu(dev):
    """Reduced qwen3-4b, one weight set on both devices: prefill (the
    flash kernel, one launch per layer) and two decode steps; logits
    within 1e-2 of their scale, and greedy tokens equal wherever the
    CPU's top-2 margin exceeds 1e-2 of it."""
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    cfg = configs.get_reduced("qwen3-4b")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = M.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu").to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 66),
                         generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    lc, cc = M.prefill(card, cfg, {"tokens": toks[:, :64].to(dev)}, 66)
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    lp, cp = M.prefill(cpu, cfg, {"tokens": toks[:, :64]}, 66)
    outs = [(lc, lp)]
    for i in range(2):
        nxt = toks[:, 64 + i:65 + i]
        lc, cc = M.decode_step(card, cfg, nxt.to(dev), cc, 64 + i)
        lp, cp = M.decode_step(cpu, cfg, nxt, cp, 64 + i)
        outs.append((lc, lp))
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    for got, want in outs:
        assert bool(torch.isfinite(got).all())
        scale = want.abs().max()
        err = float((got.cpu() - want).abs().max() / scale)
        assert err < 1e-2, err
        top2 = want[:, -1].topk(2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > 1e-2 * scale
        assert torch.equal(got[:, -1].argmax(-1).cpu()[sure],
                           want[:, -1].argmax(-1)[sure])


@pytest.mark.parametrize("b,h,hkv,sq,skv,d", [
    (2, 16, 16, 64, 256, 64),        # cross attention: Sq 64, Skv 256
    (2, 4, 4, 64, 16, 64),           # Skv 16 < one 128-key tile
    (2, 16, 16, 512, 512, 64),       # seamless's encoder: Hkv == H, D 64
    (1, 8, 2, 100, 384, 128)])       # cross with GQA, ragged Sq
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_model_paths(dev, b, h, hkv, sq, skv, d, dtype):
    """The encoder's and the cross attention's non-causal shapes
    (``chip_smoke.py`` phase 2), against the plain version: float32
    within 2e-5, bf16 (the ``wgmma`` route) within one bf16 ulp or
    2e-5."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(sq + skv + d)
    q = torch.from_numpy(rng.normal(size=(b, h, sq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, skv, d)).astype(
        np.float32)) for _ in range(2))
    args = [x.to(dev, dtype) for x in (q, k, v)]
    kw = dict(causal=False, tk=min(64, skv))
    kernels.reset_launch_counts()
    got = ops.flash_attention(*args, tq=sq, **kw)
    assert ops.route_counts()[ops.route(dtype, d)] == 1
    assert _bf16_err_ok(got, ops.flash_attention_plain(*args, **kw))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b",
                                  "mamba2-370m", "jamba-v0.1-52b",
                                  "internvl2-26b", "seamless-m4t-large-v2"])
def test_family_card_equals_cpu(dev, arch, monkeypatch):
    """Each new family's reduced config, one weight set on both devices:
    prefill (enc-dec with frames, vision with patches) and two decode
    steps; logits within 1e-2 of their scale; one ``flash_attention``
    launch per attention layer (and per encoder layer and cross
    attention), none in decode. With MoE layers the card takes the CPU
    run's expert choices (its router still runs): a token whose top-k
    margin is below the two devices' rounding differences may route to
    other experts, a discontinuity no tolerance bounds (reduced
    deepseek has a margin of 8.7e-6 here); the card's router on the
    CPU's inputs picks the CPU's experts past a 1e-6 margin."""
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = configs.get_reduced(arch)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = M.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu").to(dev)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 66), generator=gen)
    batch, off = {"tokens": toks[:, :64]}, 0
    if cfg.is_encdec:
        batch = {"dec_tokens": toks[:, :64],
                 "frames": torch.randn(2, 48, cfg.d_model, generator=gen)}
    if cfg.frontend == "vision":
        off = cfg.frontend_tokens
        batch["patches"] = torch.randn(2, off, cfg.d_model, generator=gen)
    attn = sum(s.kind == "attn" for s in cfg.layer_pattern()) \
        * cfg.num_superlayers + (1 if cfg.first_dense_ff else 0) \
        + (cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0)
    route, calls = moe.route, []

    def record(p, c, xf):
        out = route(p, c, xf)
        calls.append((p, xf, out))
        return out

    def run(model, b, d):
        logits, cache = M.prefill(model, cfg, b, off + 66)
        outs = [logits.cpu()]
        for i in range(2):
            logits, cache = M.decode_step(model, cfg,
                                          toks[:, 64 + i:65 + i].to(d),
                                          cache, off + 64 + i)
            outs.append(logits.cpu())
        return outs
    monkeypatch.setattr(moe, "route", record)
    want = run(cpu, batch, "cpu")
    replay = iter(calls)

    def held(p, c, xf):
        probs, _, _ = route(p, c, xf)
        _, _, (_, gate, idx) = next(replay)
        return probs, gate.to(xf.device), idx.to(xf.device)
    monkeypatch.setattr(moe, "route", held)
    kernels.reset_launch_counts()
    got = run(card, {k: v.to(dev) for k, v in batch.items()}, dev)
    assert kernels.launch_counts()["flash_attention"] == attn
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        err = float((g - w).abs().max() / w.abs().max())
        assert err < 1e-2, err
    to_card = dict(zip(map(id, cpu.modules()), card.modules()))
    for p, xf, (probs, _, idx) in calls:
        top = probs.sort(-1, descending=True).values
        sure = top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k] > 1e-6
        _, _, mine = route(to_card[id(p)], cfg, xf.to(dev))
        assert torch.equal(mine.cpu()[sure], idx[sure])


def test_moe_prefill_is_deterministic(dev):
    """Reduced deepseek prefilled twice on the card gives bit-identical
    logits: the MoE combine adds each token's pairs in one fixed order,
    with no atomics."""
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_reduced("deepseek-moe-16b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").to(dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 96),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    a, _ = M.prefill(model, cfg, {"tokens": toks})
    b, _ = M.prefill(model, cfg, {"tokens": toks})
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the per-state maintenance ops, mrc and fig10 (the paper's figures' API)
# ---------------------------------------------------------------------------

def _random_one(rng, s, w):
    tags = np.where(rng.random((s, w)) < 0.3, -1,
                    rng.integers(0, 4 * s * w, (s, w))).astype(np.int32)
    lru = np.where(tags >= 0, rng.integers(0, 64, (s, w)), -1).astype(
        np.int32)
    dirty = (tags >= 0) & (rng.random((s, w)) < 0.4)
    return tags, lru, dirty


@pytest.mark.parametrize("s,w", [(64, 64), (16, 32), (3, 5)])
def test_state_ops_card_equal_plain(dev, s, w):
    """Per-state ``resize`` and ``clean_blocks`` (one ``clean_scatter``
    launch) on the card == on the CPU == the numpy oracles."""
    from repro_torch import kernels
    from repro_torch.core.simulator import (CacheState, clean_blocks,
                                            clean_blocks_ref, resize,
                                            resize_ref)
    rng = np.random.default_rng(s * w)
    for trial in range(4):
        arrays = _random_one(rng, s, w)
        card = CacheState(*(torch.from_numpy(x).to(dev) for x in arrays))
        cpu = CacheState(*(torch.from_numpy(x.copy()) for x in arrays))
        old, new = (int(x) for x in rng.integers(0, w + 1, 2))
        got, fl = resize(card, old, new)
        want, wfl = resize(cpu, old, new)
        ref, rfl = resize_ref(cpu, old, new)
        assert int(fl) == int(wfl) == rfl
        _same([x.cpu() for x in got], list(want))
        _same(list(want), list(ref))
        ways = w if trial % 2 else int(rng.integers(0, w + 1))
        n_dirty = int(arrays[2][:, :ways].sum())
        for quota in (0, int(rng.integers(1, n_dirty + 2)), n_dirty + 3):
            kernels.reset_launch_counts()
            got, fl, left = clean_blocks(card, ways, quota)
            assert kernels.launch_counts()["clean_scatter"] == 1
            want, wfl, wleft = clean_blocks(cpu, ways, quota)
            ref, rfl, rleft = clean_blocks_ref(cpu, ways, quota)
            assert (int(fl), int(left)) == (int(wfl), int(wleft)) == \
                (rfl, rleft)
            _same([x.cpu() for x in got], list(want))
            _same(list(want), list(ref))


def test_mrc_and_sizing_card_equal_cpu(dev):
    """``pod``/``urd``/``trd`` and ``mrc`` (one ``count_between`` launch
    each) on the card == on the CPU."""
    from repro_torch import kernels
    from repro_torch.core import Policy, mrc, pod, trd, urd
    from repro_torch.traces import make
    sizes = np.arange(0, 600, 25)
    for i, name in enumerate(("hm_1", "web_3", "usr_0", "varmail")):
        tr = make(name, 1_000 + 700 * i, seed=i, scale=0.25)
        for p in Policy:
            kernels.reset_launch_counts()
            got = mrc(tr, p, sizes, "cuda")
            assert kernels.launch_counts()["count_between"] == 1
            assert np.array_equal(got, mrc(tr, p, sizes, "cpu"))
            assert pod(tr, p, "cuda") == pod(tr, p, "cpu")
        assert urd(tr, "cuda") == urd(tr, "cpu")
        assert trd(tr, "cuda") == trd(tr, "cpu")


def test_fig10_card_equals_cpu(dev):
    """fig10/11 at the tests' reduced size: card == CPU, every interval's
    demand and the reduction."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_figures import figures, strip_seconds
    f = figures()
    assert strip_seconds(f.fig10("cuda", **f.SMOKE["fig10"])) == \
        strip_seconds(f.fig10("cpu", **f.SMOKE["fig10"]))


# (V, N, sets_d, ways_d, sets_s, ways_s, classes, bypass share, empty
# ranges): the classified routes' cases (csrc/datapath.cu,
# csrc/single_level.cu, the IO classifier); "one_set" moves every
# request into set 0 of both levels
CLASSIFIED_CASES = {
    "v0": (0, 300, 16, 32, 16, 32, 4, 0.25, False),
    "n0": (3, 0, 16, 32, 16, 32, 4, 0.25, False),
    "c1": (4, 700, 16, 32, 16, 32, 1, 0.0, False),
    "c16": (5, 900, 16, 32, 16, 32, 16, 0.25, False),
    "all_bypassed": (3, 600, 16, 32, 16, 32, 3, 1.0, False),
    "ranges_empty": (3, 600, 16, 32, 16, 32, 4, 0.0, True),
    "split_12x64x64": (12, 1000, 64, 64, 64, 64, 4, 0.25, False),
    "split_v1": (1, 1000, 64, 64, 64, 64, 4, 0.25, False),
    "two_tiles": (3, 9000, 8, 64, 8, 64, 4, 0.25, False),
    "wide_rows": (3, 600, 8, 128, 8, 128, 4, 0.25, False),
    "sets_differ": (5, 700, 32, 16, 12, 32, 4, 0.25, False),
    "c256": (3, 2000, 64, 32, 64, 32, 256, 0.25, False),
    "one_set": (12, 1000, 64, 64, 64, 64, 4, 0.25, False),
}


def _classified_case(dev, rng, case):
    """A block, states, ways, clocks and class tables for one case: class
    ids outside [0, C) included, one exclusive slice per level."""
    v, n, sd, wd, ss, ws, c, byp_share, empty = CLASSIFIED_CASES[case]
    a = rng.integers(0, 3 * sd * max(wd, ws), (v, n)).astype(np.int32)
    if case == "one_set":
        a *= np.lcm(sd, ss)
    a[rng.random((v, n)) < 0.1] = -1
    w = rng.random((v, n)) < 0.35
    cls = rng.integers(-1, c + 1, (v, n)).astype(np.int32)
    state = [torch.from_numpy(x).to(dev) for x in (*_state(rng, v, sd, wd),
                                                     *_state(rng, v, ss, ws))]
    ways = [rng.integers(0, x + 1, v).astype(np.int32) for x in (wd, ws)]
    bounds = []
    for x, wmax in zip(ways, (wd, ws)):
        lo = rng.integers(0, wmax + 1, (v, c)).astype(np.int32)
        hi = (lo + rng.integers(0, wmax // 2 + 1, (v, c))).astype(np.int32)
        if empty:
            hi = lo.copy()
        bounds += [lo, hi]
    bypass = rng.random(c) < byp_share
    if byp_share == 1.0:
        bypass[:] = True
    t0 = rng.integers(0, 100, v).astype(np.int32)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (put(a), put(w), put(cls), state, [put(x) for x in ways], put(t0),
            put(bypass), [put(x) for x in bounds])


@pytest.mark.parametrize("case", list(CLASSIFIED_CASES))
@pytest.mark.parametrize("npe", [False, True])
def test_two_level_classified_kernel(dev, npe, case):
    from repro_torch import kernels
    from repro_torch.kernels.datapath import ops
    a, w, cls, state, (wd, ws), t0, byp, bounds = _classified_case(
        dev, np.random.default_rng(7), case)
    kernels.reset_launch_counts()
    got = ops.two_level_classified(a, w, cls, *state, wd, ws, t0, byp,
                                   *bounds, npe=npe)
    assert kernels.route_counts("two_level") == {
        "unclassified": 0, "classified": int(a.shape[0] > 0)}
    cpu = lambda xs: [x.cpu() for x in xs]
    want = ops.two_level_classified_plain(
        *cpu((a, w, cls, *state, wd, ws, t0, byp, *bounds)), npe=npe)
    _same(cpu(got), want)
    # a second launch: the split route's kept tickets are back at 0
    _same(cpu(ops.two_level_classified(a, w, cls, *state, wd, ws, t0, byp,
                                       *bounds, npe=npe)), want)


@pytest.mark.parametrize("case", list(CLASSIFIED_CASES))
def test_single_level_classified_kernel(dev, case):
    from repro_torch import kernels
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.datapath import ops
    rng = np.random.default_rng(8)
    a, w, cls, state, (ways, _), t0, byp, bounds = _classified_case(
        dev, rng, case)
    v, c = bounds[0].shape
    pols = rng.integers(0, 5, (v, c))
    flags = [torch.from_numpy(np.asarray(
        [[getattr(list(Policy)[p], f) for p in row] for row in pols],
        bool).reshape(v, c)).to(dev)
        for f in ("allocates_reads", "write_invalidates", "holds_dirty",
                  "write_through")]
    kernels.reset_launch_counts()
    got = ops.single_level_classified(a, w, cls, *state[:3], ways, *flags,
                                      t0, byp, *bounds[:2], t_cache=2e-5)
    assert kernels.route_counts("single_level") == {
        "unclassified": 0, "classified": int(v > 0)}
    cpu = lambda xs: [x.cpu() for x in xs]
    want = ops.single_level_classified_plain(
        *cpu((a, w, cls, *state[:3], ways, *flags, t0, byp, *bounds[:2])),
        t_cache=2e-5)
    _same(cpu(got), want)
    _same(cpu(ops.single_level_classified(a, w, cls, *state[:3], ways,
                                          *flags, t0, byp, *bounds[:2],
                                          t_cache=2e-5)), want)


def test_classified_key_room():
    """The classified walks' keys hold the set above the class id and its
    flags: the most sets a level takes, by route and class count."""
    from repro_torch.kernels.datapath import ops
    assert ops.max_classified_sets("two_level", 1) == 2**28
    assert ops.max_classified_sets("two_level", 4) == 2**26
    assert ops.max_classified_sets("two_level", 256) == 2**20
    assert ops.max_classified_sets("single_level", 5) == 2**22
    assert ops.max_classified_sets("single_level", 256) == 2**17


def test_sharded_dispatches_default_t0(dev):
    """``simulate_two_level_sharded`` and ``simulate_single_level_sharded``
    with the default ``t0=0`` (a scalar, broadcast to ``[V]`` a shard by
    ``simulator._vec``) on a 2-shard mesh of the card == the unsharded
    dispatches with ``t0=0``."""
    from repro_torch.core import simulator as S
    from repro_torch.core.policies import Policy
    from repro_torch.launch.mesh import VMMesh
    rng = np.random.default_rng(12)
    v, n, s, w = 6, 500, 16, 32
    a = rng.integers(0, 6 * s * w, (v, n)).astype(np.int32)
    a[rng.random((v, n)) < 0.1] = -1
    wr = rng.random((v, n)) < 0.35
    st = lambda: S.CacheState(*(torch.from_numpy(x).to(dev)
                                for x in _state(rng, v, s, w)))
    dram, ssd = st(), st()
    wd, ws = (rng.integers(0, w + 1, v).astype(np.int32) for _ in range(2))
    mesh = VMMesh((torch.device("cuda", 0),) * 2)
    at, wt_ = torch.from_numpy(a).to(dev), torch.from_numpy(wr).to(dev)
    for mode in ("full", "npe"):
        want = S.simulate_two_level_batch(at, wt_, dram, ssd, wd, ws, mode)
        got = S.simulate_two_level_sharded(at, wt_, dram, ssd, wd, ws, mesh,
                                           mode)
        _same_outputs(got, want)
    flags = S.policy_flags([list(Policy)[k % 5] for k in range(v)], dev)
    want = S.simulate_single_level_batch(at, wt_, ssd, wd, flags)
    got = S.simulate_single_level_sharded(at, wt_, ssd, wd, flags, mesh)
    _same_outputs(got, want)


def _same_outputs(sharded, whole):
    """Sharded outputs (one list an output, one entry a shard) == the
    unsharded dispatch's, rows gathered in shard order."""
    from repro_torch.core import simulator as S
    for got, want in zip(sharded, whole):
        g = S.gather_rows(got)
        if isinstance(want, tuple):
            _same([x.cpu() for x in g], [x.cpu() for x in want])
        else:
            _same([g.cpu()], [want.cpu()])


def test_classify_block_card_equals_cpu(dev):
    """``classify_block`` on the card == on the CPU, carries included,
    for the four-class classifier and a seq cutoff."""
    from repro_torch.classify import (ClassRule, IOClass, classify_block,
                                      seq_cutoff)
    from repro_torch.core.policies import Policy
    rng = np.random.default_rng(9)
    four = [IOClass("default"),
            IOClass("small_writes", rules=(ClassRule(size=(None, 2),
                                                     direction="write"),),
                    ways_frac=0.25, policy=Policy.WT),
            IOClass("vm0_range", rules=(ClassRule(lba=(0, 10_000_000)),),
                    weight=0.5),
            IOClass("seq_bypass", rules=(ClassRule(run_len=(48, None)),),
                    bypass=True)]
    from repro_torch.classify import Classifier
    for clf in (Classifier(four), seq_cutoff(16)):
        v, n = 7, 3000
        a = rng.integers(0, 20_000_000, (v, n)).astype(np.int32)
        a[:, 100:700] = np.arange(600) * 2 + 5_000
        size = rng.integers(1, 4, (v, n)).astype(np.int32)
        size[:, 100:700] = 2
        wr = rng.random((v, n)) < 0.4
        nv = rng.integers(0, n + 1, v).astype(np.int32)
        ce = rng.integers(-1, 6000, v).astype(np.int32)
        cl = rng.integers(0, 60, v).astype(np.int32)
        args = (a, wr, size, nv, ce, cl, clf.plan)
        got = classify_block(*args, device=dev)
        want = classify_block(*args, device="cpu")
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,q_offset", [
    (2, 8, 2, 256, 256, 128, True, 0, 0),      # the model's case, G 4
    (1, 4, 4, 100, 100, 64, True, 0, 0),       # ragged tiles, G 1
    (1, 8, 2, 330, 330, 64, True, 100, 0),     # window across tiles
    (1, 8, 2, 100, 384, 128, False, 0, 0),     # non-causal, Sq != Skv
    (1, 4, 2, 70, 200, 48, True, 0, 130),      # q_offset, D 48
    (1, 2, 1, 16, 48, 8, True, 4, 60),         # rows that keep no key
    (1, 4, 2, 100, 96, 16, True, 16, 60),      # D 16: rows 51.. keep none
    (1, 4, 2, 100, 96, 64, True, 16, 60)])     # D 64: the same rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(dev, b, h, hkv, sq, skv, d, causal,
                                    window, q_offset, dtype):
    """The backward kernel against its plain version (float32 within
    1e-4 of each gradient's scale, bf16 within 2e-2) on the model's
    layout: one launch on the route of its dtype and head dim (``wgmma``
    for bf16 with D % 16 == 0, else ``cuda_cores``), q, k and v's
    layouts and dtypes, the same bits twice (no atomics), and the same
    bits given the forward's row statistics as without them."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(sq * d + skv)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype).transpose(1, 2)
    q, k, v = rnd(b, sq, h, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, stats = ops.flash_attention(q, k, v, tq=sq, tk=skv,
                                     return_stats=True, **kw)
    route = "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 \
        else "cuda_cores"
    assert (stats is not None) == (route == "wgmma")
    do = rnd(b, sq, h, d)
    kernels.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, do, **kw)
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert kernels.route_counts("flash_attention_bwd")[route] == 1
    want = ops.flash_attention_bwd_plain(q, k, v, out, do, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.stride() == x.stride()
        assert float((g.float() - w.float()).abs().max()) <= \
            tol * float(w.float().abs().max())
    again = ops.flash_attention_bwd(q, k, v, out, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    given = ops.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, given))
    assert kernels.route_counts("flash_attention_bwd")[route] == 3


@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (2, 8, 2, 300, 128, 0), (1, 4, 4, 200, 64, 0), (1, 4, 2, 130, 16, 32)])
def test_flash_attention_stats_keep_the_output(dev, b, h, hkv, s, d, window):
    """The ``wgmma`` forward's output is the same bits with its row
    statistics written as without, and the statistics are the plain
    version's (m within 1e-5 of its scale, l within 1e-4 relative)."""
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(s + d)
    q = torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=window, tq=s, tk=s)
    plain = ops.flash_attention(q, k, v, **kw)
    out, stats = ops.flash_attention(q, k, v, return_stats=True, **kw)
    assert torch.equal(out, plain)
    _, want = ops.flash_attention_plain(q, k, v, causal=True, window=window,
                                        tk=s, return_stats=True)
    assert float((stats[0] - want[0]).abs().max()) <= \
        1e-5 * float(want[0].abs().max())
    assert float(((stats[1] - want[1]) / want[1]).abs().max()) <= 1e-4


def test_train_step_launches_and_matches_cpu(dev):
    """Reduced qwen3: a train step launches 2 ``flash_attention`` and 1
    ``flash_attention_bwd`` a layer, and 2 steps on the card give the
    CPU's losses within 2e-2."""
    import copy
    from repro_torch import configs, kernels
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = configs.get_reduced("qwen3-4b")
    opt_cfg = OptConfig(warmup_steps=1, total_steps=2)
    pipe = TokenPipeline(cfg, 2, 64, seed=1)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    losses = {}
    for model in (copy.deepcopy(cpu).to(dev), cpu):
        opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        out = []
        for s in range(2):
            kernels.reset_launch_counts()
            model, opt, m = step(model, opt, pipe.batch_at(s))
            out.append(float(m["loss"]))
            n = kernels.launch_counts()
            if model.embed.device.type == "cuda":
                assert n["flash_attention"] == 2 * cfg.num_layers
                assert n["flash_attention_bwd"] == cfg.num_layers
        losses[model.embed.device.type] = out
    for a, c in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - c) <= 2e-2 * abs(c)


def test_meta_routes_leave_the_card_route(dev):
    """The wrappers' ``meta`` routes launch nothing; on the card the same
    calls still launch their kernels, once each, equal to the plain
    versions as before; the helpers' card route == the CPU's."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.reuse_distance import ops as rops
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
               for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    kernels.reset_launch_counts()
    meta = [t.to("meta") for t in (q, k, v)]
    out_m = fops.flash_attention(*meta)
    fops.flash_attention_bwd(*meta, out_m, out_m)
    assert sum(kernels.launch_counts().values()) == 0
    out = fops.flash_attention(q, k, v)
    grads = fops.flash_attention_bwd(q, k, v, out, out)
    n = kernels.launch_counts()
    assert n["flash_attention"] >= 1 and n["flash_attention_bwd"] == 1
    assert all(t.device.type == "cuda" for t in grads)
    kernels.reset_launch_counts()
    pool = torch.randn(8, 16, 2, 64, generator=g, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev).view(2, 4)
    lens = torch.tensor([50, 17], dtype=torch.int32, device=dev)
    qd = torch.randn(2, 4, 64, generator=g, device=dev)
    got = dops.paged_decode_attention(qd, pool, pool, table, lens)
    assert kernels.launch_counts()["paged_decode_attention"] == 1
    want = dops.paged_decode_attention_plain(qd, pool, pool, table, lens)
    assert float((got - want).abs().max()) <= 2e-5
    rng = np.random.default_rng(2)
    addr = rng.integers(0, 50, 400).astype(np.int32)
    w = rng.random(400) < 0.4
    kernels.reset_launch_counts()
    card = rops.reuse_distances(addr, w, Policy.RO, device="cuda")
    assert kernels.launch_counts()["count_between"] == 1
    cpu = rops.reuse_distances(addr, w, Policy.RO, device="cpu")
    assert torch.equal(card.dist.cpu(), cpu.dist)
    grid = np.arange(0, 321, 20)
    for a, b in zip(rops.sizing_reduction(addr, w, "trd", grid,
                                          with_reads=True, device="cuda"),
                    rops.sizing_reduction(addr, w, "trd", grid,
                                          with_reads=True, device="cpu")):
        assert torch.equal(a.cpu(), b)


def test_quantize_int8_card_equals_cpu(dev):
    """The int8 compressor's scale divides by 127 on the card as on the
    CPU (a 0-d tensor divisor: CUDA turns a Python number into a multiply
    by its reciprocal), so codes and scales match bit for bit."""
    from repro_torch.optim import compressed_psum, quantize_int8
    from repro_torch.launch.mesh import ModelMesh
    g = torch.Generator().manual_seed(4)
    x = torch.randn(64, 333, generator=g) * torch.rand(64, 1, generator=g)
    q, s = quantize_int8(x.to(dev))
    qc, sc = quantize_int8(x)
    assert torch.equal(q.cpu(), qc)
    assert torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32))
    grads = [{"w": x * (r + 1) / 3} for r in range(3)]
    meshes = [ModelMesh(((d,),) * 3, ("data", "model"))
              for d in (torch.device("cpu"), dev)]
    want = compressed_psum(grads, meshes[0])
    got = compressed_psum([{"w": t["w"].to(dev)} for t in grads], meshes[1])
    for a, b in zip(got, want):
        assert torch.equal(a["w"].cpu().view(torch.int32),
                           b["w"].view(torch.int32))
