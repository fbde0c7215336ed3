"""The datapath kernels' schedule against the JAX ``lax.scan``, on the CPU.

``csrc/datapath.cu`` (``two_level``) and ``csrc/single_level.cu``
(``single_level``) do not run a VM's requests in one chain: they walk
each cache set's requests on its own (``csrc/set_walk.cuh``). This file
models exactly that schedule in numpy and holds it bit for bit to
``simulate_two_level_batch`` and ``simulate_single_level_batch``:

- the row is streamed ``LOAD_COLS`` columns a step; padding (``addr <
  0``) is dropped and each kept request stored at its rank in a tile of
  at most ``TILE_CAP`` requests, which is walked before a step would
  overflow it, and once at the end;
- in a tile, each set's requests run in rank order with ``t = t0 + base
  + rank``, and the sets in any order (here, descending);
- ``two_level`` with equal set counts walks both levels of a set at
  once; with different counts, first the DRAM sets (keeping each
  request's DRAM hit), then the SSD sets;
- lookups take the least matching active way, the victim the least score
  and then the least way holding it (the kernel's warp reductions);
- each tile's latencies are added in rank order in float32 afterwards.

The card kernels are held to the plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core import simulator as jsim
from repro.core.policies import Policy as JPolicy
from repro_torch.core.policies import T_DRAM, T_HDD, T_HDD_WRITE, T_SSD

TILE_CAP, LOAD_COLS = 8192, 2048       # csrc/set_walk.cuh kTileCap, kLoadCols
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
SMALL_TILES = (12, 4)                  # a row of several tiles at N = 96
TWO_LEVEL_LAT = np.array([T_DRAM, T_SSD, T_HDD, T_HDD_WRITE], np.float32)
SINGLE_LAT = np.array([T_SSD, T_HDD, T_HDD_WRITE], np.float32)
V, N = 4, 96
WAYS = 4


# ---------------------------------------------------------------------------
# the kernel's schedule, in numpy
# ---------------------------------------------------------------------------

def stream_tiles(addr, is_write, cap, step):
    """Step 1 for one row: ``(base, [(addr, is_write), ...])`` per tile,
    ``base`` the valid requests before it."""
    tiles, fill, base = [], [], 0
    for c0 in range(0, len(addr), step):
        kept = [(int(a), bool(w)) for a, w in
                zip(addr[c0:c0 + step], is_write[c0:c0 + step]) if a >= 0]
        if len(fill) + len(kept) > cap:
            tiles.append((base, fill))
            base += len(fill)
            fill = []
        fill = fill + kept
    tiles.append((base, fill))
    return tiles


def find(tags, a, ways):
    """Least active way holding ``a``; -1 when none."""
    w = np.flatnonzero(tags[:ways] == a)
    return int(w.min()) if w.size else -1


def victim(tags, lru, ways):
    """Least score over the active ways (-1 empty, else lru), then the
    least way holding it."""
    score = np.where(tags[:ways] < 0, -1, lru[:ways])
    return int(np.flatnonzero(score == score.min()).min())


def walk(reqs, sets, apply):
    """Each set's requests in rank order, the sets in descending order."""
    for s in reversed(range(sets)):
        for i, (a, wr) in enumerate(reqs):
            if a % sets == s:
                apply(s, i, a, wr)


def dram_step(tg, lr, dt, ways, a, wr, t, c):
    way = find(tg, a, ways)
    if not wr:
        c[0] += 1
        if way >= 0:
            c[2] += 1
            lr[way] = t
        elif ways > 0:
            w = victim(tg, lr, ways)
            tg[w], lr[w], dt[w] = a, t, False
    else:
        c[1] += 1
        if way >= 0:
            tg[way], lr[way], dt[way] = -1, -1, False
    return way >= 0


def ssd_step(tg, lr, dt, ways, a, wr, t, d_hit, npe, c):
    if not wr:
        if d_hit:
            return 0
        way = find(tg, a, ways)
        if way >= 0:
            c[3] += 1
            lr[way] = t
            return 1
        c[6] += 1
        return 2
    way = find(tg, a, ways)
    if way >= 0:
        c[4] += 1
        c[5] += 1
        lr[way], dt[way] = t, True
        return 1
    if npe and ways > 0:
        w = victim(tg, lr, ways)
        c[5] += 1
        c[7] += int(tg[w] >= 0 and dt[w])
        tg[w], lr[w], dt[w] = a, t, True
        return 1
    c[7] += 1
    return 3


def ordered_sum(acc, codes, lat):
    for k in codes:
        acc = np.float32(acc + lat[k])
    return acc


def schedule_two_level(addr, is_write, dram, ssd, ways_d, ways_s, t0, npe,
                       tiles=(TILE_CAP, LOAD_COLS)):
    """``two_level``'s schedule: ``(dram, ssd, counts[V, 8], latency[V],
    t_end[V])``."""
    td, ld, dd = (x.copy() for x in dram)
    ts, ls, ds = (x.copy() for x in ssd)
    v, sd, ss = addr.shape[0], td.shape[1], ts.shape[1]
    counts = np.zeros((v, 8), np.int32)
    latency = np.zeros(v, np.float32)
    t_end = np.array(t0, np.int32)
    for r in range(v):
        wd = min(max(int(ways_d[r]), 0), td.shape[2])
        ws = min(max(int(ways_s[r]), 0), ts.shape[2])
        c = counts[r]
        for base, reqs in stream_tiles(addr[r], is_write[r], *tiles):
            tb = int(t0[r]) + base
            code = np.zeros(len(reqs), np.int64)
            d_hit = np.zeros(len(reqs), bool)

            def both(s, i, a, wr):
                dh = dram_step(td[r, s], ld[r, s], dd[r, s], wd, a, wr,
                               tb + i, c)
                code[i] = ssd_step(ts[r, s], ls[r, s], ds[r, s], ws, a, wr,
                                   tb + i, dh, npe, c)

            def dram_only(s, i, a, wr):
                d_hit[i] = dram_step(td[r, s], ld[r, s], dd[r, s], wd, a, wr,
                                     tb + i, c)

            def ssd_only(s, i, a, wr):
                code[i] = ssd_step(ts[r, s], ls[r, s], ds[r, s], ws, a, wr,
                                   tb + i, d_hit[i], npe, c)

            if sd == ss:
                walk(reqs, sd, both)
            else:
                walk(reqs, sd, dram_only)
                walk(reqs, ss, ssd_only)
            latency[r] = ordered_sum(latency[r], code, TWO_LEVEL_LAT)
            t_end[r] = tb + len(reqs)
    return (td, ld, dd), (ts, ls, ds), counts, latency, t_end


def single_step(tg, lr, dt, ways, flags, a, wr, t, c):
    ar, inv, hd, wt = flags
    way = find(tg, a, ways)
    hit = way >= 0
    if not wr:
        c[0] += 1
        if hit:
            c[3] += 1
            lr[way] = t
            return 0
        c[6] += 1
        if ar and ways > 0:
            w = victim(tg, lr, ways)
            c[5] += 1
            c[7] += int(tg[w] >= 0 and dt[w])
            tg[w], lr[w], dt[w] = a, t, False
        return 1
    c[1] += 1
    if inv:
        c[7] += 1
        if hit:
            tg[way], lr[way], dt[way] = -1, -1, False
        return 2
    if hit or ways > 0:
        c[5] += 1
        c[7] += int(wt)
        if hit:
            c[4] += 1
            lr[way] = t
            dt[way] = dt[way] or hd
        else:
            w = victim(tg, lr, ways)
            c[7] += int(tg[w] >= 0 and dt[w])
            tg[w], lr[w], dt[w] = a, t, hd
        return 2 if wt else 0
    c[7] += 2 if wt else 1
    return 2


def schedule_single_level(addr, is_write, state, ways, flags, t0,
                          tiles=(TILE_CAP, LOAD_COLS)):
    """``single_level``'s schedule: ``(state, counts, latency, t_end)``;
    ``flags`` is ``[V, 4]`` (allocates_reads, write_invalidates,
    holds_dirty, write_through)."""
    tg, lr, dt = (x.copy() for x in state)
    v, sets = addr.shape[0], tg.shape[1]
    counts = np.zeros((v, 8), np.int32)
    latency = np.zeros(v, np.float32)
    t_end = np.array(t0, np.int32)
    for r in range(v):
        w = min(max(int(ways[r]), 0), tg.shape[2])
        c = counts[r]
        f = tuple(bool(x) for x in flags[r])
        for base, reqs in stream_tiles(addr[r], is_write[r], *tiles):
            tb = int(t0[r]) + base
            code = np.zeros(len(reqs), np.int64)

            def one(s, i, a, wr):
                code[i] = single_step(tg[r, s], lr[r, s], dt[r, s], w, f, a,
                                      wr, tb + i, c)

            walk(reqs, sets, one)
            latency[r] = ordered_sum(latency[r], code, SINGLE_LAT)
            t_end[r] = tb + len(reqs)
    return (tg, lr, dt), counts, latency, t_end


# ---------------------------------------------------------------------------
# inputs and the comparison
# ---------------------------------------------------------------------------

def state(rng, v, s, w):
    """A set-consistent state (tag % S == s), partly empty, some dirty."""
    tags = rng.integers(0, 6, (v, s, w)) * s + np.arange(s)[:, None]
    tags = np.where(rng.random((v, s, w)) < 0.6, tags, -1).astype(np.int32)
    lru = np.where(tags >= 0, rng.integers(0, 40, tags.shape), -1)
    dirty = (rng.random(tags.shape) < 0.4) & (tags >= 0)
    return tags, lru.astype(np.int32), dirty


def requests(rng, space, one_set=1):
    """``[V, N]`` requests with padding mid-stream and one fully padded
    row; ``one_set`` > 1 puts every request of VM 0 in set 0."""
    addr = rng.integers(0, space, (V, N)).astype(np.int32)
    addr[0] *= one_set
    addr[rng.random((V, N)) < 0.15] = -1
    addr[2] = -1
    return addr, rng.random((V, N)) < 0.4


def assert_same(model, jout, levels):
    *states, counts, latency, t_end = model
    jstates, jst, jt = jout[:levels], jout[levels], jout[levels + 1]
    for got, want in zip(states, jstates):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    for k, name in enumerate(jsim.Stats._fields[:8]):
        np.testing.assert_array_equal(counts[:, k], np.asarray(jst[k]),
                                      err_msg=name)
    want = np.asarray(jst.latency_sum)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(latency.view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(t_end, np.asarray(jt))


def two_level_case(seed, sets_ssd, mode, one_set=1):
    rng = np.random.default_rng(seed)
    dram, ssd = state(rng, V, 8, WAYS), state(rng, V, sets_ssd, WAYS)
    addr, is_write = requests(rng, 64, one_set)
    ways_d = np.array([4, 0, 3, 2], np.int32)      # ways 0 at DRAM on VM 1
    ways_s = np.array([3, 4, 4, 0], np.int32)      # and at the SSD on VM 3
    t0 = rng.integers(0, 50, V).astype(np.int32)
    jout = jsim.simulate_two_level_batch(
        addr, is_write, jsim.CacheState(*dram), jsim.CacheState(*ssd),
        ways_d, ways_s, mode=mode, t0=t0)
    for tiles in ((TILE_CAP, LOAD_COLS), SMALL_TILES):
        model = schedule_two_level(addr, is_write, dram, ssd, ways_d, ways_s,
                                   t0, mode == "npe", tiles)
        assert_same(model, jout, 2)
    return addr


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sets_ssd", [8, 6], ids=["equal_sets", "6_ssd_sets"])
@pytest.mark.parametrize("mode", ["full", "npe"])
def test_two_level_schedule_matches_jax(mode, sets_ssd, seed):
    two_level_case(seed, sets_ssd, mode)


@pytest.mark.parametrize("sets_ssd", [8, 6], ids=["equal_sets", "6_ssd_sets"])
@pytest.mark.parametrize("mode", ["full", "npe"])
def test_two_level_one_set_takes_the_row(mode, sets_ssd):
    """Every request of VM 0 in set 0 of both levels: the longest chain."""
    addr = two_level_case(7, sets_ssd, mode, one_set=8 * sets_ssd)
    kept = addr[0][addr[0] >= 0]
    assert kept.size > 0 and np.all(kept % 8 == 0) and np.all(
        kept % sets_ssd == 0)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("policy", [p.value for p in JPolicy])
def test_single_level_schedule_matches_jax(policy, seed):
    """VM 0 under ``policy``, the others under the other four in turn."""
    rng = np.random.default_rng(100 + seed)
    others = [p for p in JPolicy if p.value != policy]
    pols = [JPolicy(policy)] + [others[(seed + k) % 4] for k in range(V - 1)]
    flags = jsim.policy_flags(pols)
    st = state(rng, V, 8, WAYS)
    addr, is_write = requests(rng, 64)
    ways = np.array([4, 2, 3, 0], np.int32)
    t0 = rng.integers(0, 50, V).astype(np.int32)
    jout = jsim.simulate_single_level_batch(
        addr, is_write, jsim.CacheState(*st), ways, flags, t_cache=T_SSD,
        t0=t0)
    fl = np.stack([np.asarray(x) for x in flags], axis=1)
    for tiles in ((TILE_CAP, LOAD_COLS), SMALL_TILES):
        model = schedule_single_level(addr, is_write, st, ways, fl, t0, tiles)
        assert_same(model, jout, 1)


def test_single_level_one_set_takes_the_row():
    rng = np.random.default_rng(11)
    pols = [JPolicy.WB, JPolicy.RO, JPolicy.WT, JPolicy.WBWO]
    flags = jsim.policy_flags(pols)
    st = state(rng, V, 8, WAYS)
    addr, is_write = requests(rng, 64, one_set=8)
    ways = np.array([4, 4, 1, 2], np.int32)
    t0 = np.zeros(V, np.int32)
    jout = jsim.simulate_single_level_batch(
        addr, is_write, jsim.CacheState(*st), ways, flags, t_cache=T_SSD,
        t0=t0)
    fl = np.stack([np.asarray(x) for x in flags], axis=1)
    for tiles in ((TILE_CAP, LOAD_COLS), SMALL_TILES):
        assert_same(schedule_single_level(addr, is_write, st, ways, fl, t0,
                                          tiles), jout, 1)


def test_fully_padded_block_leaves_everything():
    rng = np.random.default_rng(3)
    dram, ssd = state(rng, V, 8, WAYS), state(rng, V, 6, WAYS)
    addr = np.full((V, N), -1, np.int32)
    is_write = rng.random((V, N)) < 0.5
    t0 = np.arange(V, dtype=np.int32) * 7
    d, s, counts, latency, t_end = schedule_two_level(
        addr, is_write, dram, ssd, np.full(V, 4), np.full(V, 4), t0, True,
        SMALL_TILES)
    for got, want in zip(d + s, dram + ssd):
        np.testing.assert_array_equal(got, want)
    assert not counts.any() and not latency.any()
    np.testing.assert_array_equal(t_end, t0)


@pytest.mark.parametrize("cap,step", [(TILE_CAP, LOAD_COLS), (12, 4),
                                      (8, 8), (5, 1)])
def test_stream_tiles_keep_order_and_capacity(cap, step):
    """The tiles hold every valid request once, in order, at most ``cap``
    each, and a tile is closed only when the next step would overflow."""
    rng = np.random.default_rng(cap)
    addr = rng.integers(0, 50, 300).astype(np.int32)
    addr[rng.random(300) < 0.3] = -1
    is_write = rng.random(300) < 0.5
    tiles = stream_tiles(addr, is_write, cap, step)
    flat = [r for _, t in tiles for r in t]
    keep = addr >= 0
    assert flat == list(zip(addr[keep].tolist(), is_write[keep].tolist()))
    assert all(len(t) <= cap for _, t in tiles)
    assert [b for b, _ in tiles] == list(np.cumsum([0] + [len(t) for _, t in
                                                          tiles[:-1]]))
    if cap == TILE_CAP:
        assert len(tiles) == 1
    else:
        assert len(tiles) > 2


def test_model_constants_are_the_headers():
    """The model's tile and load step are the kernel's: kTileCap, and
    kLoadTiles scan tiles of kRowThreads columns."""
    walk = (CSRC / "set_walk.cuh").read_text()
    scan = (CSRC / "row_scan.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"{name} = (\d+);", text).group(1))

    assert const(walk, "kTileCap") == TILE_CAP
    assert const(walk, "kLoadTiles") * const(scan, "kRowThreads") == LOAD_COLS
    assert TILE_CAP % LOAD_COLS == 0
