"""The ``count_between`` and ``evict_scatter`` kernels
(``src/repro_torch/csrc/count_between.cu``, ``csrc/evict_scatter.cu``),
modelled on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them
to their plain versions there). Here their algorithms run in numpy with
the kernels' own constants, read from the sources, or with tiny tiles so
that the carries show:

- ``count_between``: the wrapper's plan (lanes a row, rows a CTA,
  threads), each CTA's column range (the union of its rows' windows),
  the columns streamed through a key tile (``key = touch ? nt : -1``),
  each lane's stride over its row's window with the counts carried
  across tiles, and the group's sum. The plan must write every row once,
  the lanes must visit each column of a window exactly once, and the
  count must equal the JAX package's Pallas kernel (interpret mode) and
  ``count_between_plain``.
- ``evict_scatter``: the wrapper's plan (CTAs a VM, threads), each CTA's
  slot range in chunks, the queue tile compacted by warp ballots (the
  warps' appends in a random order, as the shared atomic orders them),
  the open-addressing hash set (the kernel's hash, linear probing,
  inserts in a random order) and each slot's probe, with its match bit
  carried across tiles, and the cluster's count. It must equal the JAX
  package's ``evict`` (interpret mode) and ``evict_scatter_plain``, on
  states whose tags lie in any set.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.simulator import CacheState as JState
from repro.kernels.maintenance import ops as jops
from repro.kernels.reuse_distance.kernel import count_between as jcount

from repro_torch.core import reuse
from repro_torch.kernels.maintenance import ops as mops
from repro_torch.kernels.reuse_distance import ops as rops

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
H100_SMS = 132


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)",
                  (CSRC / source).read_text())
    return int(m.group(1))


COUNT_TILE = _constant("count_between.cu", "kTile")
VEC = _constant("count_between.cu", "kVec")
EVICT_TILE = _constant("evict_scatter.cu", "kTile")
EVICT_SLOTS = _constant("evict_scatter.cu", "kSlots")
EVICT_UNROLL = _constant("evict_scatter.cu", "kLoadUnroll")
EVICT_MIN_CAP = _constant("evict_scatter.cu", "kMinCap")


def test_wrapper_limits_match_the_kernels():
    assert _constant("count_between.cu", "kThreads") == rops.COUNT_THREADS
    assert _constant("count_between.cu", "kMaxRows") == rops.COUNT_MAX_ROWS
    assert _constant("evict_scatter.cu", "kThreads") == mops.EVICT_THREADS
    assert _constant("evict_scatter.cu", "kMaxParts") == mops.EVICT_MAX_PARTS


# ---------------------------------------------------------------------------
# count_between
# ---------------------------------------------------------------------------

def count_model(prev, touch, nt, lanes, rows, threads, tile=COUNT_TILE):
    """The kernel's steps on numpy ``[V, N]`` rows; returns the counts.
    Asserts on the way that every row is written once, that every block
    a lane reads lies in the tile, and that the lanes count each column
    of a row's window exactly once."""
    v_n, n = prev.shape
    groups = threads // lanes
    rpg = rows // groups
    assert threads % 32 == 0 and groups * rpg == rows and rows <= threads
    out = np.zeros((v_n, n), np.int64)
    written = np.zeros((v_n, n), np.int64)
    for v in range(v_n):
        for i0 in range(0, n, rows):
            i_end = min(i0 + rows, n)
            # 1. each row's window start; the CTA's columns [lo, hi)
            start = np.arange(i0, i0 + rows)
            for r in range(rows):
                i = i0 + r
                if i < i_end:
                    p = int(prev[v, i])
                    start[r] = 0 if p < 0 else (p + 1 if p < i else i)
            open_rows = start < np.arange(i0, i0 + rows)
            lo = int(start[open_rows].min()) if open_rows.any() else None
            hi = i_end - 1
            count = np.zeros(rows, np.int64)
            seen = np.zeros((rows, n), np.int64)
            t0 = lo // VEC * VEC if lo is not None else hi
            for t_lo in range(t0, hi, tile):
                # 2. the tile's keys (garbage past its length)
                ln = min(tile, hi - t_lo)
                key = np.full(tile + VEC, -(10 ** 9), np.int64)
                key[ln:] = 10 ** 9
                key[:ln] = np.where(touch[v, t_lo:t_lo + ln],
                                    nt[v, t_lo:t_lo + ln], -1)
                # 3. each group's rows: the lanes' blocks of the window
                for g in range(groups):
                    for rr in range(rpg):
                        r = g + rr * groups
                        i = i0 + r
                        j0 = max(start[r], t_lo) - t_lo
                        j1 = min(i, t_lo + ln) - t_lo
                        x = np.zeros(lanes, np.int64)
                        for lane in range(lanes):
                            for b in range(j0 // VEC + lane,
                                           -(-j1 // VEC), lanes):
                                js = b * VEC + np.arange(VEC)
                                assert js[0] < tile
                                m = (js >= j0) & (js < j1)
                                x[lane] += int((m & (key[js] >= i)).sum())
                                seen[r, js[m] + t_lo] += 1
                        count[r] += x.sum()
            # 4. the rows' counts
            for r in range(rows):
                i = i0 + r
                want = np.zeros(n, np.int64)
                if i < i_end:
                    want[start[r]:i] = 1
                    out[v, i] = count[r]
                    written[v, i] += 1
                np.testing.assert_array_equal(seen[r], want)
    np.testing.assert_array_equal(written, 1)
    return out.astype(np.int32)


def _rows(rng, v, n, space, p_touch):
    a = torch.from_numpy(rng.integers(0, space, (v, n)).astype(np.int32))
    touch = torch.from_numpy(rng.random((v, n)) < p_touch)
    return reuse._prev_same(a, touch), touch, reuse._next_same(a, touch)


def _check_count(prev, touch, nt, sms=H100_SMS, **kw):
    prev, touch, nt = (np.asarray(x) for x in (prev, touch, nt))
    v, n = prev.shape
    got = count_model(prev, touch, nt, *rops.count_plan(v, n, sms), **kw)
    plain = rops.count_between_plain(
        *(torch.from_numpy(x) for x in (prev, touch, nt)))
    np.testing.assert_array_equal(got, plain.numpy())
    for row in range(v):
        want = jcount(jnp.asarray(prev[row]), jnp.asarray(touch[row]),
                      jnp.asarray(nt[row]), interpret=True)
        np.testing.assert_array_equal(got[row], np.asarray(want))


COUNT_CASES = {  # v, n, address space, touch share, SMs, tile
    "-seq's lone row: lanes 32, rows 4": (1, 1024, 300, 0.7, H100_SMS,
                                          COUNT_TILE),
    "the 12-VM rows' plan: lanes 8, rows 32": (4, 1024, 300, 0.7, 44,
                                               COUNT_TILE),
    "the 1024-VM rows' plan: lanes 8, a CTA a VM": (3, 256, 60, 0.8, 1,
                                                    COUNT_TILE),
    "lanes 16, tiles of 32": (2, 400, 150, 0.6, H100_SMS, 32),
    "windows across many tiles of 16": (1, 600, 40, 0.9, H100_SMS, 16),
    "N not a multiple of rows, tiles of 8": (3, 77, 20, 0.5, 4, 8),
}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_model_equals_jax_and_plain(case):
    v, n, space, p_touch, sms, tile = COUNT_CASES[case]
    rng = np.random.default_rng(len(case))
    _check_count(*_rows(rng, v, n, space, p_touch), sms=sms, tile=tile)


def test_count_model_edges():
    """Windows of length 0 and 1, touch all false and all true, one
    address for a whole row, N 1, and arbitrary prev / nt (negative nt
    where touched, prev past i) that the key must still count exactly."""
    n = 96
    one = torch.zeros((1, n), dtype=torch.int32)
    seq = torch.arange(n, dtype=torch.int32)[None]
    cases = [
        (seq.repeat(2, 1), torch.ones((2, n), dtype=torch.bool)),  # no reuse
        (one, torch.ones((1, n), dtype=torch.bool)),   # windows of 0
        (one, torch.zeros((1, n), dtype=torch.bool)),  # nothing touched
        (seq % 2, torch.ones((1, n), dtype=torch.bool)),  # windows of 1
        (torch.zeros((1, 1), dtype=torch.int32),
         torch.ones((1, 1), dtype=torch.bool)),         # N 1
    ]
    for a, touch in cases:
        prev, nt = reuse._prev_same(a, touch), reuse._next_same(a, touch)
        for sms, tile in ((H100_SMS, COUNT_TILE), (1, 16)):
            _check_count(prev, touch, nt, sms=sms, tile=tile)
    rng = np.random.default_rng(5)
    prev = rng.integers(-3, n + 3, (2, n)).astype(np.int32)
    nt = rng.integers(-3, n + 3, (2, n)).astype(np.int32)
    touch = rng.random((2, n)) < 0.6
    for sms, tile in ((H100_SMS, COUNT_TILE), (3, 8)):
        _check_count(prev, touch, nt, sms=sms, tile=tile)


def test_count_plan_from_shapes():
    """-seq's lone row: 32 lanes, 256 CTAs; the 12-VM rows: 8 lanes, 384
    CTAs; the 1024-VM rows: 8 lanes, a CTA a VM; every plan keeps whole
    warps, at least four a CTA, and rows the kernel takes."""
    assert rops.count_plan(1, 1024, H100_SMS) == (32, 4, 128)
    assert rops.count_plan(12, 1024, H100_SMS) == (8, 32, 256)
    assert rops.count_plan(1024, 256, H100_SMS) == (8, 256, 256)
    assert rops.count_plan(2, 400, H100_SMS) == (16, 8, 128)
    for v in (1, 3, 12, 1024):
        for n in (1, 5, 64, 255, 1024, 20_000):
            lanes, rows, threads = rops.count_plan(v, n, H100_SMS)
            assert lanes in (8, 16, 32) and threads % 32 == 0
            assert 128 <= threads <= rops.COUNT_THREADS
            assert rows % (threads // lanes) == 0
            assert rows <= min(threads, rops.COUNT_MAX_ROWS)


# ---------------------------------------------------------------------------
# evict_scatter
# ---------------------------------------------------------------------------

def set_capacity(live):
    cap = EVICT_MIN_CAP
    while cap < 2 * live:
        cap <<= 1
    return cap


def set_slot(a, bits):
    return ((int(a) & 0xffffffff) * 2654435761 & 0xffffffff) >> (32 - bits)


def build_set(entries, threads, rng, unroll=EVICT_UNROLL):
    """Compaction by warp ballots (each round's warps append in a random
    order) and inserts in a random order; returns ``(set, cap, bits)``."""
    ln = entries.size
    live = []
    for k0 in range(0, ln, unroll * threads):
        for u in range(unroll):
            for warp in rng.permutation(threads // 32):
                ks = k0 + u * threads + warp * 32 + np.arange(32)
                e = np.where(ks < ln, entries[np.minimum(ks, ln - 1)], -1)
                live.extend(int(x) for x in e[e >= 0])
    assert sorted(live) == sorted(int(x) for x in entries[entries >= 0])
    cap = set_capacity(len(live))
    bits = cap.bit_length() - 1
    table = np.full(cap, -1, np.int64)
    for a in rng.permutation(np.asarray(live, np.int64)):
        h = set_slot(a, bits)
        while table[h] not in (-1, a):
            h = (h + 1) & (cap - 1)
        table[h] = a
    assert set(table[table >= 0]) == set(live)
    assert 2 * len(set(live)) <= cap
    return table, cap, bits


def probe(table, cap, bits, tg, hit):
    """Each tag >= 0 not yet matched walks from its slot to its tag or an
    empty slot."""
    h = np.array([set_slot(t, bits) for t in tg], np.int64)
    active = (tg >= 0) & ~hit
    while active.any():
        x = table[h]
        hit |= active & (x == tg)
        active &= (x != tg) & (x != -1)
        h = (h + 1) & (cap - 1)
    return hit


def evict_model(tags, lru, dirty, queue, parts, threads, rng,
                tile=EVICT_TILE):
    """The kernel's steps on numpy arrays; returns the four outputs."""
    v_n, s_n, w_n = tags.shape
    sw, q = s_n * w_n, queue.shape[1]
    tile = min(tile, max(32, -(-q // 32) * 32))
    tiles = -(-q // tile)
    tg_all, lr_all = tags.reshape(v_n, sw), lru.reshape(v_n, sw)
    dt_all = dirty.reshape(v_n, sw)
    out_t, out_l, out_d = tg_all.copy(), lr_all.copy(), dt_all.copy()
    flushed = np.zeros(v_n, np.int32)
    chunk = EVICT_SLOTS * threads
    for v in range(v_n):
        ctas = []
        for part in range(parts):
            s_lo, s_hi = sw * part // parts, sw * (part + 1) // parts
            n_fl = 0
            for c_lo in range(s_lo, s_hi, chunk):
                idx = np.arange(c_lo, min(c_lo + chunk, s_hi))
                tg = tg_all[v, idx].astype(np.int64)
                hit = np.zeros(idx.size, bool)
                for ti in range(tiles):
                    if tiles > 1 or c_lo == s_lo:
                        built = build_set(queue[v, ti * tile:(ti + 1) * tile],
                                          threads, rng)
                    hit = probe(*built, tg, hit)
                out_t[v, idx] = np.where(hit, -1, tg)
                out_l[v, idx] = np.where(hit, -1, lr_all[v, idx])
                out_d[v, idx] = dt_all[v, idx] & ~hit
                n_fl += int((hit & dt_all[v, idx]).sum())
            ctas.append(n_fl)
        flushed[v] = sum(ctas)
    shape = tags.shape
    return (out_t.reshape(shape), out_l.reshape(shape), out_d.reshape(shape),
            flushed)


def _random_state(rng, v, s, w, addr_space, set_consistent=False):
    """Tags anywhere in ``[0, addr_space)`` (or only in set ``tag % S``),
    unique per VM and set."""
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


def _check_evict(tags, lru, dirty, queue, sms=H100_SMS, **kw):
    v, s, w = tags.shape
    rng = np.random.default_rng(queue.shape[1] + v)
    got = evict_model(tags, lru, dirty, queue,
                      *mops.evict_plan(v, s * w, sms), rng, **kw)
    plain = mops.evict_scatter_plain(
        *(torch.from_numpy(x) for x in (tags, lru, dirty, queue)))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    jst, jfl = jops.evict(JState(*(jnp.asarray(x) for x in (tags, lru,
                                                             dirty))),
                          queue, interpret=True)
    for g, j in zip(got, (*jst, jfl)):
        np.testing.assert_array_equal(g, np.asarray(j))


def _queues(rng, tags, q, cases):
    """``[V, Q]`` queues, VM by VM: each name in ``cases`` picks one."""
    v = tags.shape[0]
    out = np.full((v, q), -1, np.int32)
    for i in range(v):
        res = tags[i][tags[i] >= 0]
        kind = cases[i % len(cases)]
        if kind == "residents" and res.size:       # every resident block
            row = rng.permutation(res)
        elif kind == "spread":                     # residents anywhere
            row = np.full(q, -1)
            row[rng.choice(q, min(res.size, q), replace=False)] = res[:q]
        elif kind == "dups":                       # repeats, absent blocks
            row = np.concatenate([np.repeat(res[:5], 3),
                                  rng.integers(0, 4 * res.size + 64, 20)])
        elif kind == "negatives":                  # other negative entries
            row = np.concatenate([res[:7], [-2, -5, -(2 ** 31), -100]])
            row = rng.permutation(row)
        elif kind == "both sides of a tile edge":
            row = np.full(q, -1)
            row[EDGE - 3:EDGE + 3] = np.resize(res, 6) if res.size else -1
            row[rng.integers(0, q, 4)] = np.resize(res[::-1], 4) \
                if res.size else -1
        else:                                      # all -1
            row = np.empty(0, np.int32)
        out[i, :min(q, row.size)] = row[:q]
    return out


EDGE = 32  # the tiny tile of the tests that cross a tile edge
EVICT_CASES = {  # v, s, w, space, set consistent, q, sms, tile, queues
    "main path [12, 64, 64] Q 4096": (3, 64, 64, 4 * 4096, True, 4096,
                                      44, EVICT_TILE, ("dups", "residents")),
    "set-inconsistent, 8 parts": (4, 16, 64, 3000, False, 1024, H100_SMS,
                                  EVICT_TILE, ("dups", "negatives",
                                               "residents", "none")),
    "the 1024-VM plan: one CTA of 128": (6, 16, 32, 900, False, 512, 2,
                                         EVICT_TILE, ("dups", "negatives")),
    "wider than a tile, both sides of its edge": (
        3, 8, 8, 200, False, 96, H100_SMS, EDGE,
        ("both sides of a tile edge", "dups", "residents")),
    "Q wider than one real tile": (2, 16, 16, 1000, False, 5000, H100_SMS,
                                   EVICT_TILE, ("spread", "dups")),
    "chunks: 4 slots a thread, 2 chunks a CTA": (1, 64, 32, 5000, False,
                                                 256, 1, EVICT_TILE,
                                                 ("residents",)),
    "V 1, Q not a multiple of 32": (1, 4, 8, 100, False, 45, H100_SMS,
                                    EVICT_TILE, ("negatives",)),
}


@pytest.mark.parametrize("case", list(EVICT_CASES))
def test_evict_model_equals_jax_and_plain(case):
    v, s, w, space, consistent, q, sms, tile, kinds = EVICT_CASES[case]
    rng = np.random.default_rng(len(case))
    tags, lru, dirty = _random_state(rng, v, s, w, space, consistent)
    queue = _queues(rng, tags, q, kinds)
    _check_evict(tags, lru, dirty, queue, sms=sms, tile=tile)


def test_evict_model_edges():
    """Q 0, an all-``-1`` queue, a queue naming every block of a
    set-inconsistent state (each block in several sets)."""
    rng = np.random.default_rng(3)
    tags, lru, dirty = _random_state(rng, 2, 6, 5, 12)
    for q in (np.full((2, 0), -1, np.int32), np.full((2, 64), -1, np.int32),
              np.tile(np.arange(12, dtype=np.int32), (2, 1))):
        _check_evict(tags, lru, dirty, q)
        _check_evict(tags, lru, dirty, q, sms=1)


def test_evict_plan_from_shapes():
    """Eight CTAs of 256 a VM at the fused path's 12 VMs; one CTA of 128 a
    VM at 1024 VMs; at least 512 slots a CTA where a VM is split."""
    assert mops.evict_plan(12, 4096, H100_SMS) == (8, 256)
    assert mops.evict_plan(1024, 512, H100_SMS) == (1, 128)
    assert mops.evict_plan(1, 16384, H100_SMS) == (8, 256)
    assert mops.evict_plan(4, 1024, H100_SMS) == (2, 256)
    assert mops.evict_plan(128, 512, H100_SMS) == (1, 256)
    assert mops.evict_plan(1, 7, H100_SMS) == (1, 256)
