"""The shared-memory row sort behind the ``popularity`` and ``run_sums``
kernels (``src/repro_torch/csrc/row_sort.cuh``), emulated step for step
on the CPU, and the window compaction against the JAX reference.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
holds them to their plain versions there). Here the kernels' algorithm is
run in plain torch, numpy and Python: the same flag scan over tiles and
warps, the same stable merge sort by ranking with the same branchless
searches over the same biased unsigned keys, the same run heads,
galloping run ends and left-to-right float32 sums. The sort is held to
``torch.sort(stable=True)`` and the emulated kernels to the plain
versions; the plain window compaction, which the kernel is held to on the
card, is held to the reference's stable argsort and ``_compact_runs``
under ``jax.vmap``, bit for bit.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import popularity as jpop

from repro_torch import kernels
from repro_torch.core import popularity as tpop
from repro_torch.kernels.popularity import ops as pops

TABLE_EMPTY = 2**31 - 1
THREADS = 512                 # row_scan.cuh kRowThreads
HEADER = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/csrc/row_sort.cuh")
SCAN_HEADER = HEADER.with_name("row_scan.cuh")   # the flag scan's CTA


def row_scan(flags: torch.Tensor):
    """``RowScan``: tiles of ``THREADS`` positions, one count per (tile,
    warp), exclusive bases over them, then each lane's flagged lanes
    below it. Returns (exclusive rank of every position, total)."""
    n = flags.numel()
    tiles = -(-n // THREADS)
    f = torch.zeros(tiles * THREADS, dtype=torch.int64)
    f[:n] = flags.long()
    f = f.view(-1, 32)                         # (tile, warp) x lane
    counts = f.sum(1)
    base = counts.cumsum(0) - counts
    below = f.cumsum(1) - f
    return (base[:, None] + below).reshape(-1)[:n], int(counts.sum())


PAD_KEY = 2**32 - 1           # the padding pairs' key (kPadPair)
CHUNK = 8                     # row_sort.cuh kChunk


def sort_chunk(x: list) -> list:
    """``sort_chunk``: odd-even transposition of 8 (key, value) entries,
    swapping only a strictly greater key past a smaller one."""
    x = list(x)
    for phase in range(CHUNK):
        for r in range(phase & 1, CHUNK - 1, 2):
            if x[r + 1][0] < x[r][0]:
                x[r], x[r + 1] = x[r + 1], x[r]
    return x


def row_sort(keys: list) -> list:
    """``row_sort`` on m unsigned 32-bit keys: p (the power of two at or
    above m, at least 8) entries, padding keys after the row's; each
    chunk of 8 sorted by ``sort_chunk``; then rounds that double the
    sorted runs by ranking, each entry's count found by the kernel's
    branchless binary search (keys below it in the other run if it is in
    the left one, at or below it if in the right one) from the runs as
    the round found them. Returns the row indices in sorted order and
    checks that every round is a permutation and the padding ends last."""
    m = len(keys)
    p = CHUNK
    while p < m:
        p <<= 1
    x = [(k, i) for i, k in enumerate(keys)] + [(PAD_KEY, None)] * (p - m)
    x = [e for c in range(0, p, CHUNK) for e in sort_chunk(x[c:c + CHUNK])]
    length = CHUNK
    while length < p:
        out = [None] * p
        for e in range(p):
            left = (e & length) == 0
            start = e & ~(2 * length - 1)
            other = start + (length if left else 0)
            key = x[e][0]

            def below(o):
                return o < key if left else o <= key
            cnt, step = 0, length >> 1
            while step:
                if below(x[other + cnt + step - 1][0]):
                    cnt += step
                step >>= 1
            if below(x[other + cnt][0]):
                cnt += 1
            pos = start + (e & (length - 1)) + cnt
            assert out[pos] is None
            out[pos] = x[e]
        x = out
        length <<= 1
    assert all(v is None for _, v in x[m:]) and all(
        v is not None for _, v in x[:m])
    return [v for _, v in x[:m]]


def gallop_end(keys: np.ndarray, lo: int, m: int) -> int:
    """``run_end``: the end of the run of ``keys[lo]`` by a galloping
    search, then a binary search."""
    key = keys[lo]
    step = 1
    while lo + step < m and keys[lo + step] == key:
        step <<= 1
    a, b = lo + (step >> 1) + 1, min(lo + step, m)
    while a < b:
        mid = (a + b) >> 1
        if keys[mid] == key:
            a = mid + 1
        else:
            b = mid
    return a


def _flush(x: np.float32) -> np.float32:
    return np.float32(np.copysign(0.0, x)) if abs(x) < 2.0**-126 else x


def sorted_runs(keys: np.ndarray, vals: np.ndarray, flush: bool):
    """The kept entries' (key, value) pairs through ``row_sort``; then,
    for each run head, its key, its output slot (the scan's rank of the
    heads) and its left-to-right sum. Returns a list of ``(key, slot,
    sum)``."""
    m = keys.size
    order = row_sort([int(k) for k in keys])
    skeys, svals = keys[order], vals[order]
    heads = np.ones(m, bool)
    heads[1:] = skeys[1:] != skeys[:-1]
    out_slots, _ = row_scan(torch.from_numpy(heads))
    out = []
    for i in np.flatnonzero(heads):
        acc = np.float32(0.0)
        for j in range(i, gallop_end(skeys, i, m)):
            acc = np.float32(acc + svals[j])
            if flush:
                acc = _flush(acc)
        out.append((int(skeys[i]), int(out_slots[i]), acc))
    return out


def emulate_run_sums(wa, wc, n_valid):
    """The ``run_sums`` kernel, one row after another."""
    v, n = wa.shape
    uaddr = np.full((v, n), TABLE_EMPTY, np.int32)
    uval = np.zeros((v, n), np.float32)
    for r in range(v):
        m = min(max(int(n_valid[r]), 0), n)
        vals = np.array([_flush(x) for x in wc[r, :m]], np.float32)
        keys = wa[r, :m].astype(np.int64) + 2**31        # signed_key
        for key, out_slot, acc in sorted_runs(keys, vals, True):
            addr = key - 2**31
            uaddr[r, out_slot] = addr
            uval[r, out_slot] = 0.0 if addr == TABLE_EMPTY else acc
    return uaddr, uval


def emulate_popularity(dist, served, seg, num_blocks, cs):
    """The ``popularity`` kernel, one row after another: padding (ids
    outside ``[0, num_blocks)``) dropped by the scan, contributions
    summed without a flush."""
    contrib = tpop.contributions(torch.from_numpy(dist),
                                 torch.from_numpy(served),
                                 torch.from_numpy(cs)[:, None]).numpy()
    out = np.zeros(num_blocks, np.float32)
    for r in range(dist.shape[0]):
        flags = torch.from_numpy((seg[r] >= 0) & (seg[r] < num_blocks))
        ranks, m = row_scan(flags)
        kept = np.flatnonzero(flags.numpy())
        assert np.array_equal(ranks.numpy()[kept], np.arange(m))
        for key, _, acc in sorted_runs(seg[r, kept].astype(np.int64),
                                       contrib[r, kept], False):
            out[key] = acc
    return out


def jax_window_runs(waddr, contrib, n_valid):
    """The reference's window step of ``_row_update``
    (src/repro/core/popularity.py:236-240), every row under ``vmap``."""
    def row(wa, wc, nv):
        valid = jnp.arange(wa.shape[0], dtype=jnp.int32) < nv
        wa = jnp.where(valid, wa, jpop.TABLE_EMPTY)
        wc = jnp.where(valid, wc, 0.0)
        order = jnp.argsort(wa, stable=True)
        return jpop._compact_runs(wa[order], wc[order])
    a, v = jax.jit(jax.vmap(row))(waddr, contrib, n_valid)
    return np.asarray(a), np.asarray(v)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _row_keys(case: str, rng):
    """``(keys int32, padding mask)`` of one row for the sort cases."""
    if case == "heavy_ties":
        keys = rng.integers(0, 4, 1000)
    elif case == "one_key":
        keys = np.full(777, 12345)
    elif case == "all_padding":
        keys = rng.integers(0, 50, 300)
        return keys.astype(np.int32), np.ones(300, bool)
    elif case == "not_pow2":
        keys = rng.integers(-2**31, 2**31 - 1, 1000)
    elif case == "table_empty_minus_1":
        keys = rng.choice([TABLE_EMPTY - 1, TABLE_EMPTY, 0, -1, 7], 600)
    else:                                       # row at the kernel's limit
        keys = rng.integers(0, 64, kernels.ROW_MAX)
    return keys.astype(np.int32), rng.random(keys.size) < 0.2


@pytest.mark.parametrize("case", ["heavy_ties", "one_key", "all_padding",
                                  "not_pow2", "table_empty_minus_1",
                                  "row_max"])
def test_row_sort_equals_stable_sort(case):
    """Padding dropped by the scan, then ``row_sort`` of the kept keys (as
    the kernels bias them: int32 + 2**31): the order of
    ``torch.sort(stable=True)``, ties included."""
    rng = np.random.default_rng(len(case))
    keys, pad = _row_keys(case, rng)
    ranks, m = row_scan(torch.from_numpy(~pad))
    kept = torch.from_numpy(keys[~pad])
    assert m == kept.numel()
    assert torch.equal(ranks[torch.from_numpy(~pad)], torch.arange(m))
    order = row_sort([int(k) + 2**31 for k in kept.tolist()])
    want = torch.sort(kept, stable=True).indices
    assert torch.equal(torch.tensor(order, dtype=torch.int64), want)


def _window(case: str):
    """``(waddr, contrib, n_valid)`` of the window-compaction cases."""
    rng = np.random.default_rng(len(case) + 1)
    v, n = 6, 200
    waddr = rng.integers(0, 40, (v, n)).astype(np.int32)
    contrib = np.where(rng.random((v, n)) < 0.7, rng.random((v, n)),
                       0.0).astype(np.float32)
    n_valid = np.array([n, 150, 0, 1, n + 5, -3], np.int32)
    if case == "subnormal":
        # partial sums that cross the subnormal range (flushed), and
        # subnormal contributions (they add as zero)
        contrib = rng.choice(np.array(
            [2e-38, -1.5e-38, 3e-38, 1e-39, -1e-39, -2e-38, 0.5],
            np.float32), (v, n))
        waddr = rng.integers(0, 6, (v, n)).astype(np.int32)
    elif case == "worst_chain":
        waddr[:] = 9                          # one address, every access
    elif case == "extreme_keys":
        waddr = rng.choice(np.array([TABLE_EMPTY - 1, TABLE_EMPTY, -1, 0,
                                     -2**31, 5], np.int32), (v, n))
    elif case == "empty":
        n_valid[:] = 0
    return waddr, contrib, n_valid


@pytest.mark.parametrize("case", ["padding", "subnormal", "worst_chain",
                                  "extreme_keys", "empty"])
def test_window_runs_plain_matches_jax(case):
    """The plain window compaction == the reference's stable argsort +
    ``_compact_runs``, per row under ``jax.vmap``, bit for bit: padding
    past ``n_valid`` (0, 1, past the row, negative), subnormal partial
    sums and contributions, one address for a whole row, the extreme
    keys, empty rows."""
    waddr, contrib, n_valid = _window(case)
    want = jax_window_runs(waddr, contrib, n_valid)
    got = tpop.window_runs_plain(*map(torch.from_numpy,
                                      (waddr, contrib, n_valid)))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(_bits(got[1].numpy()), _bits(want[1]))


@pytest.mark.parametrize("case", ["padding", "subnormal", "worst_chain",
                                  "extreme_keys"])
def test_run_sums_emulation_equals_plain(case):
    """The ``run_sums`` kernel's algorithm, emulated, == the plain window
    compaction it is held to on the card, bit for bit."""
    waddr, contrib, n_valid = _window(case)
    got = emulate_run_sums(waddr, contrib, n_valid)
    want = tpop.window_runs_plain(*map(torch.from_numpy,
                                       (waddr, contrib, n_valid)))
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(_bits(got[1]), _bits(want[1].numpy()))


@pytest.mark.parametrize("v,n,num_blocks", [(5, 333, 120), (1, 8192, 1024)])
def test_popularity_emulation_equals_plain(v, n, num_blocks):
    """The ``popularity`` kernel's algorithm, emulated, ==
    ``popularity_rows_plain``, bit for bit: segments in one row each,
    padding ids (``num_blocks`` and past) dropped, and the Pallas
    benchmark's single row of 8,192 accesses over 1,024 blocks."""
    rng = np.random.default_rng(n)
    per = num_blocks // v
    seg = (rng.integers(0, per, (v, n))
           + per * np.arange(v)[:, None]).astype(np.int32)
    seg[rng.random((v, n)) < 0.15] = num_blocks + 3
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = rng.choice(np.array([0, 1, 64, 4096], np.float32), v)
    got = emulate_popularity(dist, served, seg, num_blocks, cs)
    want = pops.popularity_rows_plain(
        *map(torch.from_numpy, (dist, served, seg)), num_blocks,
        torch.from_numpy(cs))
    assert np.array_equal(_bits(got), _bits(want.numpy()))


def test_row_limit_is_the_header_limit_and_picks_the_route():
    """``kernels.ROW_MAX`` is ``kMaxRow`` of the header and the tiled
    route's tile (``kTile`` of ``row_merge.cuh``), its shared memory (8
    bytes a pair and the scan's counts) fits a CTA's 227 KB, and the route
    changes there: ``row`` up to ``ROW_MAX`` entries, ``tiled`` from
    ``ROW_MAX + 1`` on, with the tiled route's scratch sized from the
    shape."""
    text = HEADER.read_text()
    assert int(re.search(r"kMaxRow = (\d+);", text).group(1)) \
        == kernels.ROW_MAX
    assert "constexpr int kTile = kMaxRow;" in \
        HEADER.with_name("row_merge.cuh").read_text()
    assert int(re.search(r"kRowThreads = (\d+);",
                         SCAN_HEADER.read_text()).group(1)) == THREADS \
        == kernels.ROW_THREADS
    assert int(re.search(r"kChunk = (\d+);", text).group(1)) == CHUNK
    assert kernels.ROW_MAX * 8 + 4 * (kernels.ROW_MAX // 32 + 1) <= 232_448
    assert kernels.row_route(1) == "row"
    assert kernels.row_route(kernels.ROW_MAX) == "row"
    assert kernels.row_route(kernels.ROW_MAX + 1) == "tiled"
    assert kernels.row_route(40_000) == "tiled"
    a, b, count, base, heads = kernels.row_scratch(3, 40_000,
                                                   torch.device("cpu"))
    assert a.shape == b.shape == (3, 40_000) and a.dtype == torch.int64
    assert count.shape == (3, 3) and base.shape == (3, 4)
    assert heads.shape == (3, -(-40_000 // THREADS))
    for kernel in ("popularity", "run_sums"):
        assert set(kernels.ROUTES[kernel]) == {"row", "tiled"}
        assert set(kernels.route_counts(kernel)) == {"row", "tiled"}
