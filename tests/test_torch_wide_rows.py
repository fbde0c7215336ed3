"""The tiled route of ``popularity`` and ``run_sums`` (rows wider than
``kernels.ROW_MAX``, ``src/repro_torch/csrc/row_merge.cuh``) and the
cleaner's one-launch radix select (``csrc/clean_scatter.cu``), emulated
step for step on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them
to their plain versions there). Here their algorithms run in numpy at a
small tile width: each tile's kept entries sorted by the in-CTA row sort
(``test_torch_row_sort.row_sort``), written at the tile's offset with
their count; the counts' bases; merge rounds by ranking (a binary search
of the partner run: keys below for the left run, at or below for the
right one), a run without a partner copied; then run heads, the heads of
each position chunk, each head's slot from the chunks before it, and its
run's left-to-right float32 sum over the merged row, across what were
tile edges. The emulations are held bit for bit to the plain versions
and, through them, to the JAX package: ``window_runs_plain`` to the
reference's stable argsort + ``_compact_runs``, ``popularity_rows_plain``
to ``block_scores`` of each row. The cleaner's emulation (count, least
and greatest key, 8-bit passes over per-CTA histograms summed across the
cluster) is held to ``_clean_cutoffs`` of both packages and to the flush
of ``clean_scatter_plain``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import popularity as jpop
from repro.kernels.maintenance import ops as jops

from repro_torch import kernels
from repro_torch.core import popularity as tpop
from repro_torch.kernels.maintenance import ops as tops
from repro_torch.kernels.popularity import ops as pops

from test_torch_row_sort import (TABLE_EMPTY, _bits, _flush, gallop_end,
                                 jax_window_runs, row_sort)

TILE = 64            # the emulation's tile (the kernels': kTile = ROW_MAX)
CHUNK = 32           # positions a run-pass chunk (the kernels': 512)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"


def tile_sort(keys: np.ndarray, vals: np.ndarray, tiles_kept: list):
    """The tile kernels of one row: ``tiles_kept[t]`` are tile t's kept
    positions in order; their (key, value) pairs sorted by ``row_sort``
    and written at ``t * TILE`` of the scratch row; returns ``(scratch
    keys, scratch values, counts)``. Unwritten slots hold garbage."""
    n = keys.size
    sk = np.full(n, 0xDEAD, np.int64)
    sv = np.full(n, np.nan, np.float32)
    counts = []
    for t, kept in enumerate(tiles_kept):
        order = row_sort([int(k) for k in keys[kept]])
        m = len(order)
        sk[t * TILE:t * TILE + m] = keys[kept][order]
        sv[t * TILE:t * TILE + m] = vals[kept][order]
        counts.append(m)
    return sk, sv, np.array(counts, np.int64)


def merge_rounds(sk, sv, counts):
    """``merge_round_kernel`` round after round, from the tile counts'
    bases; returns the merged row's keys and values (its kept pairs from
    slot 0) and their count."""
    tiles = counts.size
    base = np.concatenate([[0], np.cumsum(counts)])
    n = sk.size
    run_tiles = 1
    while run_tiles < tiles:
        dk = np.full(n, 0xBEEF, np.int64)
        dv = np.full(n, np.nan, np.float32)
        written = np.zeros(n, bool)
        span = run_tiles * TILE
        for run in range(-(-tiles // run_tiles)):
            t0 = run * run_tiles
            length = base[min(t0 + run_tiles, tiles)] - base[t0]
            o0 = (run ^ 1) * run_tiles
            other = (base[min(o0 + run_tiles, tiles)] - base[o0]
                     if o0 < tiles else 0)
            left = run % 2 == 0
            mine = slice(run * span, run * span + length)
            theirs = sk[o0 * TILE:o0 * TILE + other]
            cnt = np.searchsorted(theirs, sk[mine],
                                  side="left" if left else "right")
            dest = (run & ~1) * span + np.arange(length) + cnt
            assert not written[dest].any()
            written[dest] = True
            dk[dest], dv[dest] = sk[mine], sv[mine]
        sk, sv = dk, dv
        run_tiles <<= 1
    total = int(base[-1])
    assert np.all(np.diff(sk[:total]) >= 0)
    return sk, sv, total


def run_sum(sk, sv, i, m, flush: bool) -> np.float32:
    """The run from merged position i, added left to right."""
    acc = np.float32(0.0)
    for j in range(i, gallop_end(sk, i, m)):
        acc = np.float32(acc + sv[j])
        if flush:
            acc = _flush(acc)
    return acc


def emulate_run_sums_tiled(wa, wc, n_valid):
    """The ``run_sums`` tiled route, one row after another."""
    v, n = wa.shape
    uaddr = np.full((v, n), -7, np.int64)
    uval = np.full((v, n), np.nan, np.float32)
    tiles = -(-n // TILE)
    for r in range(v):
        valid = min(max(int(n_valid[r]), 0), n)
        kept = [np.arange(t * TILE, t * TILE + min(max(valid - t * TILE, 0),
                                                   TILE))
                for t in range(tiles)]
        keys = wa[r].astype(np.int64) + 2**31                # signed_key
        vals = np.array([_flush(x) for x in wc[r]], np.float32)
        sk, sv, m = merge_rounds(*tile_sort(keys, vals, kept))
        head = np.zeros(n, bool)
        head[:m] = True
        head[1:m] = sk[1:m] != sk[:max(m - 1, 0)]
        chunk_heads = np.add.reduceat(head.astype(np.int64),
                                      np.arange(0, n, CHUNK))
        runs = int(chunk_heads.sum())
        for c in range(chunk_heads.size):
            before = int(chunk_heads[:c].sum())
            for i in range(c * CHUNK, min((c + 1) * CHUNK, n)):
                if head[i]:
                    slot = before + int(head[c * CHUNK:i].sum())
                    addr = int(sk[i]) - 2**31
                    uaddr[r, slot] = addr
                    uval[r, slot] = (0.0 if addr == TABLE_EMPTY else
                                     run_sum(sk, sv, i, m, True))
                if i >= runs:
                    uaddr[r, i], uval[r, i] = TABLE_EMPTY, 0.0
    assert (uaddr != -7).all()
    return uaddr.astype(np.int32), uval


def emulate_popularity_tiled(dist, served, seg, num_blocks, cs):
    """The ``popularity`` tiled route: each tile drops its padding (ids
    outside ``[0, num_blocks)``), then one thread a segment of the merged
    row adds its contributions without a flush."""
    v, n = seg.shape
    contrib = tpop.contributions(torch.from_numpy(dist),
                                 torch.from_numpy(served),
                                 torch.from_numpy(cs)[:, None]).numpy()
    out = np.zeros(num_blocks, np.float32)
    tiles = -(-n // TILE)
    for r in range(v):
        keep = (seg[r] >= 0) & (seg[r] < num_blocks)
        kept = [t * TILE + np.flatnonzero(keep[t * TILE:(t + 1) * TILE])
                for t in range(tiles)]
        sk, sv, m = merge_rounds(*tile_sort(seg[r].astype(np.int64),
                                            contrib[r], kept))
        for i in range(m):
            if i == 0 or sk[i] != sk[i - 1]:
                out[sk[i]] = run_sum(sk, sv, i, m, False)
    return out


def _window(case: str):
    """``(waddr, contrib, n_valid)`` rows several tiles wide."""
    rng = np.random.default_rng(len(case) + 40)
    v, n = 7, 5 * TILE - 13           # five tiles, the last one ragged
    waddr = rng.integers(0, 30, (v, n)).astype(np.int32)
    contrib = np.where(rng.random((v, n)) < 0.7, rng.random((v, n)),
                       0.0).astype(np.float32)
    n_valid = np.array([n, 3 * TILE, 0, 1, TILE + 1, n + 5, -3], np.int32)
    if case == "subnormal":
        contrib = rng.choice(np.array(
            [2e-38, -1.5e-38, 3e-38, 1e-39, -1e-39, -2e-38, 0.5],
            np.float32), (v, n))
        waddr = rng.integers(0, 4, (v, n)).astype(np.int32)
    elif case == "one_key":
        waddr[:] = 11                     # one run over every tile edge
    elif case == "cross_tile_runs":
        # a few addresses, each in every tile, and long runs of one
        # address across each tile edge
        waddr = rng.integers(0, 5, (v, n)).astype(np.int32)
        for t in range(1, 5):
            waddr[:, t * TILE - 9:t * TILE + 9] = 100 + t
    elif case == "extreme_keys":
        waddr = rng.choice(np.array([TABLE_EMPTY - 1, TABLE_EMPTY, -1, 0,
                                     -2**31, 5], np.int32), (v, n))
    return waddr, contrib, n_valid


WINDOW_CASES = ["subnormal", "one_key", "cross_tile_runs", "extreme_keys",
                "random"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_run_sums_tiled_emulation_equals_plain_and_jax(case):
    """The tiled ``run_sums`` (five tiles, valid lengths of 0, 1, one tile
    and one entry, three tiles: an unpaired run, past the row, negative)
    == ``window_runs_plain`` == the reference's window step, bit for
    bit."""
    waddr, contrib, n_valid = _window(case)
    got = emulate_run_sums_tiled(waddr, contrib, n_valid)
    want = tpop.window_runs_plain(*map(torch.from_numpy,
                                       (waddr, contrib, n_valid)))
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(_bits(got[1]), _bits(want[1].numpy()))
    ja, jv = jax_window_runs(waddr, contrib, n_valid)
    assert np.array_equal(want[0].numpy(), ja)
    assert np.array_equal(_bits(want[1].numpy()), _bits(jv))


def _segments(case: str):
    """``(dist, served, seg, num_blocks, cs)`` rows several tiles wide,
    each row's segments its own."""
    rng = np.random.default_rng(len(case) + 50)
    v, n, per = 4, 4 * TILE + 7, 12
    seg = (rng.integers(0, per, (v, n))
           + per * np.arange(v)[:, None]).astype(np.int32)
    seg[rng.random((v, n)) < 0.2] = v * per + 2          # padding
    seg[3] = v * per                                      # an empty row
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = np.array([64, 1, 4096, 7], np.float32)
    if case == "subnormal":
        # contributions exp(-dist / cs) near and under 2**-126
        dist = rng.integers(85, 105, (v, n)).astype(np.int32)
        cs[:] = 1.0
    elif case == "one_key":
        seg[0] = 5                       # a segment over every tile edge
    elif case == "cross_tile_runs":
        for t in range(1, 4):
            seg[:3, t * TILE - 5:t * TILE + 5] = (
                per * np.arange(3)[:, None] + t)
    return dist, served, seg, v * per, cs


@pytest.mark.parametrize("case", ["subnormal", "one_key", "cross_tile_runs",
                                  "random"])
def test_popularity_tiled_emulation_equals_plain_and_jax(case):
    """The tiled ``popularity`` (four tiles and a ragged fifth, padding
    ids, an all-padding row) == ``popularity_rows_plain`` == the
    reference's ``block_scores`` of each row's contributions, bit for
    bit."""
    dist, served, seg, nb, cs = _segments(case)
    got = emulate_popularity_tiled(dist, served, seg, nb, cs)
    want = pops.popularity_rows_plain(
        *map(torch.from_numpy, (dist, served, seg)), nb,
        torch.from_numpy(cs)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    for r in range(seg.shape[0]):
        keep = seg[r] < nb
        if not keep.any():
            continue
        ja, js = jpop.block_scores(seg[r][keep], jpop.contributions(
            dist[r][keep], served[r][keep], np.float32(max(cs[r], 1.0))))
        assert np.array_equal(_bits(want[ja]), _bits(js))


def test_tiled_route_constants_are_the_kernels():
    """The emulation's merge rule is the kernels': the tile is the row
    route's limit, the run passes chunk positions by the CTA's threads."""
    text = (CSRC / "row_merge.cuh").read_text()
    assert "constexpr int kTile = kMaxRow;" in text
    assert "count_below(r + o0 * (long long)kTile, other_len," in text
    assert "pair_key(x), !left);" in text       # right run: at or below
    assert kernels.ROW_THREADS == 512


# ---------------------------------------------------------------------------
# the cleaner's radix select
# ---------------------------------------------------------------------------

DIGIT = 8            # csrc/clean_scatter.cu kDigit


def radix_cutoffs(dirty, lru, ways, quota, parts: int):
    """``clean_kernel``'s selection for every VM, its slots split into
    ``parts`` CTAs: count, least and greatest key; then 8-bit passes below
    the common prefix, the CTAs' histograms added bin by bin, the digit
    whose bin holds the rank. Returns ``(lru_cut, idx_cut, take, n_cand,
    passes)``, numpy int32 but ``passes``."""
    v, s, w = dirty.shape
    sw = s * w
    b = (sw - 1).bit_length() if sw > 1 else 0
    flat = np.arange(sw)
    out = np.zeros((4, v), np.int64)
    passes = []
    for r in range(v):
        cand = dirty[r].reshape(-1) & (flat % w < ways[r])
        keys = (((lru[r].reshape(-1).astype(np.int64) ^ -2**31)
                 & 0xFFFFFFFF) << b) | flat
        bounds = [sw * p // parts for p in range(parts + 1)]
        cta = [slice(bounds[p], bounds[p + 1]) for p in range(parts)]
        n_cand = sum(int(cand[c].sum()) for c in cta)
        take = min(int(quota[r]), n_cand)
        lc, ic, npass = -2**31, -1, 0
        if take > 0:
            lo = min(int(keys[c][cand[c]].min()) for c in cta
                     if cand[c].any())
            hi = max(int(keys[c][cand[c]].max()) for c in cta
                     if cand[c].any())
            top = (lo ^ hi).bit_length()
            prefix = lo >> top << top
            rank = take
            hi_bit = top
            while hi_bit > 0:
                lo_bit = max(hi_bit - DIGIT, 0)
                nb = 1 << (hi_bit - lo_bit)
                bins = np.zeros(nb, np.int64)
                for c in cta:
                    k = keys[c][cand[c]]
                    k = k[k >> hi_bit == prefix >> hi_bit]
                    bins += np.bincount((k >> lo_bit) & (nb - 1),
                                        minlength=nb)
                incl = np.cumsum(bins)
                d = int(np.searchsorted(incl, rank))     # first incl >= rank
                rank -= int(incl[d] - bins[d])
                prefix |= d << lo_bit
                hi_bit -= DIGIT
                npass += 1
            assert rank == 1 and (keys[cand] == prefix).sum() == 1
            lc = int(np.uint32((prefix >> b) ^ 0x80000000).view(np.int32))
            ic = prefix & ((1 << b) - 1)
        out[:, r] = (lc, ic, take, n_cand)
        passes.append(npass)
    return (*out.astype(np.int32), passes)


def _clean_state(case: str, seed: int):
    rng = np.random.default_rng(seed + len(case))
    v, s, w = 6, 16, 12
    tags = np.where(rng.random((v, s, w)) < 0.8,
                    rng.integers(0, 999, (v, s, w)), -1).astype(np.int32)
    lru = np.where(tags >= 0, rng.integers(0, 5000, (v, s, w)),
                   -1).astype(np.int32)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    ways = rng.integers(1, w + 1, v).astype(np.int32)
    quota = rng.integers(0, 12, v).astype(np.int32)
    if case == "all_clean":
        dirty[:] = False
    elif case == "lru_ties":
        lru = np.where(tags >= 0, rng.integers(0, 3, (v, s, w)),
                       -1).astype(np.int32)
        quota = rng.integers(1, 60, v).astype(np.int32)
    elif case == "ways_0":
        ways[:3] = 0
    elif case == "quota_over_candidates":
        quota = rng.integers(s * w, 2 * s * w, v).astype(np.int32)
    elif case == "extreme_lru":
        lru = rng.choice(np.array([-2**31, 2**31 - 1, -1, 0, 7],
                                  np.int32), (v, s, w))
        quota = rng.integers(0, 40, v).astype(np.int32)
    quota[0] = 0                              # take 0: the sentinel
    return dirty, lru, ways, quota


CLEAN_CASES = ["all_clean", "lru_ties", "ways_0", "quota_over_candidates",
               "extreme_lru", "random"]


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", CLEAN_CASES)
def test_clean_radix_select_equals_cutoffs_and_jax(case, parts):
    """The one-launch cleaner's selection == ``_clean_cutoffs`` of the
    port and of the JAX package (the sentinel for take 0, ties broken by
    the flat index, ways 0, quota past the candidates, lru at the int32
    edges); its flush == ``clean_scatter_plain`` at those cutoffs, and
    ``clean_select`` on the CPU returns the same seven vectors."""
    dirty, lru, ways, quota = _clean_state(case, parts)
    lc, ic, take, n_cand, passes = radix_cutoffs(dirty, lru, ways, quota,
                                                 parts)
    t = [torch.from_numpy(x) for x in (dirty, lru, ways, quota)]
    want = tops._clean_cutoffs(*t)
    jwant = jops._clean_cutoffs(*map(jnp.asarray, (dirty, lru, ways, quota)))
    for got, tw, jw in zip((lc, ic, take, n_cand), want, jwant):
        assert np.array_equal(got, tw.numpy())
        assert np.array_equal(got, np.asarray(jw))
    assert max(passes) <= 8
    sel = tops.clean_select(*t)
    flush_d, flushed = tops.clean_scatter_plain(
        t[0], t[1], t[2], torch.from_numpy(lc), torch.from_numpy(ic))
    assert torch.equal(sel[0], flush_d) and torch.equal(sel[1], flushed)
    for got, x in zip((lc, ic, take, n_cand, n_cand - take), sel[2:]):
        assert np.array_equal(got, x.numpy())
    assert np.array_equal(flushed.numpy(), np.maximum(take, 0))
    if case == "all_clean":
        assert flushed.sum() == 0
    if case in ("lru_ties", "quota_over_candidates"):
        assert flushed.sum() > 0


def test_clean_no_slots():
    """V 0 and S*W 0: no candidate, the sentinel cutoffs, nothing to
    flush (the shapes the card returns without a launch)."""
    for v, s, w in ((0, 4, 4), (3, 0, 4), (3, 4, 0)):
        dirty = torch.zeros((v, s, w), dtype=torch.bool)
        lru = torch.zeros((v, s, w), dtype=torch.int32)
        ways = torch.full((v,), w, dtype=torch.int32)
        quota = torch.full((v,), 3, dtype=torch.int32)
        out, fl, lc, ic, take, n_cand, left = tops.clean_select(
            dirty, lru, ways, quota)
        assert out.shape == (v, s, w)
        assert fl.tolist() == n_cand.tolist() == take.tolist() \
            == left.tolist() == [0] * v
        assert lc.tolist() == [tops.INT32_MIN] * v and ic.tolist() == [-1] * v


@pytest.mark.parametrize("v,s,w,want", [(12, 64, 64, (8, 256)),
                                        (1024, 16, 32, (1, 128)),
                                        (1, 256, 64, (8, 256)),
                                        (3, 1, 1, (1, 256))])
def test_clean_plan_from_shapes(v, s, w, want):
    """The cleaner's launch plan at the fused path's two shapes, L2ARC's
    one-VM state and a one-slot VM (132 SMs): up to 8 CTAs a VM while the
    VMs leave SMs idle, CTAs of 128 threads once they fill the card, and
    within the kernel's limits."""
    parts, threads = tops.clean_plan(v, s * w, 132)
    assert (parts, threads) == want
    text = (CSRC / "clean_scatter.cu").read_text()
    assert parts <= int(re.search(r"kMaxParts = (\d+);", text).group(1))
    assert threads <= int(re.search(r"kThreads = (\d+);", text).group(1))
    assert int(re.search(r"kDigit = (\d+);", text).group(1)) == DIGIT
