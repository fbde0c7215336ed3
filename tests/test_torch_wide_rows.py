"""The tiled route of ``popularity`` and ``run_sums`` (rows wider than
``kernels.ROW_MAX``, ``src/repro_torch/csrc/row_radix.cuh``) and the
cleaner's one-launch radix select (``csrc/clean_scatter.cu``), emulated
step for step on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them
to their plain versions there). Here their algorithms run in numpy, at
the kernels' constants or at small ones (tiles of 64 positions, 4-bit
digits, a staging ring of 16): the prep (pairs at their positions, each
pass's digit histogram, the row's length and kept count); each LSD pass
(a pass whose digit is constant over a row's keys skipped for that row,
the buffer of each row's result from the parity of its active passes;
tiles taken in ticket order and stepped in a random interleaving; a
warp ranks its items 32-position slice by slice, the warps' counts
scanned digit by digit; each digit's decoupled look-back reads a window
of earlier tiles' status words, stops at a word not yet published and
reads it again later; the scatter to the histogram's base + the earlier
tiles' count + the rank); then the run pass (heads, run_sums' slots by a
look-back over the tiles' head counts, short runs added by their head's
thread, longer ones staged a chunk at a time for one lane's adds). The
emulations are held bit for bit to the plain versions and, through
them, to the JAX package: ``window_runs_plain`` to the reference's
stable argsort + ``_compact_runs``, ``popularity_rows_plain`` to
``block_scores`` of each row. The cleaner's emulation (count, least and
greatest key, 8-bit passes over per-CTA histograms summed across the
cluster) is held to ``_clean_cutoffs`` of both packages and to the flush
of ``clean_scatter_plain``.
"""
import dataclasses
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

from test_torch_row_sort import TABLE_EMPTY, _bits, _flush, jax_window_runs

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
AGG, INC = 1 << 30, 2 << 30          # look-back flags (kFlagAggregate, ...)
MASK = AGG - 1


@dataclasses.dataclass(frozen=True)
class Radix:
    """The tiled route's constants (``csrc/row_radix.cuh``): warps a CTA,
    lanes a warp, positions a thread a tile, bits a digit, status words a
    look-back step, the longest run a head's thread adds, pairs a lane
    stages a chunk."""
    warps: int
    lanes: int
    items: int
    digit: int
    look_back: int
    long_run: int
    stage_per: int

    @property
    def threads(self):
        return self.warps * self.lanes

    @property
    def tile(self):
        return self.threads * self.items

    @property
    def radix(self):
        return 1 << self.digit

    @property
    def stage(self):
        return self.lanes * self.stage_per

    def passes(self, bits: int) -> int:
        return max(1, -(-bits // self.digit))


KERNEL = Radix(8, 32, 2, 8, 16, 32, 16)      # the kernels' own
SMALL = Radix(4, 8, 2, 4, 3, 6, 2)           # tiles of 64, 4-bit digits
TILE = SMALL.tile


def _steps(rng, tickets: list, step) -> None:
    """Runs ``step(ticket)`` (True once the ticket's CTA is done) for
    every ticket, the CTAs started in ticket order and stepped in a
    random interleaving, as the card may run them."""
    live, nxt = [], 0
    while nxt < len(tickets) or live:
        if nxt < len(tickets) and (not live or rng.random() < 0.5):
            live.append(tickets[nxt])
            nxt += 1
            continue
        t = live[int(rng.integers(len(live)))]
        if step(t):
            live.remove(t)


def _look_step(words: np.ndarray, window: int) -> tuple:
    """One look-back step over ``words[k]`` (``[window, columns]``, the
    nearest earlier tile first): each column adds its words up to the
    first inclusive one and stops before a word not yet published.
    Returns ``(added, words used, done)``, each per column."""
    ready = words != 0
    inc = (words & INC) != 0
    k = np.arange(window)[:, None]
    first_gap = np.where(ready.all(0), window, np.argmin(ready, 0))
    first_inc = np.where(inc.any(0), np.argmax(inc, 0), window)
    done = first_inc < first_gap
    used = np.where(done, first_inc + 1, first_gap)
    added = np.where(k < used, words & MASK, 0).sum(0)
    return added, used, done


def warp_rank(dig: np.ndarray, valid: np.ndarray, cfg: Radix):
    """``radix_pass_kernel``'s ranking of one tile: positions ``warp *
    lanes * items + k * lanes + lane``; each warp ranks slice k among its
    lanes of the same digit (``__match_any_sync``) after its counts of
    the earlier slices, then the warps' counts are scanned digit by digit.
    Returns ``(rank in the tile among the digit's pairs, the tile's digit
    counts)``."""
    w, k, lanes = cfg.warps, cfg.items, cfg.lanes
    d = dig.reshape(w, k, lanes)
    ok = valid.reshape(w, k, lanes)
    rank = np.zeros((w, k, lanes), np.int64)
    wcount = np.zeros((w, cfg.radix), np.int64)
    lower = np.tril(np.ones((lanes, lanes), bool), -1)
    for warp in range(w):
        for item in range(k):
            dd, oo = d[warp, item], ok[warp, item]
            peers = (dd[:, None] == dd[None, :]) & oo[None, :] & lower
            had = wcount[warp, np.minimum(dd, cfg.radix - 1)]
            rank[warp, item] = np.where(oo, had + peers.sum(1), 0)
            wcount[warp] += np.bincount(dd[oo], minlength=cfg.radix)
    excl = np.cumsum(wcount, 0) - wcount
    rank = rank + np.where(ok, excl[np.arange(w)[:, None, None],
                                    np.minimum(d, cfg.radix - 1)], 0)
    return rank.reshape(-1), wcount.sum(0)


def radix_sort(keys, vals, lens, passes: int, cfg: Radix, rng):
    """The prep and the LSD passes over ``[V, n]`` rows (``keys`` unsigned
    32-bit in int64, the first ``lens[v]`` of each row sorted). Returns
    ``(buffers' keys [2, V, n], values, each row's buffer, active passes
    [V, passes], histograms)``. Slots never written hold garbage."""
    v, n = keys.shape
    tiles = -(-n // cfg.tile)
    bk = np.full((2, v, n), 0xDEAD, np.int64)
    bv = np.full((2, v, n), np.nan, np.float32)
    hist = np.zeros((v, passes, cfg.radix), np.int64)
    for r in range(v):
        m = lens[r]
        bk[0, r, :m], bv[0, r, :m] = keys[r, :m], vals[r, :m]
        for q in range(passes):
            hist[r, q] = np.bincount(keys[r, :m] >> (q * cfg.digit)
                                     & (cfg.radix - 1), minlength=cfg.radix)
    active = ~(hist == lens[:, None, None]).any(2)
    for p in range(passes):
        status = np.zeros((v, tiles, cfg.radix), np.int64)
        state = {}

        def step(t, p=p, status=status, state=state):
            r, tile = divmod(t, tiles)
            m = lens[r]
            if tile * cfg.tile >= m or not active[r, p]:
                return True                        # the CTA leaves at once
            src = active[r, :p].sum() & 1
            if t not in state:                     # rank, publish
                pos = tile * cfg.tile + np.arange(cfg.tile)
                ok = pos < m
                key = np.where(ok, bk[src, r, np.minimum(pos, n - 1)], 0)
                dig = np.where(ok, key >> (p * cfg.digit) & (cfg.radix - 1),
                               cfg.radix + np.arange(cfg.tile) % cfg.lanes)
                rank, cnt = warp_rank(dig, ok, cfg)
                status[r, tile] = (INC if tile == 0 else AGG) | cnt
                state[t] = dict(pos=pos, ok=ok, dig=dig, rank=rank, cnt=cnt,
                                excl=np.zeros(cfg.radix, np.int64),
                                j=np.full(cfg.radix, tile - 1),
                                done=np.full(cfg.radix, tile == 0))
                return False
            s = state[t]
            if not s["done"].all():                # one look-back step
                k = np.arange(cfg.look_back)[:, None]
                jj = s["j"][None, :] - k
                words = np.where(jj >= 0, status[r, np.maximum(jj, 0),
                                                 np.arange(cfg.radix)], INC)
                added, used, done = _look_step(words, cfg.look_back)
                live = ~s["done"]
                s["excl"] += np.where(live, added, 0)
                s["j"] -= np.where(live & ~done, used, 0)
                fin = live & done
                status[r, tile, fin] = INC | (s["excl"] + s["cnt"])[fin]
                s["done"] |= fin
                return False
            base = np.cumsum(hist[r, p]) - hist[r, p]
            ok = s["ok"]
            dig = s["dig"][ok]
            d = base[dig] + s["excl"][dig] + s["rank"][ok]
            assert d.max(initial=-1) < m and np.unique(d).size == d.size
            bk[src ^ 1, r, d] = bk[src, r, s["pos"][ok]]
            bv[src ^ 1, r, d] = bv[src, r, s["pos"][ok]]
            return True
        _steps(rng, list(range(v * tiles)), step)
    parity = active.sum(1) & 1
    return bk, bv, parity, active, hist


def _add(acc, v, flush):
    acc = np.float32(acc + v)
    return _flush(acc) if flush else acc


def short_run_sum(pk, pv, i, lim, key, flush, cfg: Radix):
    """``short_run_sum``: the run's length from the pairs before ``lim``,
    then ``long_run`` adds from i, the pair's value within the run and
    -0.0 past it (every float's identity, chosen off the chain)."""
    length = 0
    while length < lim - i and pk[i + length] == key:
        length += 1
    acc = np.float32(0.0)
    for u in range(cfg.long_run):
        acc = _add(acc, pv[i + u] if u < length else np.float32(-0.0), flush)
    return acc


def warp_run_sum(pk, pv, lo, m, key, cfg: Radix, flush):
    """``warp_run_sum``: chunks of ``stage`` pairs from ``lo``; the run
    holds a prefix of each chunk (counted by ballots), its values staged
    and added by lane 0 in order; a full chunk goes on. Returns ``(sum,
    chunks)``."""
    acc, j, chunks = np.float32(0.0), lo, 0
    while True:
        idx = j + np.arange(cfg.stage)
        inside = idx < m
        match = inside & (pk[np.minimum(idx, pk.size - 1)] == key)
        cnt = int(match.sum())
        assert match[:cnt].all()                      # a prefix
        ring = pv[np.minimum(idx, pv.size - 1)]
        for u in range(cnt):
            acc = _add(acc, ring[u], flush)
        chunks += 1
        if cnt < cfg.stage:
            return acc, chunks
        j += cfg.stage


def run_pass(pk_rows, pv_rows, kept, cfg: Radix, rng, flush, slots: bool):
    """The run kernels over each row's sorted pairs (its first
    ``kept[r]``): ``[(row, key, slot, sum)]`` for every run, and the most
    chunks a warp staged for one run. With ``slots``, each head's slot is
    the heads before its tile (a look-back over the tiles' head counts, a
    warp's lanes reading ``lanes`` words a step) plus its rank in the
    tile, in the kernel's position order ``k * threads + thread``."""
    v, n = pk_rows.shape
    tiles = -(-n // cfg.tile)
    out, most = [], 0
    status = np.zeros((v, tiles), np.int64)
    state = {}

    def step(t):
        nonlocal most
        r, tile = divmod(t, tiles)
        m = kept[r]
        if tile * cfg.tile >= m:
            return True
        pk, pv = pk_rows[r], pv_rows[r]
        if t not in state:
            i = tile * cfg.tile + np.arange(cfg.tile)
            ok = i < m
            prev = pk[np.clip(i - 1, 0, n - 1)]
            head = ok & ((i == 0) | (pk[np.minimum(i, n - 1)] != prev))
            rank = np.cumsum(head) - head
            cnt = int(head.sum())
            status[r, tile] = (INC if tile == 0 else AGG) | cnt
            state[t] = dict(i=i[head], rank=rank[head], cnt=cnt, excl=0,
                            j=tile - 1, done=tile == 0 or not slots)
            return False
        s = state[t]
        if not s["done"]:
            jj = s["j"] - np.arange(cfg.lanes)
            words = np.where(jj >= 0, status[r, np.maximum(jj, 0)], INC)
            added, used, done = _look_step(words[:, None], cfg.lanes)
            if done[0] or used[0] == cfg.lanes:  # else all read again
                s["excl"] += int(added[0])
                s["j"] -= cfg.lanes
            if done[0]:
                status[r, tile] = INC | (s["excl"] + s["cnt"])
                s["done"] = True
            return False
        queue = []
        for i, rk in zip(s["i"], s["rank"]):
            key = pk[i]
            if i + cfg.long_run < m and pk[i + cfg.long_run] == key:
                queue.append((i, rk))
                continue
            out.append((r, key, s["excl"] + rk, short_run_sum(
                pk, pv, i, min(i + cfg.long_run, m), key, flush, cfg)))
        rng.shuffle(queue)                       # atomicAdd's order
        for i, rk in queue:
            acc, chunks = warp_run_sum(pk, pv, i, m, pk[i], cfg, flush)
            most = max(most, chunks)
            out.append((r, pk[i], s["excl"] + rk, acc))
        return True
    _steps(rng, list(range(v * tiles)), step)
    return out, most


def emulate_run_sums_tiled(wa, wc, n_valid, cfg: Radix = SMALL, seed=0):
    """The ``run_sums`` tiled route: returns ``(uaddr, uval, info)``,
    ``info`` the active passes, the histograms and the most chunks one
    run took."""
    rng = np.random.default_rng(seed)
    v, n = wa.shape
    lens = np.clip(n_valid.astype(np.int64), 0, n)
    keys = (wa.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000   # signed_key
    vals = np.array([[_flush(x) for x in row] for row in wc], np.float32)
    passes = cfg.passes(32)
    bk, bv, parity, active, hist = radix_sort(keys, vals, lens, passes, cfg,
                                              rng)
    rows = np.arange(v)
    runs, most = run_pass(bk[parity, rows], bv[parity, rows], lens, cfg, rng,
                          True, True)
    uaddr = np.full((v, n), TABLE_EMPTY, np.int64)     # the prep's fill
    uval = np.zeros((v, n), np.float32)
    for r, key, slot, acc in runs:
        addr = int(key ^ 0x80000000) - (1 << 32 if key < 0x80000000 else 0)
        uaddr[r, slot] = addr
        uval[r, slot] = 0.0 if addr == TABLE_EMPTY else acc
    return uaddr.astype(np.int32), uval, dict(active=active, hist=hist,
                                              chunks=most)


def emulate_popularity_tiled(dist, served, seg, num_blocks, cs,
                             cfg: Radix = SMALL, seed=0):
    """The ``popularity`` tiled route: padding (ids outside ``[0,
    num_blocks)``) keyed ``num_blocks``, after every segment; every
    position sorted; each segment's score added without a flush. Returns
    ``(scores, info)``."""
    rng = np.random.default_rng(seed)
    v, n = seg.shape
    contrib = tpop.contributions(torch.from_numpy(dist),
                                 torch.from_numpy(served),
                                 torch.from_numpy(cs)[:, None]).numpy()
    s = seg.astype(np.int64) & 0xFFFFFFFF                   # unsigned
    keep = s < num_blocks
    keys = np.where(keep, s, num_blocks)
    vals = np.where(keep, contrib, 0.0).astype(np.float32)
    passes = cfg.passes(int(num_blocks).bit_length())
    lens = np.full(v, n, np.int64)
    bk, bv, parity, active, hist = radix_sort(keys, vals, lens, passes, cfg,
                                              rng)
    rows = np.arange(v)
    runs, most = run_pass(bk[parity, rows], bv[parity, rows],
                          keep.sum(1), cfg, rng, False, False)
    out = np.zeros(num_blocks, np.float32)
    for _, key, _, acc in runs:
        out[key] = acc
    return out, dict(active=active, hist=hist, chunks=most, passes=passes)


LONG = 3 * SMALL.stage + 5           # a run over three chunks and a part


def _window(case: str):
    """``(waddr, contrib, n_valid, cfg)`` rows several tiles wide."""
    rng = np.random.default_rng(len(case) + 40)
    v, n = 7, 5 * TILE - 13           # five tiles, the last one ragged
    waddr = rng.integers(0, 30, (v, n)).astype(np.int32)
    contrib = np.where(rng.random((v, n)) < 0.7, rng.random((v, n)),
                       0.0).astype(np.float32)
    n_valid = np.array([n, 3 * TILE, 0, 1, TILE + 1, n + 5, -3], np.int32)
    cfg = SMALL
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
    elif case == "digit_boundary":
        # neighbours whose differing bits cross each 4-bit and 8-bit digit
        # edge, the sign bit's among them (-1 and 0 differ in every bit)
        edges = [(1 << b) - 1 for b in range(4, 32, 4)]
        waddr = rng.choice(np.array(edges + [e + 1 for e in edges]
                                    + [-1, 0], np.int64).astype(np.int32),
                           (v, n))
    elif case == "one_key_rows":
        waddr[:] = (np.arange(v) * 7919 - 3)[:, None]   # a key a row
    elif case == "long_run":
        # one run of LONG entries, spread over every tile in access order,
        # that starts in the middle of a tile and of a staging chunk when
        # sorted: TILE // 2 + 3 distinct smaller addresses, distinct
        # larger ones after it
        for r in range(v):
            pos = rng.permutation(n)
            waddr[r, pos[:LONG]] = 9
            waddr[r, pos[LONG:LONG + TILE // 2 + 3]] = -np.arange(
                1, TILE // 2 + 4)
            waddr[r, pos[LONG + TILE // 2 + 3:]] = 100 + np.arange(
                n - LONG - TILE // 2 - 3)
        n_valid[:] = n
    elif case == "serving_padded":
        # serving's window: padded past ROW_MAX, every valid prefix under
        # it, session-like ids; the kernels' own constants
        v, n, cfg = 4, 2 * kernels.ROW_MAX, KERNEL
        waddr = rng.integers(0, 1700, (v, n)).astype(np.int32)
        contrib = rng.random((v, n)).astype(np.float32)
        n_valid = np.array([4981, 0, kernels.ROW_MAX, 5529], np.int32)
    return waddr, contrib, n_valid, cfg


WINDOW_CASES = ["subnormal", "one_key", "cross_tile_runs", "extreme_keys",
                "random", "digit_boundary", "one_key_rows", "long_run",
                "serving_padded"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_run_sums_tiled_emulation_equals_plain_and_jax(case):
    """The tiled ``run_sums`` (five tiles, valid lengths of 0, 1, one tile
    and one entry, three tiles, past the row, negative; or serving's
    padded window) == ``window_runs_plain`` == the reference's window
    step, bit for bit; and each case moves the passes it should: keys
    across every digit edge move every pass, a row of one key moves
    none, a long run is staged over several chunks."""
    waddr, contrib, n_valid, cfg = _window(case)
    got = emulate_run_sums_tiled(waddr, contrib, n_valid, cfg)
    want = tpop.window_runs_plain(*map(torch.from_numpy,
                                       (waddr, contrib, n_valid)))
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(_bits(got[1]), _bits(want[1].numpy()))
    ja, jv = jax_window_runs(waddr, contrib, n_valid)
    assert np.array_equal(want[0].numpy(), ja)
    assert np.array_equal(_bits(want[1].numpy()), _bits(jv))
    info = got[2]
    if case == "digit_boundary":
        assert info["active"][0].all()
    if case in ("one_key", "one_key_rows"):
        assert not info["active"].any()
    if case == "long_run":
        assert info["chunks"] == 4
    if case == "serving_padded":
        assert info["active"][:, :2].any() and not info["active"][:, 2:].any()


def _segments(case: str):
    """``(dist, served, seg, num_blocks, cs, cfg)`` rows several tiles
    wide, each row's segments its own."""
    rng = np.random.default_rng(len(case) + 50)
    v, n, per = 4, 4 * TILE + 7, 12
    seg = (rng.integers(0, per, (v, n))
           + per * np.arange(v)[:, None]).astype(np.int32)
    seg[rng.random((v, n)) < 0.2] = v * per + 2          # padding
    seg[3] = v * per                                      # an empty row
    nb = v * per
    dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
    served = rng.random((v, n)) < 0.7
    cs = np.array([64, 1, 4096, 7], np.float32)
    cfg = SMALL
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
    elif case == "digit_boundary":
        # segments on both sides of each 4-bit digit edge, padding -1
        nb = 4097
        seg[:] = nb                                      # padding rows
        seg[0] = rng.choice(np.array([15, 16, 255, 256, 4095, 4096, nb,
                                      2**31 - 1], np.int32), n)
    elif case == "one_key_rows":
        seg[:3] = (np.arange(3) * 5 + 1)[:, None]        # a segment a row
    elif case == "third_pass":
        # num_blocks past 2**16: 8-bit digits take a third pass, each
        # row's segments across 65,536; four tiles of the kernels' 512
        n, nb, cfg = 3 * KERNEL.tile + 100, 74_000, KERNEL
        seg = (rng.integers(60_000, 63_000, (v, n))
               + 3_400 * np.arange(v)[:, None]).astype(np.int32)
        seg[rng.random((v, n)) < 0.2] = nb
        dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
        served = rng.random((v, n)) < 0.7
    elif case == "long_run":
        # as run_sums' case: one segment of LONG accesses a row, from the
        # middle of a tile and of a chunk, among segments of one access
        seg[:] = nb + 1
        for r in range(3):
            pos = rng.permutation(n)
            seg[r, pos[:LONG]] = per * r + 7
            seg[r, pos[LONG:LONG + TILE // 2 + 3]] = per * r + 1
            seg[r, pos[LONG + TILE // 2 + 3:LONG + TILE]] = per * r + 9
    elif case == "serving_padded":
        v, n, cfg = 4, 2 * kernels.ROW_MAX, KERNEL
        lens = [4981, 0, kernels.ROW_MAX, 5529]
        addr = rng.integers(0, 1700, (v, n))
        key = np.where(np.arange(n)[None, :] < np.array(lens)[:, None],
                       np.arange(v)[:, None] * 2**31 + addr, 2**62)
        uniq, inv = np.unique(key, return_inverse=True)
        seg = inv.reshape(v, n).astype(np.int32)
        nb = int((uniq < 2**62).sum())
        dist = rng.integers(-1, 400, (v, n)).astype(np.int32)
        served = rng.random((v, n)) < 0.7
    return dist, served, seg, nb, cs, cfg


POPULARITY_CASES = ["subnormal", "one_key", "cross_tile_runs", "random",
                    "digit_boundary", "one_key_rows", "third_pass",
                    "long_run", "serving_padded"]


@pytest.mark.parametrize("case", POPULARITY_CASES)
def test_popularity_tiled_emulation_equals_plain_and_jax(case):
    """The tiled ``popularity`` (four tiles and a ragged fifth, padding
    ids, an all-padding row; or the kernels' tiles at num_blocks past
    2**16 and at serving's padded window) == ``popularity_rows_plain``
    == the reference's ``block_scores`` of each row's contributions, bit
    for bit, with the passes each case should move."""
    dist, served, seg, nb, cs, cfg = _segments(case)
    got, info = emulate_popularity_tiled(dist, served, seg, nb, cs, cfg)
    want = pops.popularity_rows_plain(
        *map(torch.from_numpy, (dist, served, seg)), nb,
        torch.from_numpy(cs)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    for r in range(seg.shape[0]):
        keep = (seg[r] >= 0) & (seg[r] < nb)
        if not keep.any():
            continue
        ja, js = jpop.block_scores(seg[r][keep], jpop.contributions(
            dist[r][keep], served[r][keep], np.float32(max(cs[r], 1.0))))
        assert np.array_equal(_bits(want[ja]), _bits(js))
    assert info["passes"] == cfg.passes(nb.bit_length())
    if case == "digit_boundary":
        assert info["passes"] == 4 and info["active"][0].all()
    if case == "third_pass":
        # rows 2 and 3 keep only segments past 65,536: their third digit
        # is constant and the pass does nothing for them
        assert info["passes"] == 3 and info["active"][:2, 2].all()
        assert not info["active"][2:, 2].any()
    if case == "one_key_rows":
        # a row of one segment and its padding still sorts; the row of
        # padding alone moves nothing
        assert not info["active"][3].any()
    if case == "long_run":
        assert info["chunks"] == 4


def test_tiled_route_constants_are_the_kernels():
    """The emulation's ``KERNEL`` constants are ``row_radix.cuh``'s, the
    Python scratch and pass count are the header's formulas, and the two
    route entry points take the scratch the wrappers allocate."""
    text = (CSRC / "row_radix.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("kRadixThreads") == KERNEL.threads
    assert const("kRadixItems") == KERNEL.items
    assert const("kDigitBits") == KERNEL.digit == kernels.RADIX_DIGIT_BITS
    assert const("kLookBack") == KERNEL.look_back
    assert const("kLongRun") == KERNEL.long_run
    assert const("kStagePer") == KERNEL.stage_per
    assert KERNEL.tile == kernels.RADIX_TILE == 512
    assert "constexpr int kMaxPasses = 32 / kDigitBits;" in text
    assert 32 // KERNEL.digit == kernels.RADIX_MAX_PASSES
    assert ("return (long long)rows * (kMaxPasses * kRadix + 2) + kMaxPasses "
            "+ 1 +\n         tiles * (passes * kRadix + 1);") in text
    for v, n, p in ((3, 40_000, 4), (12, 32_768, 2), (1, 16_385, 1)):
        tiles = v * -(-n // 512)
        assert kernels.radix_words(v, n, p) == (
            v * (4 * 256 + 2) + 4 + 1 + tiles * (p * 256 + 1))
    for nb, want in ((1, 1), (255, 1), (256, 2), (65_535, 2), (65_536, 3),
                     (70_000, 3), (2**24, 4)):
        assert kernels.radix_passes(nb.bit_length()) == want \
            == KERNEL.passes(nb.bit_length())
    for src, fn in (("run_sums.cu", "etica_run_sums_tiled"),
                    ("popularity.cu", "etica_popularity_tiled")):
        body = (CSRC / src).read_text()
        assert "unsigned long long* buf1, int* words" in \
            body[body.index(fn):]
    assert not (CSRC / "row_merge.cuh").exists()


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
