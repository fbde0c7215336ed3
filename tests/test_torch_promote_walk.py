"""The bucketed set walk of the ``promote_scatter`` kernel
(``src/repro_torch/csrc/promote_scatter.cu``), modelled on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py`` holds it to
its plain version there). Here its algorithm runs in Python and numpy
with the kernel's own constants, or with tiny tiles and chunks so that
the carries show: each VM's sets cut into the wrapper's ``parts``
contiguous ranges and those into chunks of staged rows; the queue read a
tile at a time and its entries of the chunk grouped by set in queue
order; each set's bucket walked 32 entries at a time (residency against
the staged row, the rounds' first occurrences, ranks over the eligible
lanes, the k-th eligible entry into the k-th free way), with placements
carried across tiles in the staged row (dedupe) or a count (no dedupe).
The model must equal ``promote_scatter_plain`` in every output.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.maintenance import ops

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/csrc/promote_scatter.cu")


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)", SOURCE.read_text())
    return int(m.group(1))


TILE = _constant("kTile")
CHUNK_SETS = _constant("kChunkSets")
STAGE_INTS = _constant("kStageInts")
ROUNDS = _constant("kRounds")
H100_SMS = 132


def test_wrapper_limits_match_the_kernel():
    assert _constant("kMaxWays") == ops.PROMOTE_MAX_WAYS
    assert _constant("kMaxParts") == ops.PROMOTE_MAX_PARTS
    assert _constant("kWarps") == ops.PROMOTE_WARPS


def walk_model(tags, lru, dirty, queue, ways, t, dedupe, parts, warps,
               tile=TILE, chunk_sets=CHUNK_SETS, stage_ints=STAGE_INTS):
    """The kernel's steps on numpy arrays; returns the four outputs. A
    chunk's sets take one pass of the CTA's threads, a tile at most
    ``ROUNDS`` rounds of 32 entries of each warp."""
    v_n, s_n, w_n = tags.shape
    q = queue.shape[1]
    out_t, out_l, out_d = tags.copy(), lru.copy(), dirty.copy()
    promoted = np.zeros(v_n, np.int32)
    chunk = min(chunk_sets, stage_ints // w_n, -(-s_n // parts), warps * 32)
    tile = min(tile, warps * 32 * ROUNDS, max(32, -(-q // 32) * 32))
    tiles = max(1, -(-q // tile))
    for v in range(v_n):
        ways_v = min(max(int(ways[v]), 0), w_n)
        for part in range(parts):
            s_lo, s_hi = s_n * part // parts, s_n * (part + 1) // parts
            for c_lo in range(s_lo, s_hi, chunk):
                nc = min(chunk, s_hi - c_lo)
                staged = tags[v, c_lo:c_lo + nc].copy()
                taken = np.zeros(nc, np.int64)
                for ti in range(tiles):
                    entries = queue[v, ti * tile:(ti + 1) * tile]
                    bucket = [[] for _ in range(nc)]
                    for a in entries:              # stable, queue order
                        if a >= 0 and 0 <= a % s_n - c_lo < nc:
                            bucket[a % s_n - c_lo].append(int(a))
                    for c in range(nc):
                        if not bucket[c]:
                            continue
                        row = staged[c]
                        live = np.arange(w_n) < ways_v
                        tg = np.where(live, row, -1)
                        free = list(np.flatnonzero(live & (row < 0)))
                        done0 = 0 if dedupe else int(taken[c])
                        done = done0
                        for b in range(0, len(bucket[c]), 32):
                            if done >= len(free):
                                break
                            batch = bucket[c][b:b + 32]
                            elig = [a not in tg for a in batch]
                            if dedupe:        # the round's first copies
                                elig = [e and not any(
                                    elig[j] and batch[j] == a
                                    for j in range(i))
                                    for i, (a, e) in enumerate(
                                        zip(batch, elig))]
                            rank = done
                            for a, e in zip(batch, elig):
                                if not e:
                                    continue
                                if rank < len(free):
                                    w = free[rank]
                                    out_t[v, c_lo + c, w] = a
                                    out_l[v, c_lo + c, w] = t[v]
                                    out_d[v, c_lo + c, w] = False
                                    if dedupe:
                                        row[w] = a
                                rank += 1
                            add = min(sum(elig), len(free) - done)
                            done += add
                            if dedupe and add:
                                tg = np.where(live, row, -1)
                        if not dedupe:
                            taken[c] = done
                        promoted[v] += done - done0
    return out_t, out_l, out_d, promoted


def _state(rng, v, s, w, fill, space):
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        for j in range(s):
            blocks = rng.permutation(space)[:w] * s + j
            keep = rng.random(w) < fill
            tags[i, j, keep] = blocks[keep]
    lru = rng.integers(0, 99, (v, s, w)).astype(np.int32)
    dirty = (rng.random((v, s, w)) < 0.5) & (tags >= 0)
    return tags, lru, dirty


def _check(tags, lru, dirty, queue, ways, t, dedupe, **kw):
    v, s, _ = tags.shape
    got = walk_model(tags, lru, dirty, queue, ways, t, dedupe,
                     *ops.promote_plan(v, s, kw.pop("sms", H100_SMS)), **kw)
    want = ops.promote_scatter_plain(
        *(torch.from_numpy(x) for x in (tags, lru, dirty, queue, ways, t)),
        dedupe=dedupe)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


CASES = {  # v, s, w, fill, q, repeats, tiny tiles and chunks
    "paper fused shape, unique": (2, 64, 64, 0.75, 4096, False, False),
    "l2arc shape": (1, 256, 64, 0.9, 512, True, False),
    "W 128": (3, 8, 128, 0.5, 700, True, False),
    "tiles of 32, chunks of 3 sets": (3, 10, 8, 0.4, 300, True, True),
    "Q not a multiple of 32": (4, 16, 8, 0.6, 45, True, True),
    "one set": (2, 1, 16, 0.3, 100, True, True),
}


@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_walk_model_equals_plain(case, dedupe):
    v, s, w, fill, q, repeats, tiny = CASES[case]
    rng = np.random.default_rng(len(case) + dedupe)
    tags, lru, dirty = _state(rng, v, s, w, fill, 4 * w)
    queue = rng.integers(0, 4 * w * s, (v, q)).astype(np.int32)
    if repeats:                    # repeats inside rounds and across tiles
        queue[:, 1::2] = queue[:, ::2][:, :q // 2]
        queue[:, q // 2:] = rng.permutation(queue.T)[:q - q // 2].T
    queue[rng.random((v, q)) < 0.1] = -1
    ways = rng.integers(0, w + 1, v).astype(np.int32)
    ways[0] = w
    t = (np.arange(v) + 500).astype(np.int32)
    kw = dict(tile=32, chunk_sets=3) if tiny else {}
    _check(tags, lru, dirty, queue, ways, t, dedupe, **kw)


@pytest.mark.parametrize("dedupe", [True, False])
def test_walk_model_edges(dedupe):
    """``ways`` 0 and W, all-``-1`` queues, every entry resident, more
    eligible entries than free ways, a repeat across a tile edge."""
    rng = np.random.default_rng(11)
    v, s, w = 5, 6, 8
    tags, lru, dirty = _state(rng, v, s, w, 0.5, 32)
    queue = rng.integers(0, 32 * s, (v, 70)).astype(np.int32)
    queue[1] = -1                                      # all padding
    res = tags[2][tags[2] >= 0]
    queue[2] = np.resize(res, 70)                      # every entry resident
    queue[3, 31], queue[3, 32] = 7 * s, 7 * s          # across the edge
    queue[4] = np.arange(70) * s                       # one set, 70 fresh
    ways = np.array([0, w, w, 5, w], np.int32)
    t = np.arange(v, dtype=np.int32) + 9
    _check(tags, lru, dirty, queue, ways, t, dedupe, tile=32, chunk_sets=4)
    _check(tags, lru, dirty, queue, ways, t, dedupe)
    _check(tags, lru, dirty, queue, ways, t, dedupe, sms=2)   # 4 warps


def test_plan_from_shapes():
    """One CTA of 4 warps a VM once the VMs fill the card; a lone VM's 256
    sets over a cluster of 8 CTAs of 16 warps; at least 16 sets a CTA."""
    assert ops.promote_plan(1024, 16, H100_SMS) == (1, 4)
    assert ops.promote_plan(1, 256, H100_SMS) == (8, 16)
    assert ops.promote_plan(12, 64, H100_SMS) == (4, 16)
    assert ops.promote_plan(4, 16, H100_SMS) == (1, 16)
    assert ops.promote_plan(128, 16, H100_SMS) == (1, 16)
