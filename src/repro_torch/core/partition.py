"""Cache-space partitioning across VMs (paper §4.3.2).

Default allocation is each VM's demand (max POD + 1 blocks). When the
summed demand exceeds physical capacity, sizes are reduced to maximize

    PPC = sum_i H(VM_i, c_i) / c_i            (paper Eq. 3)

subject to ``sum_i c_i <= C`` and ``c_i <= demand_i``. Because miss-ratio
curves are steppy, the PPC optimum parks each VM at its best knee; any
leftover capacity is then waterfilled by marginal hit gain (this is the
"ETICA increases the allocated cache to VM0 since other VMs' demand is
low" behavior of paper Fig. 15).

The knapsack DP is exact over a discretized size grid (grid must include
0 so a VM can be given no cache). The grid unit defaults to the smallest
nonzero grid step so every size maps to whole cache ways.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NEG = -1e30


def size_grid(capacity: int, points: int = 16) -> np.ndarray:
    """Ascending candidate-size grid ``0..capacity`` inclusive, with step
    ``max(capacity // points, 1)``; the ``capacity`` endpoint is always
    appended, so the partitioner can grant the whole pool even when the
    step does not divide it."""
    capacity = int(capacity)
    step = max(capacity // max(points, 1), 1)
    grid = np.arange(0, capacity + 1, step, dtype=np.int64)
    if grid.size == 0 or grid[-1] != capacity:
        grid = np.append(grid, np.int64(capacity))
    return grid


@dataclasses.dataclass
class PartitionResult:
    alloc: np.ndarray       # int64 [V] blocks
    ppc: float              # achieved PPC objective (nan when unsaturated)
    saturated: bool         # demand exceeded capacity


def partition(demands: np.ndarray, hit_curves: np.ndarray, sizes: np.ndarray,
              capacity: int, unit: int | None = None) -> PartitionResult:
    """Allocate ``capacity`` blocks across VMs.

    Args:
      demands:    [V] demand (max POD + 1) per VM, blocks.
      hit_curves: [V, G] hit ratio of each VM at each grid size.
      sizes:      [G] ascending grid of candidate sizes (blocks), incl. 0.
      capacity:   total blocks available at this cache level.
      unit:       DP quantization (default: smallest nonzero grid step).
    """
    demands = np.asarray(demands, np.int64)
    sizes = np.asarray(sizes, np.int64)
    V, G = hit_curves.shape
    assert sizes.shape == (G,)

    if demands.sum() <= capacity:
        return PartitionResult(demands.copy(), float("nan"), False)

    if unit is None:
        steps = np.diff(np.unique(sizes))
        unit = int(steps.min()) if steps.size else 1
    cap_u = int(capacity // unit)
    size_u = (sizes // unit).astype(np.int64)

    # PPC term per (vm, grid point); infeasible above demand; 0 at c=0.
    with np.errstate(divide="ignore", invalid="ignore"):
        ppc = np.where(sizes[None, :] > 0,
                       hit_curves / np.maximum(sizes, 1)[None, :], 0.0)
    ppc = np.where(sizes[None, :] <= np.maximum(demands, 0)[:, None], ppc, NEG)
    ppc[:, sizes == 0] = 0.0

    # layered knapsack DP: layers[v][c] = best PPC of first v VMs using
    # exactly c units (0-size option keeps every layer reachable).
    layer = np.full(cap_u + 1, NEG)
    layer[0] = 0.0
    layers = [layer]
    for v in range(V):
        nxt = np.full(cap_u + 1, NEG)
        for g in range(G):
            s = int(size_u[g])
            if s > cap_u or ppc[v, g] <= NEG / 2:
                continue
            cand = np.full(cap_u + 1, NEG)
            cand[s:] = layers[-1][: cap_u + 1 - s] + ppc[v, g]
            nxt = np.maximum(nxt, cand)
        layers.append(nxt)

    # backtrack from the best final budget
    c = int(np.argmax(layers[-1]))
    best = layers[-1][c]
    alloc = np.zeros(V, np.int64)
    for v in range(V - 1, -1, -1):
        for g in range(G):
            s = int(size_u[g])
            if s > c or ppc[v, g] <= NEG / 2:
                continue
            prev = layers[v][c - s]
            if prev > NEG / 2 and abs(prev + ppc[v, g] - best) <= 1e-12 + 1e-9 * abs(best):
                alloc[v] = sizes[g]
                c -= s
                best = prev
                break

    # waterfill leftover capacity by marginal hit gain per block
    left = capacity - int(alloc.sum())
    if left > 0:
        alloc = _waterfill(alloc, demands, hit_curves, sizes, left, unit)

    return PartitionResult(alloc, _ppc_value(alloc, hit_curves, sizes), True)


def _interp_hit(hit_curve: np.ndarray, sizes: np.ndarray, c: float) -> float:
    return float(np.interp(c, sizes, hit_curve))


def _ppc_value(alloc, hit_curves, sizes) -> float:
    v = 0.0
    for i, c in enumerate(alloc):
        if c > 0:
            v += _interp_hit(hit_curves[i], sizes, c) / c
    return v


def _waterfill(alloc, demands, hit_curves, sizes, left, unit):
    alloc = alloc.copy()
    while left >= unit:
        gains = np.full(len(alloc), -np.inf)
        for i in range(len(alloc)):
            if alloc[i] + unit > demands[i]:
                continue
            h0 = _interp_hit(hit_curves[i], sizes, alloc[i])
            h1 = _interp_hit(hit_curves[i], sizes, alloc[i] + unit)
            gains[i] = h1 - h0
        best = int(np.argmax(gains))
        if not np.isfinite(gains[best]) or gains[best] <= 0:
            # no VM benefits; still spread capacity up to demand
            under = np.nonzero(alloc < demands)[0]
            if under.size == 0:
                break
            best = int(under[np.argmax(demands[under] - alloc[under])])
        alloc[best] += unit
        left -= unit
    return alloc
