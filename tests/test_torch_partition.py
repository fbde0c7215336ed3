"""Port parity: PPC partitioning (``repro_torch.core.partition``) vs the
JAX package's ``repro.core.partition``, on the CPU.

Both are numpy. The sweep draws demands as
``tests/test_partition_popularity.py``'s property test does (seeded, on
its grid and hit curves), and the allocations, the PPC value and the
saturated flag must be identical. The sweep includes the two inputs on
which the reference's waterfill hands a VM more than its demand
(ROADMAP Queue 3): the port copies that behaviour as it is.
"""
import numpy as np
import pytest

from repro.core.partition import partition as jax_partition
from repro.core.partition import size_grid as jax_size_grid

from repro_torch.core.partition import partition, size_grid

GRID = np.array([0, 16, 32, 64, 128, 256], np.int64)
OVERSHOOTS = ((3, 304, 2, [208, 64, 32], [214, 66, 27]),
              (2, 368, 5, [160, 208], [171, 206]))


def _curves(v, grid):
    """tests/test_partition_popularity.py's ``_mk_curves``."""
    rng = np.random.default_rng(v)
    raw = np.sort(rng.random((v, grid.size)), axis=1)
    raw[:, 0] = 0.0
    return raw


def _same(got, want):
    np.testing.assert_array_equal(got.alloc, want.alloc)
    assert got.alloc.dtype == want.alloc.dtype
    assert got.saturated == want.saturated
    assert got.ppc == want.ppc or (np.isnan(got.ppc) and np.isnan(want.ppc))


def _pair(v, cap, seed, grid=GRID):
    d = np.random.default_rng(seed).integers(0, 256, v)
    curves = _curves(v, grid)
    return (partition(d, curves, grid, cap),
            jax_partition(d, curves, grid, cap), d)


@pytest.mark.parametrize("v", range(1, 7))
def test_partition_matches_jax(v):
    """Every seed 0..10 at 40 capacities in 1..500 (seeded), and the
    capacities of the two falsifying inputs."""
    caps = np.random.default_rng(100 + v).integers(1, 501, 40).tolist()
    for seed in range(11):
        for cap in caps + [304, 368]:
            got, want, _ = _pair(v, cap, seed)
            _same(got, want)


@pytest.mark.parametrize("v,cap,seed,alloc,demand", OVERSHOOTS)
def test_partition_copies_the_reference_overshoot(v, cap, seed, alloc,
                                                  demand):
    """The reference's fallback branch overshoots a demand on these
    inputs; the port gives the same allocation."""
    got, want, d = _pair(v, cap, seed)
    _same(got, want)
    assert d.tolist() == demand and got.alloc.tolist() == alloc
    assert (got.alloc > d).any()


@pytest.mark.parametrize("capacity", [64, 1000, 8192, 16384])
def test_partition_matches_jax_on_the_size_grid(capacity):
    """The controller's own grid (``size_grid``) and 12 VMs, as sizing
    calls it, over and under capacity."""
    grid = size_grid(capacity)
    np.testing.assert_array_equal(grid, jax_size_grid(capacity))
    rng = np.random.default_rng(capacity)
    for _ in range(5):
        d = rng.integers(0, capacity // 4 + 2, 12)
        curves = _curves(12, grid)
        _same(partition(d, curves, grid, capacity),
              jax_partition(d, curves, grid, capacity))
