"""Port parity: the two-level datapath vs ``simulate_two_level_batch``.

The port's plain datapath (what it runs on CPU tensors) against the JAX
``lax.scan``: both states, all 13 Stats fields (``latency_sum``
bitwise) and ``t_end``, in ``"full"`` and ``"npe"`` modes, with
``addr = -1`` padding mid-stream, ragged per-VM ways including 0, and
the clock carried across blocks.
"""
import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim

V, N = 4, 128
WAYS_D = np.array([4, 2, 0, 3], np.int32)
WAYS_S = np.array([4, 3, 1, 0], np.int32)
T0 = np.array([0, 5, 7, 100], np.int32)


def _requests(seed, pad_frac=0.15, addr_space=24):
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, addr_space, (V, N)).astype(np.int32)
    addr[rng.random((V, N)) < pad_frac] = -1
    is_write = rng.random((V, N)) < 0.4
    return addr, is_write


def _assert_same(jout, tout, msg):
    for js, ts in zip(jout[:2], tout[:2]):
        for a, b in zip(js, ts):
            assert np.array_equal(np.asarray(a), b.numpy()), msg
    assert len(jout[2]) == len(tout[2]) == 13
    for name, a, b in zip(jsim.Stats._fields, jout[2], tout[2]):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (msg, name)
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), (msg, name)
    assert np.array_equal(np.asarray(jout[3]), tout[3].numpy()), msg


@pytest.mark.parametrize("mode", ["full", "npe"])
@pytest.mark.parametrize("seed", range(3))
def test_two_level_matches_jax(mode, seed):
    """Three chained blocks: state and clock carried from one to the next."""
    jd, js = jsim.make_cache_batch(V, 4, 4), jsim.make_cache_batch(V, 8, 4)
    td = tsim.make_cache_batch(V, 4, 4, device="cpu")
    ts = tsim.make_cache_batch(V, 8, 4, device="cpu")
    jt, tt = T0, torch.from_numpy(T0)
    for k in range(3):
        addr, is_write = _requests(10 * seed + k)
        jout = jsim.simulate_two_level_batch(addr, is_write, jd, js, WAYS_D,
                                             WAYS_S, mode=mode, t0=jt)
        tout = tsim.simulate_two_level_batch(addr, is_write, td, ts, WAYS_D,
                                             WAYS_S, mode=mode, t0=tt)
        _assert_same(jout, tout, f"{mode} block {k}")
        jd, js, _, jt = jout
        td, ts, _, tt = tout


def test_fully_padded_rows_are_noops():
    addr, is_write = _requests(3)
    addr[1] = -1
    addr[:, 100:] = -1          # padded tail on every VM
    out = tsim.simulate_two_level_batch(
        addr, is_write, tsim.make_cache_batch(V, 4, 4, device="cpu"),
        tsim.make_cache_batch(V, 4, 4, device="cpu"), WAYS_D, WAYS_S,
        mode="npe", t0=T0)
    jout = jsim.simulate_two_level_batch(
        addr, is_write, jsim.make_cache_batch(V, 4, 4),
        jsim.make_cache_batch(V, 4, 4), WAYS_D, WAYS_S, mode="npe", t0=T0)
    _assert_same(jout, out, "padded")
    empty = tsim.make_cache_batch(1, 4, 4, device="cpu")
    for a, b in zip(out[0], empty):
        assert torch.equal(a[1], b[0])
    assert all(int(f[1]) == 0 for f in out[2])
    assert int(out[3][1]) == int(T0[1])


def test_wide_sets_geometry():
    """More than 32 ways per set (the CUDA kernel strides ways over the
    warp's lanes; the plain version must agree with JAX there too)."""
    rng = np.random.default_rng(11)
    addr = rng.integers(0, 400, (2, 300)).astype(np.int32)
    is_write = rng.random((2, 300)) < 0.3
    ways = np.array([40, 64], np.int32)
    jout = jsim.simulate_two_level_batch(
        addr, is_write, jsim.make_cache_batch(2, 2, 64),
        jsim.make_cache_batch(2, 3, 64), ways, ways[::-1], mode="npe", t0=0)
    tout = tsim.simulate_two_level_batch(
        addr, is_write, tsim.make_cache_batch(2, 2, 64, device="cpu"),
        tsim.make_cache_batch(2, 3, 64, device="cpu"), ways, ways[::-1],
        mode="npe", t0=0)
    _assert_same(jout, tout, "wide")
