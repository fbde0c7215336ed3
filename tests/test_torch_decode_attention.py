"""Port parity: paged decode attention vs ``repro.kernels.decode_attention``.

The port's plain version (the path of CPU tensors) against the JAX
Pallas kernel, run in interpret mode as ``tests/test_kernels.py`` runs
it, and against the JAX oracle ``paged_decode_ref``, on the same numpy
inputs: the three shapes of ``test_kernels.py``, a GQA case (4 query
heads per KV head, head_dim 128), poisoned tokens past the length, a
``length == 0`` row, page ids outside the pool, and bf16 pages. Tolerance: float32 outputs within
``atol=2e-5`` (the JAX test's own); bf16 outputs within one bf16 ulp of
the value, or 2e-5 where that ulp is finer (a sum that cancels to near
zero carries the float32 rounding of its terms, not of itself).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import (
    paged_decode_attention as jax_kernel)
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import paged_decode_ref

from repro_torch.kernels.decode_attention import ops

ATOL = 2e-5


def _inputs(seed, b, h, hkv, d, pool, ps, n_pages, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(pool, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(pool, ps, hkv, d)).astype(np.float32)
    pt = rng.integers(0, pool, (b, n_pages)).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, n_pages * ps + 1, b)
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


def _port(*arrays):
    return ops.paged_decode_attention(*map(torch.from_numpy, arrays))


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bf16_close(got, want):
    """Within one bf16 ulp of ``want`` (or ATOL where that is finer)."""
    got, want = _as_f32(got), _as_f32(want)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= np.maximum(ulp, ATOL))


@pytest.mark.parametrize("b,h,hkv,d,pool,ps,n_pages", [
    (2, 4, 2, 64, 16, 32, 4), (3, 8, 4, 128, 32, 16, 8),
    (1, 2, 2, 32, 8, 64, 2),                 # tests/test_kernels.py
    (2, 16, 4, 128, 24, 16, 6)])             # GQA: 4 heads per KV head
def test_plain_matches_jax_kernel_and_ref(b, h, hkv, d, pool, ps, n_pages):
    args = _inputs(b + h + d, b, h, hkv, d, pool, ps, n_pages)
    got = _port(*args).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kernel(*args)), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(paged_decode_ref(*args)),
                               atol=ATOL)


def test_tokens_past_the_length_are_masked():
    """Poisoning every token past each length changes nothing; the port
    equals the JAX kernel on the poisoned pool."""
    q, kp, vp, pt, _ = _inputs(9, 2, 4, 2, 32, 6, 16, 3)
    pt = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    lengths = np.array([20, 41], np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1, 4:], vp2[1, 4:] = 999.0, 999.0          # row 0: tokens 20..31
    kp2[2], vp2[2] = 999.0, 999.0                   # row 0: page 2 unused
    kp2[5, 9:], vp2[5, 9:] = 999.0, 999.0          # row 1: tokens 41..47
    clean = _port(q, kp, vp, pt, lengths).numpy()
    poisoned = _port(q, kp2, vp2, pt, lengths).numpy()
    np.testing.assert_allclose(poisoned, clean, atol=1e-6)
    np.testing.assert_allclose(
        poisoned, np.asarray(jax_kernel(q, kp2, vp2, pt, lengths)), atol=ATOL)


def test_zero_length_row_is_the_mean_of_v():
    """``length == 0`` masks every token; the reference then averages V
    over all ``n_pages * PS`` slots of the row's table."""
    q, kp, vp, pt, _ = _inputs(11, 3, 8, 4, 64, 12, 16, 4)
    lengths = np.array([0, 17, 64], np.int32)
    got = _port(q, kp, vp, pt, lengths).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kernel(q, kp, vp, pt,
                                                          lengths)),
                               atol=ATOL)
    mean_v = vp[pt[0]].reshape(-1, 4, 64).mean(axis=0)       # [Hkv, D]
    np.testing.assert_allclose(got[0], np.repeat(mean_v, 2, axis=0),
                               atol=ATOL)


@pytest.mark.parametrize("q_bf16", [False, True])
def test_bf16_pages(q_bf16):
    """bf16 pages (and q): the output has q's dtype; the port is within
    tolerance of the JAX kernel and oracle on the same bf16 values."""
    q, kp, vp, pt, lengths = _inputs(13, 2, 16, 4, 128, 20, 16, 5)
    lengths[0] = 0
    bf = ml_dtypes.bfloat16
    kp, vp = kp.astype(bf), vp.astype(bf)
    if q_bf16:
        q = q.astype(bf)
    tq, tk, tv = (torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
                  if x.dtype == bf else torch.from_numpy(x)
                  for x in (q, kp, vp))
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(pt),
                                     torch.from_numpy(lengths))
    assert got.dtype == (torch.bfloat16 if q_bf16 else torch.float32)
    for want in (jax_kernel(jnp.asarray(q), kp, vp, pt, lengths),
                 paged_decode_ref(jnp.asarray(q), kp, vp, pt, lengths)):
        if q_bf16:
            _bf16_close(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)


def test_page_ids_outside_the_pool():
    """Ids past either end of the pool read as JAX's gather reads them
    (negative from the end, then clamped): the port equals the JAX
    kernel and oracle on such a table."""
    q, kp, vp, _, _ = _inputs(19, 2, 4, 2, 32, 6, 16, 3)
    pt = np.array([[-1, 6, 40], [-6, -9, 2]], np.int32)
    lengths = np.array([48, 40], np.int32)
    got = _port(q, kp, vp, pt, lengths).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kernel(q, kp, vp, pt,
                                                          lengths)),
                               atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(paged_decode_ref(
        *map(jnp.asarray, (q, kp, vp, pt, lengths)))), atol=ATOL)
    clamped = np.array([[5, 5, 5], [0, 0, 2]], np.int32)
    np.testing.assert_array_equal(got, _port(q, kp, vp, clamped,
                                             lengths).numpy())


def test_decode_attention_takes_the_pool_pair():
    q, kp, vp, pt, lengths = _inputs(17, 2, 4, 4, 32, 8, 16, 3)
    got = ops.decode_attention(torch.from_numpy(q), (torch.from_numpy(kp),
                                                     torch.from_numpy(vp)),
                               torch.from_numpy(pt),
                               torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_decode(
        q, (kp, vp), pt, lengths)), atol=ATOL)
    np.testing.assert_array_equal(got, ops.paged_decode_attention_plain(
        *map(torch.from_numpy, (q, kp, vp, pt, lengths))).numpy())
