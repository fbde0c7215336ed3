"""Port parity: blocked flash attention vs ``repro.kernels.flash_attention``.

The port's plain version (the path of CPU tensors) against the JAX
Pallas kernel, run in interpret mode as ``tests/test_kernels.py`` runs
it, and against the JAX oracle ``attention_ref``, on the same numpy
inputs: the three shapes of ``test_kernels.py`` in float32 and bf16, its
sliding-window and non-causal GQA cases, and a non-causal case with Sq
!= Skv. Tolerance: float32 within ``atol=2e-5`` (the JAX test's own);
bf16 within one bf16 ulp of the interpret kernel's value, or 2e-5 where
that ulp is finer, and within 2e-2 of ``attention_ref`` (the JAX test's
bf16 tolerance: the oracle normalises before its second product). Also
the port's ``blocked_attention`` (GQA-native) against the JAX one (KV
expanded), the BSHD helper ``attention``, and the wrapper's checks
(the reference's divisibility rule, dtypes, head grouping, rank, a
negative window).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_kernel
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import _expand_kv as jax_expand
from repro.models.attention import blocked_attention as jax_blocked

from repro_torch.kernels.flash_attention import ops
from repro_torch.models.attention import _expand_kv, blocked_attention

ATOL = 2e-5


def _inputs(seed, b, h, hkv, sq, d, skv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    arrays = (rng.normal(size=(b, h, sq, d)), rng.normal(size=(b, hkv, skv, d)),
              rng.normal(size=(b, hkv, skv, d)))
    if dtype == np.float32:
        return tuple(a.astype(np.float32) for a in arrays)
    # bf16: round once in JAX; both packages read the same bf16 values
    return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays)


def _torch(a):
    if a.dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(a))
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bf16_close(got, want):
    """Within one bf16 ulp of ``want`` (or ATOL where that is finer)."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= np.maximum(ulp, ATOL))


def _check(args, got, **kw):
    want_k = jax_kernel(*map(jnp.asarray, args), tq=64, tk=64, **kw)
    want_r = attention_ref(*map(jnp.asarray, args), **kw)
    if args[0].dtype == np.float32:
        np.testing.assert_allclose(_f32(got), _f32(want_k), atol=ATOL)
        np.testing.assert_allclose(_f32(got), _f32(want_r), atol=ATOL)
    else:
        assert got.dtype == torch.bfloat16
        _bf16_close(got, want_k)
        np.testing.assert_allclose(_f32(got), _f32(want_r), atol=2e-2)


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 2, 1, 128, 32), (2, 4, 2, 256, 64), (1, 8, 8, 128, 128)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_causal_matches_jax(b, h, hkv, s, d, dtype):
    args = _inputs(b * h + s, b, h, hkv, s, d, dtype=dtype)
    got = ops.flash_attention(*map(_torch, args), causal=True, tq=64, tk=64)
    assert got.shape == (b, h, s, d)
    _check(args, got, causal=True)


def test_sliding_window_matches_jax():
    args = _inputs(0, 1, 2, 2, 256, 64)
    got = ops.flash_attention(*map(_torch, args), causal=True, window=64,
                              tq=64, tk=64)
    _check(args, got, causal=True, window=64)


@pytest.mark.parametrize("sq,skv", [(128, 128), (64, 192)])
def test_non_causal_gqa_matches_jax(sq, skv):
    args = _inputs(1 + skv, 1, 2, 1, sq, 64, skv=skv)
    got = ops.flash_attention(*map(_torch, args), causal=False, tq=64, tk=64)
    _check(args, got, causal=False)


@pytest.mark.parametrize("window,chunk", [(0, 64), (0, 256), (32, 64)])
def test_blocked_attention_matches_jax(window, chunk):
    """The model's prefill attention: port (GQA-native, plain version
    with ``chunk``-wide tiles) vs the JAX scan (KV expanded), bf16 model
    layout [B, S, H, D]."""
    rng = np.random.default_rng(window + chunk)
    q, k, v = (np.asarray(jnp.asarray(rng.normal(size=(2, 256, hh, 16)),
                                      jnp.bfloat16))
               for hh in (4, 2, 2))
    want = jax_blocked(jnp.asarray(q), jax_expand(jnp.asarray(k), 2),
                       jax_expand(jnp.asarray(v), 2), causal=True,
                       window=window, chunk=chunk)
    got = blocked_attention(_torch(q), _torch(k), _torch(v), causal=True,
                            window=window, chunk=chunk)
    assert got.shape == (2, 256, 4, 16) and got.dtype == torch.bfloat16
    _bf16_close(got, want)
    expanded = blocked_attention(_torch(q), _expand_kv(_torch(k), 2),
                                 _expand_kv(_torch(v), 2), causal=True,
                                 window=window, chunk=chunk)
    assert torch.equal(expanded, got)


def test_blocked_attention_keeps_the_reference_shape_rule():
    q = torch.zeros(1, 96, 2, 16)
    k = torch.zeros(1, 96, 2, 16)
    with pytest.raises(AssertionError):
        blocked_attention(q, k, k, causal=True, chunk=64)   # 96 % 64
    assert blocked_attention(q, k, k, causal=True, chunk=1024).shape == \
        q.shape


def test_bshd_helper_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 128, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, 128, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         tq=64, tk=64)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), tq=64, tk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("case", ["ragged_sq", "ragged_skv", "dtype_mix",
                                  "groups", "rank", "window"])
def test_wrapper_rejects_bad_operands(case):
    q = torch.zeros(1, 4, 128, 32)
    k = torch.zeros(1, 2, 128, 32)
    kw = dict(tq=64, tk=64)
    if case == "ragged_sq":
        q = torch.zeros(1, 4, 96, 32)
    elif case == "ragged_skv":
        k = torch.zeros(1, 2, 96, 32)
    elif case == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif case == "groups":
        k = torch.zeros(1, 3, 128, 32)
    elif case == "window":
        kw["window"] = -1
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, k, **kw)
