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


def _emulate_wgmma_route(q, k, v, *, causal=True, window=0, q_offset=0,
                         split=True, bn=128):
    """The numerics of the ``wgmma`` route (``csrc/flash_attention_sm90.cu``)
    in plain torch: scores from the unscaled bf16 operands (exact
    products, float32 sums), then one float32 multiply by scale·log2(e);
    a base-2 online softmax over ``bn``-key tiles with the -1e30 mask
    value; acc·alpha plus p·V with p as bf16 ``p_hi + p_lo`` (``split``)
    or as one bf16 value; acc / max(l, 1e-30) in bf16."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * \
        torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, h // hkv, sq, d)
    q_pos = q_offset + torch.arange(sq)[:, None]
    acc = torch.zeros(b, hkv, h // hkv, sq, d)
    m = torch.full((b, hkv, h // hkv, sq, 1), -1e30)
    l = torch.zeros_like(m)
    for k0 in range(0, skv, bn):
        kj = k[:, :, None, k0:k0 + bn].float()
        vj = v[:, :, None, k0:k0 + bn].float()
        x = (qf @ kj.transpose(-1, -2)) * scale_log2
        k_pos = k0 + torch.arange(kj.shape[3])[None, :]
        keep = torch.ones(sq, kj.shape[3], dtype=torch.bool)
        if causal:
            keep &= q_pos >= k_pos
        if window:
            keep &= k_pos > q_pos - window
        x = torch.where(keep, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vj
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vj
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def _cancelling_inputs(seed, h=2, sq=16, skv=256, d=32):
    """bf16 q, k, v whose outputs cancel toward zero: every query row of
    a head is the same row, so all share one softmax p (non-causal), and
    V's rows are +-2^c with signs chosen greedily, largest p first, to
    keep the running sum of p·v near 0. Each output is then far smaller
    than its terms, so a 2^-9 error in each p shows."""
    rng = np.random.default_rng(seed)
    q = np.repeat(rng.normal(size=(1, h, 1, d)) * 2, sq, axis=2)
    k = rng.normal(size=(1, h, skv, d))
    q, k = (torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (q, k))
    p = torch.softmax((q[0, :, 0].float() * d ** -0.5)[:, None]
                      @ k[0].float().transpose(-1, -2), -1)[:, 0]
    sign = torch.empty(h, skv)
    for g in range(h):
        run = 0.0
        for j in torch.argsort(p[g], descending=True).tolist():
            sign[g, j] = -1.0 if run > 0 else 1.0
            run += float(sign[g, j] * p[g, j])
    v = sign[None, :, :, None] * torch.exp2(torch.arange(d) % 3.0)
    return q, k, v.bfloat16()


def _within_bar(got, want):
    """decode_tolerance_err's bar: one bf16 ulp of the plain value, or
    2e-5 where that ulp is finer."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(
        min=2.0 ** -126))) - 7)
    return bool(((g - w).abs() <= torch.maximum(ulp, torch.tensor(ATOL))
                 ).all())


def test_wgmma_numerics_hold_the_bar_on_cancelling_outputs():
    """The ``wgmma`` route's design on the CPU: on outputs that cancel,
    the emulated kernel stays within the bar of the plain version with
    p = p_hi + p_lo, and a single bf16 p does not."""
    q, k, v = _cancelling_inputs(3)
    want = ops.flash_attention_plain(q, k, v, causal=False, tk=128)
    assert float(want.float().abs().max()) < 1e-3      # they do cancel
    split = _emulate_wgmma_route(q, k, v, causal=False)
    single = _emulate_wgmma_route(q, k, v, causal=False, split=False)
    err = [float((x.float() - want.float()).abs().max())
           for x in (split, single)]
    print(f"outputs up to {float(want.float().abs().max()):.2e}: p_hi + "
          f"p_lo {err[0]:.2e} from plain, one bf16 p {err[1]:.2e}")
    assert _within_bar(split, want)
    assert not _within_bar(single, want)


@pytest.mark.parametrize("causal,window,q_offset,skv", [
    (True, 0, 0, 256), (True, 64, 0, 256), (False, 0, 0, 320),
    (True, 0, 96, 224), (False, 8, 300, 128)])
def test_wgmma_numerics_match_plain(causal, window, q_offset, skv):
    """The emulated ``wgmma`` route on random bf16 inputs (GQA, masks,
    offsets, rows that keep no key) within the bar of the plain
    version."""
    q, k, v = map(_torch, _inputs(skv + window, 1, 4, 2, 128, 64, skv=skv,
                                  dtype="bfloat16"))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert _within_bar(_emulate_wgmma_route(q, k, v, **kw),
                       ops.flash_attention_plain(q, k, v, tk=skv, **kw))


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
