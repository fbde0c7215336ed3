"""Blocked causal / sliding-window flash attention: the kernel's wrapper
and its plain PyTorch version.

``q`` is ``[B, H, Sq, D]``; ``k`` and ``v`` are ``[B, Hkv, Skv, D]``;
query head ``h`` reads KV head ``h // (H / Hkv)`` (GQA-native: KV is
never expanded). q, k and v share one dtype, float32 or bfloat16;
softmax and accumulation are float32; the output has q's dtype and
shape. Only the last dimension must be contiguous: the kernel takes the
strides of the other three, so the model's ``[B, S, H, D]`` tensors go
in as transposed views without a copy, and the output keeps q's layout.

CUDA tensors go through the ``flash_attention`` kernel by one of two
routes, chosen by dtype and head dim alone (:func:`route`): ``wgmma``
(``csrc/flash_attention_sm90.cu``) for bfloat16 with ``D`` a multiple
of 16 up to 128, the model's case, on the tensor cores; ``cuda_cores``
(``csrc/flash_attention.cu``, the first version) for float32 and the
other head dims. Each launch counts once for the kernel and once for
its route (``kernels.route_counts("flash_attention")``). CPU tensors go
through :func:`flash_attention_plain`, a transcription of the Pallas
body (``repro.kernels.flash_attention.kernel._kernel``): an online
softmax over ``tk``-wide KV tiles, in order. ``tq`` and ``tk`` are the
reference's tile sizes: they set its divisibility rule (``Sq % tq ==
0``, ``Skv % tk == 0`` after ``min`` with the lengths) and the plain
version's KV tile width; the kernels use their own tiles (64 x 64, and
128 x 128 on the ``wgmma`` route), which changes the float32 summation
order only. The ``wgmma`` route reads q, k and v by TMA, which needs
16-byte aligned pointers and strides: it raises on others. ``q_offset``
is the absolute position of ``q[0]`` relative to ``k[0]`` (the
reference's ``blocked_attention`` argument; 0 in the Pallas kernel).

The backward: :func:`flash_attention_bwd` gives ``dq, dk, dv`` from q,
k, v, the forward's output and its gradient, through the
``flash_attention_bwd`` kernel for CUDA tensors (one launch sequence of
three kernels, counted once, and once for its route) and
:func:`flash_attention_bwd_plain` for CPU tensors. Its routes pair with
the forward's by the same :func:`route`: ``wgmma``
(``csrc/flash_attention_bwd_sm90.cu``, bf16 on the tensor cores, built
on the forward's saved row statistics) and ``cuda_cores``
(``csrc/flash_attention_bwd.cu``, which recomputes them).

Row statistics (``return_stats=True``, ``stats=``): float32 ``[2, B, H,
Sq]``, each row's ``m`` and ``l`` in the base-2 domain of the ``wgmma``
kernel's softmax: ``m`` the row's largest ``x = q·k·D^-½·log2(e)``
(``-1e30`` where the mask keeps no key, the masked score's value in that
domain), ``l`` the sum of ``2^(x - m)`` (a masked key counts ``x =
-1e30``), so ``P = 2^(x - m) / max(l, 1e-30)``. They stay two numbers,
not one log-sum-exp: ``-1e30 + log2(l)`` rounds back to ``-1e30``, which
would give a row that keeps no key ``P = 1`` in place of ``1 / Skv``.
The ``wgmma`` forward writes them in the same launch (the output is the
same bits with or without), the plain forward derives them from its own
``m`` and ``l``; the ``cuda_cores`` forward has none (None).
:class:`FlashAttention` is the ``torch.autograd.Function`` that joins
the two directions: it asks for the statistics only when an input needs
a gradient and hands them to the backward. :func:`attention`, which the
model calls, goes through it on both devices. The JAX package has no
backward kernel: it differentiates its jnp scan.

Tensors on the ``meta`` device (the dry-run's shapes without data,
:mod:`repro_torch.launch.dryrun`) take neither: both wrappers return
empty outputs (and statistics) of the right shapes and dtypes from the
custom ops ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd``, which have no kernel for any
other device and register the kernels' FLOPs with
``torch.utils.flop_counter`` (:func:`attention_flops`): 4 per kept (row,
key) pair and head dim forward, 10 backward (its five products). Any
other device raises in the launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
DEFAULT_TQ = 128
DEFAULT_TK = 128
MAX_HEAD_DIM = 128     # the kernels' zero-padded row width
_DTYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, d: int) -> str:
    """The CUDA route for operands of ``dtype`` and head dim ``d``."""
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= MAX_HEAD_DIM:
        return "wgmma"
    return "cuda_cores"


def route_counts() -> dict[str, int]:
    """Launches of each route since ``kernels.reset_launch_counts()``."""
    return kernels.route_counts("flash_attention")


def _check(q, k, v, tq, tk, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d [B, H, S, D]")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        "one of float32 or bfloat16")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset {q_offset} and window {window} must "
                         "not be negative")
    tq, tk = min(tq, sq), min(tk, skv)
    if tq <= 0 or tk <= 0 or sq % tq or skv % tk:
        raise ValueError(f"Sq {sq} % tq {tq} and Skv {skv} % tk {tk} must "
                         "be 0")
    return tq, tk


def _tma_ok(t) -> bool:
    """TMA reads ``t``: a 16-byte aligned pointer and strides that are
    multiples of 8 elements (16 bytes), but where the extent is 1."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _check_tma(**tensors):
    for name, t in tensors.items():
        if not _tma_ok(t):
            raise ValueError(f"{name}: TMA needs a 16-byte aligned pointer "
                             f"and strides (strides {t.stride()})")


def _launch_wgmma(q, k, v, out, stats, causal, window, q_offset):
    """One launch of the ``wgmma`` forward into ``out`` (and ``stats``,
    when not None)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    kernels.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(),
                   None if stats is None else stats.data_ptr(), b, h, hkv,
                   sq, skv, d, *strides, int(causal), int(window),
                   int(q_offset), d ** -0.5, route="wgmma")


def kept_pairs(sq: int, skv: int, *, causal: bool, window: int,
               q_offset: int) -> int:
    """How many (query row, key) pairs of one head the mask keeps
    (:func:`_mask`'s count, without building it)."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    hi = np.minimum(p, skv - 1) if causal else np.full_like(p, skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(q_shape, k_shape, *, causal: bool, window: int,
                    q_offset: int, products: int) -> int:
    """FLOPs of ``products`` Sq x Skv x D products a head over the pairs
    the mask keeps (the kernels skip tiles the mask drops): 2 for the
    forward (``q·kᵀ`` and ``p·V``), 5 for the backward."""
    b, h, sq, d = q_shape
    return 2 * products * b * h * d * kept_pairs(
        sq, k_shape[2], causal=causal, window=window, q_offset=q_offset)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _meta_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, q_offset: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention runs on meta tensors "
                       "only: use flash_attention()")


@_meta_forward.register_fake
def _(q, k, v, causal, window, q_offset):
    b, h, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((2, b, h, sq),
                                            dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _forward_flops(q, k, v, causal, window, q_offset, *, out_shape=None,
                   **kwargs) -> int:
    return attention_flops(q, k, causal=causal, window=window,
                           q_offset=q_offset, products=2)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _meta_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, dout: torch.Tensor, causal: bool,
                   window: int, q_offset: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention_bwd runs on meta "
                       "tensors only: use flash_attention_bwd()")


@_meta_backward.register_fake
def _(q, k, v, out, dout, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flops(q, k, v, out, dout, causal, window, q_offset, *,
                    out_shape=None, **kwargs) -> int:
    return attention_flops(q, k, causal=causal, window=window,
                           q_offset=q_offset, products=5)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    tq: int = DEFAULT_TQ, tk: int = DEFAULT_TK,
                    q_offset: int = 0, return_stats: bool = False):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D]. Returns [B, H, Sq, D];
    with ``return_stats``, ``(out, stats)``: the rows' ``[2, B, H, Sq]``
    statistics (the module docstring), None on the ``cuda_cores``
    route."""
    tq, tk = _check(q, k, v, tq, tk, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     tk=tk, q_offset=q_offset,
                                     return_stats=return_stats)
    if q.device.type == "meta":
        out, stats = torch.ops.repro_torch.flash_attention(
            q, k, v, causal, window, q_offset)
        if route(q.dtype, q.shape[3]) != "wgmma":
            stats = None
        return (out, stats) if return_stats else out
    dev = q.device
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.device != dev or v.device != dev:
        raise ValueError(f"q on {dev}, k on {k.device}, v on {v.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    out = torch.empty_like(q)       # q's layout: a BSHD view stays BSHD
    wgmma = route(q.dtype, d) == "wgmma"
    stats = None
    if return_stats and wgmma:
        stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=dev)
    if not (b and h and sq and d):
        return (out, stats) if return_stats else out
    if wgmma:
        _check_tma(q=q, k=k, v=v)
        _launch_wgmma(q, k, v, out, stats, causal, window, q_offset)
    else:
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        kernels.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, h, hkv, sq, skv, d,
                       *strides, int(causal), int(window), int(q_offset),
                       d ** -0.5, int(q.dtype == torch.bfloat16),
                       route="cuda_cores")
    return (out, stats) if return_stats else out


def _mask(sq: int, skv: int, *, causal: bool, window: int, q_offset: int,
          device=None):
    """``[Sq, Skv]`` bool: the scores the forward keeps (absolute
    positions ``q_offset + i`` against ``j``)."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          tk: int = DEFAULT_TK, q_offset: int = 0,
                          return_stats: bool = False):
    """The Pallas body over all query rows at once (a row's result does
    not depend on the query tiling): q scaled by ``D**-0.5`` in float32
    before the product, float32 scores masked to -1e30 at absolute
    positions, then the running ``(m, l, acc)`` over ``tk``-wide KV
    tiles in order; output ``acc / max(l, 1e-30)`` in q's dtype. With
    ``return_stats``, ``(out, stats)``: the final ``m`` and ``l`` in the
    base-2 domain (``m·log2(e)``, and -1e30 where it is -1e30; ``l`` is
    the same sum in either domain)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    tk = min(tk, skv)
    g = h // hkv
    qf = (q.float() * (d ** -0.5)).reshape(b, hkv, g, sq, d)
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    acc = torch.zeros(b, hkv, g, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, skv, tk):
        kj = k[:, :, None, k0:k0 + tk].float()             # [B, Hkv, 1, tk, D]
        vj = v[:, :, None, k0:k0 + tk].float()
        s = qf @ kj.transpose(-1, -2)                      # [B, Hkv, G, Sq, tk]
        s = torch.where(mask[:, k0:k0 + tk], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).reshape(b, h, sq, d).to(q.dtype)
    if not return_stats:
        return out
    m2 = torch.where(m == NEG_INF, NEG_INF, m * LOG2E)
    return out, torch.stack([m2, l]).reshape(2, b, h, sq)


def _check_bwd(q, out, dout):
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out {out.dtype} / dout {dout.dtype}: expected "
                        f"q's dtype {q.dtype}")


def _check_stats(stats, q):
    b, h, sq, _ = q.shape
    if stats.shape != (2, b, h, sq) or stats.dtype != torch.float32:
        raise ValueError(f"stats {stats.dtype}{tuple(stats.shape)}: "
                         f"expected float32 {(2, b, h, sq)}")
    if stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats: contiguous on {q.device} expected")


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0, stats=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`'s output
    ``out`` under the upstream gradient ``dout`` ([B, H, Sq, D], q's
    dtype), in the layouts and dtypes of q, k and v; each KV head's dk
    and dv sum over its query heads. ``stats``: the forward's row
    statistics (``return_stats``); without them the ``wgmma`` route gets
    them from one launch of the ``wgmma`` forward (counted as such), the
    ``cuda_cores`` route recomputes them in its own first pass (and
    ignores any given), the plain version recomputes the softmax. CUDA
    tensors launch the kernel by :func:`route` (no fallback); CPU tensors
    take :func:`flash_attention_bwd_plain`; ``meta`` tensors get empty
    gradients and the kernel's FLOPs (the module docstring)."""
    _check(q, k, v, q.shape[2], k.shape[2], window, q_offset)
    _check_bwd(q, out, dout)
    if stats is not None:
        _check_stats(stats, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                         window=window, q_offset=q_offset,
                                         stats=stats)
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, dout, causal, window, q_offset)
    dev = q.device
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.device != dev:
            raise ValueError(f"q on {dev}, {name} on {t.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    wgmma = route(q.dtype, d) == "wgmma"
    if dout.stride(-1) != 1 or (wgmma and not _tma_ok(dout)):
        dout = dout.contiguous()    # the upstream gradient, copied once
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (ctypes.addressof(strides), int(causal), int(window),
            int(q_offset), d ** -0.5)
    if wgmma:
        _check_tma(q=q, k=k, v=v, out=out)
        if stats is None:
            stats = torch.empty((2, b, h, sq), dtype=torch.float32,
                                device=dev)
            _launch_wgmma(q, k, v, torch.empty_like(q), stats, causal,
                          window, q_offset)
        n_rt = 2 * -(-sq // 128)     # 64-row records a head, whole 128s
        rec = torch.empty(b * h * n_rt * 192, dtype=torch.float32,
                          device=dev)
        kernels.launch("flash_attention_bwd", *head, stats.data_ptr(),
                       rec.data_ptr(), b, h, hkv, sq, skv, d, *tail,
                       route="wgmma")
    else:
        m, l, delta = torch.empty((3, b, h, sq), dtype=torch.float32,
                                  device=dev)
        kernels.launch("flash_attention_bwd", *head, m.data_ptr(),
                       l.data_ptr(), delta.data_ptr(), b, h, hkv, sq, skv, d,
                       *tail, int(q.dtype == torch.bfloat16),
                       route="cuda_cores")
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              stats=None):
    """The backward in plain PyTorch, float32 math, by the standard
    recompute: ``P = softmax(mask(q·kᵀ·D^-½))`` (masked scores -1e30, as
    the forward), ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P∘(dP −
    rowsum(dO∘O))`` where the mask keeps the score and 0 where it drops
    it (a constant score has no gradient), ``dQ = dS·K·D^-½``, ``dK =
    dSᵀ·q·D^-½``; GQA's dk and dv summed over each KV head's query
    heads. Given the forward's ``stats``, ``P = 2^(x - m) / max(l,
    1e-30)`` from them (``x`` the masked scores times log2(e), -1e30
    where masked) instead of the softmax. Outputs in the dtypes and
    layouts of q, k and v."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = (q.float() * (d ** -0.5)).reshape(b, hkv, g, sq, d)
    kf = k.float()[:, :, None]                         # [B, Hkv, 1, Skv, D]
    vf = v.float()[:, :, None]
    do = dout.float().reshape(b, hkv, g, sq, d)
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    s = qf @ kf.transpose(-1, -2)                      # [B, Hkv, G, Sq, Skv]
    if stats is None:
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    else:
        m, l = stats.reshape(2, b, hkv, g, sq, 1)
        p = torch.exp2(torch.where(mask, s * LOG2E, NEG_INF) - m) \
            / torch.clamp(l, min=1e-30)
    delta = (do * out.float().reshape(b, hkv, g, sq, d)).sum(-1,
                                                             keepdim=True)
    ds = torch.where(mask, p * (do @ vf.transpose(-1, -2) - delta), 0.0)
    dq = (ds @ kf) * (d ** -0.5)
    dk = (ds.transpose(-1, -2) @ qf).sum(2)
    dv = (p.transpose(-1, -2) @ do).sum(2)
    grads = (dq.reshape(b, h, sq, d), dk, dv)
    res = []
    for t, grad in zip((q, k, v), grads):
        o = torch.empty_like(t)
        o.copy_(grad)
        res.append(o)
    return tuple(res)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its backward: saves q, k, v, the
    output and, when an input needs a gradient, the forward's row
    statistics; the backward is :func:`flash_attention_bwd` on them (the
    kernel for CUDA tensors, the plain version for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, tq, tk, q_offset):
        grads = any(ctx.needs_input_grad[:3])
        res = flash_attention(q, k, v, causal=causal, window=window, tq=tq,
                              tk=tk, q_offset=q_offset, return_stats=grads)
        out, stats = res if grads else (res, None)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.flags = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        causal, window, q_offset = ctx.flags
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                         window=window, q_offset=q_offset,
                                         stats=stats)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              tq: int = DEFAULT_TQ, tk: int = DEFAULT_TK, q_offset: int = 0):
    """Model layout: q [B, Sq, H, D]; k, v [B, Skv, Hkv, D] (un-expanded
    GQA) -> [B, Sq, H, D], through :class:`FlashAttention` (so a
    backward runs ``flash_attention_bwd``). The transposes are views:
    the kernels read the strides, and the output comes back in q's
    layout."""
    out = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, window, tq, tk,
                               q_offset)
    return out.transpose(1, 2)
